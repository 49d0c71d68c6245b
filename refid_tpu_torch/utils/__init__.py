"""Host-side utilities inherited from BasicSR (mirrors ``refid_tpu/utils``):
optical-flow IO (``flow_util``), face alignment and paste-back
(``face_util``, dlib-gated) and Google-drive downloads
(``download_util``).  No REFID path uses them."""

from refid_tpu_torch.utils.flow_util import (
    dequantize_flow, flowread, flowwrite, quantize_flow,
)

__all__ = ["flowread", "flowwrite", "quantize_flow", "dequantize_flow"]
