"""refid_tpu_torch — the PyTorch / CUDA (Hopper) port of ``refid_tpu``.

Blurry-VFI serving (raw events + two blurred frames -> 2m+n sharp frames)
and training (``python -m refid_tpu_torch.cli.train -opt <yml>``), with the
network in PyTorch (NCHW inside, upstream REFID's state_dict names) and the
event voxelizers as hand-written CUDA kernels (``csrc/voxelize.cu``).  The
JAX package ``refid_tpu`` is the reference this port is held against;
nothing here imports it.

Importing the package needs neither CUDA nor ``nvcc``: the kernel library
is compiled and loaded on the first call that hands it CUDA work.
"""

from refid_tpu_torch.models.refid import FinalBidirectionAttenfusion, RefidConfig
from refid_tpu_torch.pipeline import BlurVFIPipeline, SharpVFIPipeline

__version__ = "0.1.0"

__all__ = [
    "BlurVFIPipeline",
    "FinalBidirectionAttenfusion",
    "RefidConfig",
    "SharpVFIPipeline",
]
