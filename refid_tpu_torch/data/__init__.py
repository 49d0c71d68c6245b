"""Data path of the port: image IO, aligned transforms, the recurrent event
datasets and the threaded loader.  Importing it registers the datasets."""

from refid_tpu_torch.data.datasets import (  # noqa: F401
    gopro_recurrent, gopro_sharp, highrev, single_image,
)
from refid_tpu_torch.data.loader import build_dataset, build_loader

__all__ = ["build_dataset", "build_loader"]
