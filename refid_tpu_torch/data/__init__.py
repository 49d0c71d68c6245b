"""Data path of the port: image IO, aligned transforms, the recurrent event
datasets and the threaded loader.  Importing it registers the datasets."""

from refid_tpu_torch.data.datasets import gopro_recurrent, gopro_sharp, highrev  # noqa: F401
from refid_tpu_torch.data.loader import build_dataset, build_loader

__all__ = ["build_dataset", "build_loader"]
