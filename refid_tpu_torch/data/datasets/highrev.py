"""HighREV / UND ("Ruisi") datasets (mirrors
``refid_tpu/data/datasets/highrev.py``): videos listed from the directory,
events under ``<split>/<video>/event/``, and the x/y field swap that
corrects the dataset's export (``base.py``'s ``highrev`` layout)."""

from refid_tpu_torch.core.registry import DATASETS
from refid_tpu_torch.data.datasets.base import RecurrentEventDataset

__all__ = ["RuisiEventRecurrentDataset", "RuisiSharpEventRecurrentDataset"]


@DATASETS.register("RuisiEventRecurrentDataset")
class RuisiEventRecurrentDataset(RecurrentEventDataset):
    """HighREV blur VFI (upstream ``image_npy_Ruisi_dataset.py``)."""
    layout = "highrev"
    kind = "blur"
    bidir = False


@DATASETS.register("RuisiSharpEventRecurrentDataset")
class RuisiSharpEventRecurrentDataset(RecurrentEventDataset):
    """HighREV sharp VFI (upstream ``image_sharp_Ruisi_dataset.py``)."""
    layout = "highrev"
    kind = "sharp"
    bidir = False
