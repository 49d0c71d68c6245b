"""GoPro blur-VFI datasets (mirrors
``refid_tpu/data/datasets/gopro_recurrent.py``)."""

from refid_tpu_torch.core.registry import DATASETS
from refid_tpu_torch.data.datasets.base import RecurrentEventDataset

__all__ = ["GoProEventRecurrentDataset", "GoProBidirEventRecurrentDataset"]


@DATASETS.register("GoProEventRecurrentDataset")
class GoProEventRecurrentDataset(RecurrentEventDataset):
    """2 blurred frames + events -> 2m+n sharp frames."""
    layout = "gopro"
    kind = "blur"
    bidir = False


@DATASETS.register("GoProBidirEventRecurrentDataset")
class GoProBidirEventRecurrentDataset(RecurrentEventDataset):
    """Blur-VFI with an extra time-reversed voxel stream concatenated on the
    t axis."""
    layout = "gopro"
    kind = "blur"
    bidir = True
