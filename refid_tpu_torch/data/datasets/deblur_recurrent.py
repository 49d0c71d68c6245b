"""Deblur-only recurrent datasets: one blurred frame -> m sharp frames
(mirrors ``refid_tpu/data/datasets/deblur_recurrent.py``; upstream
``basicsr/data/Deblur_image_npy_dataset.py``), on ``base.py``'s ``deblur1``
kind: m + 1 bins, m gts."""

from refid_tpu_torch.core.registry import DATASETS
from refid_tpu_torch.data.datasets.base import RecurrentEventDataset

__all__ = ["DeblurGoProEventRecurrentDataset", "DeblurUNDEventRecurrentDataset",
           "DeblurGoProBidirEventRecurrentDataset"]


@DATASETS.register("DeblurGoProEventRecurrentDataset")
class DeblurGoProEventRecurrentDataset(RecurrentEventDataset):
    """GoPro layout."""
    layout = "gopro"
    kind = "deblur1"
    bidir = False


@DATASETS.register("DeblurUNDEventRecurrentDataset")
class DeblurUNDEventRecurrentDataset(RecurrentEventDataset):
    """HighREV / UND layout (events under the video, x and y swapped)."""
    layout = "highrev"
    kind = "deblur1"
    bidir = False


@DATASETS.register("DeblurGoProBidirEventRecurrentDataset")
class DeblurGoProBidirEventRecurrentDataset(RecurrentEventDataset):
    """GoPro layout, with the time-reversed stream's voxel pairs appended."""
    layout = "gopro"
    kind = "deblur1"
    bidir = True
