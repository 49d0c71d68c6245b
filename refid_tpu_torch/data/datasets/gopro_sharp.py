"""GoPro sharp-VFI datasets (mirrors
``refid_tpu/data/datasets/gopro_sharp.py``; upstream
``basicsr/data/image_sharp_npy_dataset.py``)."""

import numpy as np

from refid_tpu_torch.core.registry import DATASETS
from refid_tpu_torch.data.datasets.base import RecurrentEventDataset

__all__ = ["GoProSharpEventRecurrentDataset", "GoProSharpwithVoxelEventRecurrentDataset"]


@DATASETS.register("GoProSharpEventRecurrentDataset")
class GoProSharpEventRecurrentDataset(RecurrentEventDataset):
    """2 sharp end frames + events -> n middle frames.  With
    ``return_deblur_voxel`` the packed input pads ZERO deblur bins, so the
    26-channel blur-VFI checkpoints take sharp inputs."""
    layout = "gopro"
    kind = "sharp"
    bidir = False


@DATASETS.register("GoProSharpwithVoxelEventRecurrentDataset")
class GoProSharpwithVoxelEventRecurrentDataset(RecurrentEventDataset):
    """Sharp VFI with voxels in the packed input: each end bin of the n+1
    bin stream repeated 10 times where the blur-VFI input holds the
    intra-exposure bins."""
    layout = "gopro"
    kind = "sharp"
    bidir = False

    def _pack_deblur_voxel(self, img_lqs, voxel_hwc):
        left = np.repeat(voxel_hwc[..., :1], 10, axis=-1)
        right = np.repeat(voxel_hwc[..., -1:], 10, axis=-1)
        return np.concatenate([img_lqs[0], left, img_lqs[1], right],
                              axis=-1).astype(np.float32)
