from refid_tpu_torch.events.voxel import (
    voxel_norm,
    voxelize_padded,
    voxelize_padded_reference,
)

__all__ = ["voxel_norm", "voxelize_padded", "voxelize_padded_reference"]
