from refid_tpu_torch.events.voxel import (
    event_reverse,
    events_to_voxel_grid,
    events_to_voxel_grid_padded,
    events_to_voxel_grid_reference,
    filter_event,
    voxel_norm,
    voxel_norm_np,
    voxelize_padded,
    voxelize_padded_reference,
)

__all__ = ["event_reverse", "events_to_voxel_grid", "events_to_voxel_grid_padded",
           "events_to_voxel_grid_reference", "filter_event", "voxel_norm",
           "voxel_norm_np", "voxelize_padded", "voxelize_padded_reference"]
