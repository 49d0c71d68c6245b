"""Host ms an image in the demo's voxel stage (the upload, the card's
voxelizer K2, the copy back, ``voxel_norm_np``), timed around the
driver's call; the median over the measured window's images."""

from portbench.readers import host_median_ms


def read(run):
    return host_median_ms(run, "voxel_ms")
