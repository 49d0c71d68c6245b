"""Host ms an image in the program's span ``refid.events.voxel_norm``: the
voxel grid's normalisation on the host (``voxel_norm_np``)."""

from portbench.spans import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "refid.events.voxel_norm")
