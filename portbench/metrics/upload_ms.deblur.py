"""Host ms an image in the program's span ``refid.task.upload``: the photo
and the voxel grid from host arrays to the card in NCHW."""

from portbench.spans import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "refid.task.upload")
