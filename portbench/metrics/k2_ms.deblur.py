"""Host ms an image in the program's span ``refid.events.k2``: the events'
upload, the card's voxelizer K2, the copy back and the wait for it."""

from portbench.spans import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "refid.events.k2")
