"""Device idle ms an image while the host is inside the program's LeWin
block spans ``refid.uformer.block``."""

from portbench.spans import idle_ms_per_call


def read(run):
    return idle_ms_per_call(run, "refid.uformer.block")
