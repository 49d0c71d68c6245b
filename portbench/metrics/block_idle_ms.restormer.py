"""Device idle ms an image while the host is inside the program's
transformer-block spans ``refid.restormer.block``."""

from portbench.spans import idle_ms_per_call


def read(run):
    return idle_ms_per_call(run, "refid.restormer.block")
