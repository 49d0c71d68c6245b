"""Device idle ms a window while the host is inside the program's network
span ``refid.vfi.network`` (the int8 sites' spans within it included)."""

from portbench.spans import idle_ms_per_call


def read(run):
    return idle_ms_per_call(run, "refid.vfi.network")
