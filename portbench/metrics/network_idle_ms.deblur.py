"""Device idle ms an image while the host is inside the program's network
span ``refid.task.network``."""

from portbench.spans import idle_ms_per_call


def read(run):
    return idle_ms_per_call(run, "refid.task.network")
