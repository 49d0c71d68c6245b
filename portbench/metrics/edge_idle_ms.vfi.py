"""Device idle ms a window while the host is inside the program's request
span ``refid.vfi.request`` but outside its network span
``refid.vfi.network``: the request's edges (padding the events, K1,
packing the input, returning)."""

from portbench.spans import idle_ms_per_call


def read(run):
    return idle_ms_per_call(run, "refid.vfi.request", outside="refid.vfi.network")
