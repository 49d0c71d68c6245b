"""The share of the VFI network calls (the program's spans
``refid.vfi.network``) that ran in channels_last, that is that hold a span
``refid.vfi.channels_last``, in %.  None where the trace holds no network
span; 0 where every call ran NCHW (the int8 path)."""

from portbench.spans import program_spans

NETWORK, CHANNELS_LAST = "refid.vfi.network", "refid.vfi.channels_last"


def read(run):
    if run.trace is None or run.trace.calls == 0:
        return None
    spans = program_spans(run.trace)
    calls = [(a, b) for n, a, b in spans if n == NETWORK]
    inner = [(a, b) for n, a, b in spans if n == CHANNELS_LAST]
    if not calls:
        return None
    held = sum(any(a <= c and d <= b for c, d in inner) for a, b in calls)
    return 100.0 * held / len(calls)
