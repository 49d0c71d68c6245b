"""The share of the VFI network's biased convs (the program's spans
``refid.conv`` inside ``refid.vfi.network``) that the hand-written epilogue
finished, that is that hold a span ``refid.conv.epilogue``, in %.  None
where the trace holds no network span or no conv span inside one (a program
whose conv layer opens no span)."""

from bisect import bisect_right

from portbench.spans import program_spans

NETWORK, CONV, EPILOGUE = "refid.vfi.network", "refid.conv", "refid.conv.epilogue"


def _holder(spans, starts, a, b):
    """The index of the span of ``spans`` (disjoint, sorted by start; their
    starts ``starts``) that holds ``[a, b]``, or None."""
    i = bisect_right(starts, a) - 1
    return i if i >= 0 and spans[i][1] >= b else None


def read(run):
    if run.trace is None or run.trace.calls == 0:
        return None
    spans = program_spans(run.trace)
    calls = sorted((a, b) for n, a, b in spans if n == NETWORK)
    call_starts = [a for a, _ in calls]
    convs = sorted((a, b) for n, a, b in spans
                   if n == CONV and _holder(calls, call_starts, a, b) is not None)
    if not convs:
        return None
    starts = [a for a, _ in convs]
    held = {_holder(convs, starts, a, b) for n, a, b in spans if n == EPILOGUE}
    held.discard(None)
    return 100.0 * len(held) / len(convs)
