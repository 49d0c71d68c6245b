"""The share of the demo's normalisations (the program's spans
``refid.events.voxel_norm``) that ran on the card, that is that hold a span
``refid.events.voxel_norm_card``, in %.  None where the trace holds no
normalisation span; 0 where every normalisation ran on the host."""

from portbench.spans import program_spans

NORM, CARD = "refid.events.voxel_norm", "refid.events.voxel_norm_card"


def read(run):
    if run.trace is None or run.trace.calls == 0:
        return None
    spans = program_spans(run.trace)
    norms = [(a, b) for n, a, b in spans if n == NORM]
    cards = [(a, b) for n, a, b in spans if n == CARD]
    if not norms:
        return None
    held = sum(any(a <= c and d <= b for c, d in cards) for a, b in norms)
    return 100.0 * held / len(norms)
