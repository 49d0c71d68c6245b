"""The share of Restormer's pre-norms (the program's spans
``refid.restormer.norm``) that ran on the hand-written kernel, that is that
hold a span ``refid.restormer.norm_card``, in %.  None where the trace
holds no pre-norm span (a program that opens none); 0 where every pre-norm
ran PyTorch's ops."""

from portbench.spans import program_spans

NORM, CARD = "refid.restormer.norm", "refid.restormer.norm_card"


def read(run):
    if run.trace is None or run.trace.calls == 0:
        return None
    spans = program_spans(run.trace)
    norms = [(a, b) for n, a, b in spans if n == NORM]
    cards = [(a, b) for n, a, b in spans if n == CARD]
    if not norms:
        return None
    cards.sort()
    held, j = 0, 0
    for a, b in sorted(norms):
        while j < len(cards) and cards[j][0] < a:
            j += 1
        held += j < len(cards) and cards[j][1] <= b
    return 100.0 * held / len(norms)
