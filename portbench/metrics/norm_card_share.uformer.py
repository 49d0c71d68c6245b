"""The share of Uformer's pre-norms (the program's spans
``refid.uformer.norm``) that ran on the hand-written pre-norm kernel, that
is that hold a span ``refid.uformer.norm_card``, in %.  None where the
trace holds no pre-norm span (a program that opens none); 0 where every
pre-norm ran PyTorch's ops."""

from portbench.spans import program_spans

NORM, CARD = "refid.uformer.norm", "refid.uformer.norm_card"


def read(run):
    if run.trace is None or run.trace.calls == 0:
        return None
    spans = program_spans(run.trace)
    norms = sorted((a, b) for n, a, b in spans if n == NORM)
    cards = sorted((a, b) for n, a, b in spans if n == CARD)
    if not norms:
        return None
    held, j = 0, 0
    for a, b in norms:
        while j < len(cards) and cards[j][0] < a:
            j += 1
        held += j < len(cards) and cards[j][1] <= b
    return 100.0 * held / len(norms)
