"""W-MSA's attention core's share of its roofline: the sum over the LeWin
blocks of each block's least time (``2 * 2 T n C`` FLOPs of ``q k^T`` and
``A v`` at the bf16 peak, or its bytes at the HBM rate, whichever is
longer; the bytes are q, k, v read and the output written, ``4 T C`` bf16
elements, plus the additive bias once as it lies in memory: ``(nW, heads,
n, n)`` bf16 in a shifted block, ``(1, heads, n, n)`` in another), over the
device time of the attention kernels (the names in
``wmsa_core_kernels.txt``) an image, in %."""

from pathlib import Path

from portbench.flops.uformer import lewin_blocks
from portbench.readers import device_ms_per_call, names_matcher

CORE = names_matcher(Path(__file__).with_name("wmsa_core_kernels.txt"))
BF16_BYTES = 2


def least_seconds(net: dict, height: int, width: int, peaks: dict) -> float:
    """The attention core's least time an image, summed over the blocks."""
    n = net["win_size"] ** 2
    total = 0.0
    for t, c, heads, shifted in lewin_blocks(height, width, net["embed_dim"], net["depths"],
                                             net["num_heads"], net["win_size"]):
        bias = (t // n if shifted else 1) * heads * n * n
        total += max(2 * 2 * t * n * c / peaks["bf16_flop_per_s"],
                     (4 * t * c + bias) * BF16_BYTES / peaks["hbm_bytes_per_s"])
    return total


def read(run):
    if not run.peaks:             # not a chip run: no device metric
        return None
    ms = device_ms_per_call(run, CORE)
    if ms is None:
        return None
    tr = run.cell.traffic
    return 100.0 * least_seconds(run.cell.config["network_g"], tr["height"], tr["width"],
                                 run.peaks) * 1e3 / ms
