"""MDTA's products' share of their roofline: the sum over the transformer
blocks of the least time of each block's Gram and ``attn @ v`` products
(``2 * 2 P C^2 / h`` FLOPs at the bf16 peak, or their bytes at the HBM
rate, whichever is longer; the bytes are the normalised queries and keys
and the values read and the output written, ``4 P C`` bf16 elements), over
the device time of the product kernels (the names in
``mdta_gemm_kernels.txt``) an image, in %."""

from pathlib import Path

from portbench.flops.restormer import mdta_blocks
from portbench.readers import device_ms_per_call, names_matcher

GEMM = names_matcher(Path(__file__).with_name("mdta_gemm_kernels.txt"))
BF16_BYTES = 2


def read(run):
    if not run.peaks:             # not a chip run: no device metric
        return None
    ms = device_ms_per_call(run, GEMM)
    if ms is None:
        return None
    net, tr = run.cell.config["network_g"], run.cell.traffic
    least = sum(max(2 * 2 * p * c * c / h / run.peaks["bf16_flop_per_s"],
                    4 * p * c * BF16_BYTES / run.peaks["hbm_bytes_per_s"])
                for p, c, h in mdta_blocks(tr["height"], tr["width"], net["dim"],
                                           net["num_blocks"], net["num_refinement_blocks"],
                                           net["heads"]))
    return 100.0 * least * 1e3 / ms
