"""Uformer's model work an image (``flops/uformer.py``: the frozen
reference's conv FLOPs at the padded frame plus the token linears and
W-MSA's two products at the cell's shapes) at the bf16 peak, over the wall
time of an image of the measured window, in %."""

from portbench.flops.uformer import uformer_image_flops
from portbench.readers import mfu_pct


def read(run):
    if not run.peaks:             # not a chip run: no device metric
        return None
    net, tr = run.cell.config["network_g"], run.cell.traffic
    flops = uformer_image_flops(tr["height"], tr["width"], net["dd_in"], net["embed_dim"],
                                tuple(net["depths"]), tuple(net["num_heads"]), net["win_size"],
                                net["mlp_ratio"])
    return mfu_pct(run, flops / run.peaks["bf16_flop_per_s"])
