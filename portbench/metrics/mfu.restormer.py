"""Restormer's model work an image (``flops/restormer.py``: the frozen
reference's conv FLOPs plus MDTA's Gram and ``attn @ v`` products at the
cell's shapes) at the bf16 peak, over the wall time of an image of the
measured window, in %."""

from portbench.flops.restormer import restormer_image_flops
from portbench.readers import mfu_pct


def read(run):
    if not run.peaks:             # not a chip run: no device metric
        return None
    net, tr = run.cell.config["network_g"], run.cell.traffic
    flops = restormer_image_flops(tr["height"], tr["width"], net["inp_channels"], net["dim"],
                                  tuple(net["num_blocks"]), net["num_refinement_blocks"],
                                  tuple(net["heads"]), net["ffn_expansion_factor"])
    return mfu_pct(run, flops / run.peaks["bf16_flop_per_s"])
