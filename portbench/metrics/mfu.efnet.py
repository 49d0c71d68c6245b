"""EFNet's model work an image (``flops/efnet.py``: the frozen reference's
conv FLOPs plus EICA's linear layers and attention products at the cell's
shapes) at the bf16 peak, over the wall time of an image of the measured
window, in %."""

from portbench.flops.efnet import efnet_image_flops
from portbench.readers import mfu_pct


def read(run):
    if not run.peaks:             # not a chip run: no device metric
        return None
    net, tr = run.cell.config["network_g"], run.cell.traffic
    flops = efnet_image_flops(tr["height"], tr["width"], net["ev_chn"], net["wf"], net["depth"],
                              tuple(net["num_heads"]), net["ffn_expansion_factor"])
    return mfu_pct(run, flops / run.peaks["bf16_flop_per_s"])
