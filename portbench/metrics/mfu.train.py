"""The training step's model work (three times the frozen reference's
forward conv FLOPs at the batch's shapes: the forward and the two halves
of the backward; remat's recomputed forward not counted) at the bf16 peak,
over the wall time of a step of the measured window, in %."""

from portbench.flops.count import refid_window_flops
from portbench.readers import mfu_pct


def read(run):
    if not run.peaks:
        return None
    net, tr = run.cell.config["network_g"], run.cell.traffic
    flops = 3 * refid_window_flops(tr["crop"], tr["crop"], tr["frames"], net["img_chn"],
                                   net["ev_chn"], net["num_encoders"],
                                   net["base_num_channels"], tr["batch"])
    return mfu_pct(run, flops / run.peaks["bf16_flop_per_s"])
