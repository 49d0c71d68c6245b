"""The network's model work a window (the frozen reference's conv FLOPs at
the cell's shapes, ``flops/``) at the chip's peak, over the wall time of a
window of the measured window, in %.  Work at the cell's int8 sites counts
at the int8 peak, the rest at bf16's, whatever kernels ran."""

from portbench.flops.count import refid_window_flops
from portbench.flops.int8_sites import int8_site_ops
from portbench.readers import mfu_pct


def read(run):
    if not run.peaks:             # not a chip run: no device metric
        return None
    cfg, tr = run.cell.config, run.cell.traffic
    net = cfg["network_g"]
    frames = 2 * cfg["num_end_interpolation"] + cfg["num_inter_interpolation"]
    total = refid_window_flops(tr["height"], tr["width"], frames, net["img_chn"],
                               net["ev_chn"], net["num_encoders"], net["base_num_channels"])
    int8 = int8_site_ops(cfg["int8"], tr["height"], tr["width"], frames,
                         net["base_num_channels"]) if cfg["int8"] else 0
    least = (total - int8) / run.peaks["bf16_flop_per_s"] + int8 / run.peaks["int8_op_per_s"]
    return mfu_pct(run, least)
