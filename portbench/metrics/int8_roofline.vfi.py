"""The int8 layer's share of its roofline: the sum over a window's int8
sites of the least time each could take (its operations at the int8 peak
or its bytes at the HBM rate, whichever is longer: ``flops/int8_sites``),
over the device time of the int8 layer's kernels (the names in
``int8_kernels.txt``) a profiled window, in %."""

from pathlib import Path

from portbench.flops.int8_sites import int8_site_bounds
from portbench.readers import device_ms_per_call, names_matcher

MATCH = names_matcher(Path(__file__).with_name("int8_kernels.txt"))


def read(run):
    cfg, tr = run.cell.config, run.cell.traffic
    if not cfg["int8"] or not run.peaks:
        return None
    ms = device_ms_per_call(run, MATCH)
    if ms is None:
        return None
    frames = 2 * cfg["num_end_interpolation"] + cfg["num_inter_interpolation"]
    least = int8_site_bounds(cfg["int8"], tr["height"], tr["width"], frames,
                             cfg["network_g"]["base_num_channels"],
                             run.peaks["int8_op_per_s"], run.peaks["hbm_bytes_per_s"])
    return 100.0 * least * 1e3 / ms
