"""Device ms an image in the kernels that only Uformer's window attention
launches (the names in ``wmsa_kernels.txt``: the cyclic shifts and the
attention kernels), from the profiled images.  A lower bound of W-MSA's
device time: its q, k, v and output projections run among the network's
other token linears, and the window partition and reverse copies and the
modulator's add run kernels the rest of the network also launches."""

from pathlib import Path

from portbench.readers import device_ms_per_call, names_matcher

MATCH = names_matcher(Path(__file__).with_name("wmsa_kernels.txt"))


def read(run):
    return device_ms_per_call(run, MATCH)
