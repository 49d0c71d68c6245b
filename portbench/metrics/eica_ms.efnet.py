"""Device ms an image in the kernels that only EICA launches in EFNet (the
names in ``eica_kernels.txt``: its LayerNorms, the L2 norms, softmax, GELU
and cuBLAS's matrix products), from the profiled images.  A lower bound of
EICA's device time: its 1x1 convs run among cuDNN's, and its residual adds
among the network's elementwise kernels."""

from pathlib import Path

from portbench.readers import device_ms_per_call, names_matcher

MATCH = names_matcher(Path(__file__).with_name("eica_kernels.txt"))


def read(run):
    return device_ms_per_call(run, MATCH)
