"""Device ms an image in Restormer's pre-norm kernels (the names in
``norm_kernels.txt``: PyTorch's LayerNorm, or the program's pre-norm
kernel, which also does the residual adds in front of the norms and at the
stage ends), from the profiled images.  The casts and transposing copies
around PyTorch's LayerNorm are left out."""

from pathlib import Path

from portbench.readers import device_ms_per_call, names_matcher

MATCH = names_matcher(Path(__file__).with_name("norm_kernels.txt"))


def read(run):
    return device_ms_per_call(run, MATCH)
