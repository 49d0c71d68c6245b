"""Device ms an image in depthwise-conv kernels (the names in
``dwconv_kernels.txt``), from the profiled images.  In Restormer only
MDTA's ``qkv_dwconv`` and GDFN's ``dwconv`` launch them."""

from pathlib import Path

from portbench.readers import device_ms_per_call, names_matcher

MATCH = names_matcher(Path(__file__).with_name("dwconv_kernels.txt"))


def read(run):
    return device_ms_per_call(run, MATCH)
