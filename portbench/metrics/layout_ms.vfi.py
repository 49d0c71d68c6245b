"""Device ms a window in NCHW <-> NHWC layout kernels (the names in
``layout_kernels.txt``), from the profiled windows."""

from pathlib import Path

from portbench.readers import device_ms_per_call, names_matcher

MATCH = names_matcher(Path(__file__).with_name("layout_kernels.txt"))


def read(run):
    return device_ms_per_call(run, MATCH)
