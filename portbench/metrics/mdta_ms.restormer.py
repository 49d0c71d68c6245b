"""Device ms an image in the kernels that only MDTA's core launches in
Restormer (the names in ``mdta_kernels.txt``: the L2 norms over the frame,
their division, the temperature, softmax; and in ``mdta_gemm_kernels.txt``:
the Gram and ``attn @ v`` products), from the profiled images.  A lower
bound of MDTA's device time: its 1x1 and depthwise convs run among the
network's other convs, and its casts to bf16 and residual adds among its
elementwise kernels."""

from pathlib import Path

from portbench.readers import device_ms_per_call, names_matcher

HERE = Path(__file__).parent
CORE = names_matcher(HERE / "mdta_kernels.txt")
GEMM = names_matcher(HERE / "mdta_gemm_kernels.txt")


def read(run):
    return device_ms_per_call(run, lambda name: CORE(name) or GEMM(name))
