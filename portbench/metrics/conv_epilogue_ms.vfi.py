"""Device ms a window in the passes that finish a conv's output (the names
in ``conv_epilogue_kernels.txt``: PyTorch's unvectorized bf16 add, which
adds a cuDNN conv's bias, its leaky ReLU and ReLU kernels, and the
program's own epilogue kernel), from the profiled windows.  An upper bound:
the same add kernel also runs LayerNorm2d's broadcast subtraction, and the
ReLU also the residual blocks' after their sum."""

from pathlib import Path

from portbench.readers import device_ms_per_call, names_matcher

MATCH = names_matcher(Path(__file__).with_name("conv_epilogue_kernels.txt"))


def read(run):
    return device_ms_per_call(run, MATCH)
