"""Published peaks of the chips the benchmark runs on (NVIDIA's H100 SXM
data sheet: dense rates, no sparsity, at the 700 W power limit)."""

PEAKS = {
    "H100": {"bf16_flop_per_s": 989e12, "int8_op_per_s": 1979e12,
             "hbm_bytes_per_s": 3.35e12},
}


def peaks(kind: str) -> dict:
    """The peaks of the chip whose name (``torch.cuda.get_device_name``)
    is ``kind``."""
    for key, value in PEAKS.items():
        if key in kind:
            return value
    raise KeyError(f"no peaks recorded for {kind!r}")
