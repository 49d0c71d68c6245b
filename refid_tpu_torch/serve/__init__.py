"""int8 serving (``serve/quant.py``), mirroring ``refid_tpu/serve``."""
