"""The port's counterparts of the JAX package's probe scripts.

* ``python -m refid_tpu_torch.probes.band_conv``: rate of the band-resident
  width-folded 3x3 conv (P3 bf16 taps, P4 int8 taps) against cuDNN's
  channels_last conv and nine ``torch._int_mm`` tap products
  (``scripts/probe_band_conv.py``).
* ``python -m refid_tpu_torch.probes.poison``: whether a hand-written kernel
  between cuDNN convs (P1 over bands, P2 on one slice) slows them
  (``scripts/probe_poison.py``).

Both run on the card by default and raise without one; ``--device cpu``
runs the plain versions.
"""
