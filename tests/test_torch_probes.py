"""The port's probes (``refid_tpu_torch/probes``) against the JAX probe
scripts on the CPU.

The scripts are loaded as module objects; each test swaps in, on that object
only, a ``pl`` whose ``pallas_call`` runs in interpret mode and, for the int8
kernel, a ``jnp`` whose ``float32`` is numpy's.  ``band_conv_int8`` closes
over two ``jnp.float32`` scalars, which this JAX refuses to trace as captured
constants (``scripts/probe_band_conv.py:88-89``); numpy scalars become
literals.  No JAX file changes.

Tolerances: P1, P2 and P4 bit-exact (``2x`` is exact; integer sums are
exact and every float step is one rounding in the same order).  P3 within 2
bf16 steps per element and >= 60 dB: its float32 sums run in another order.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from refid_tpu_torch.probes import band_conv as bc
from refid_tpu_torch.probes import poison
from tests.test_torch_helpers import parity_db

torch.set_num_threads(1)

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


class _Shim:
    """``base`` with some attributes replaced."""

    def __init__(self, base, **replaced):
        self._base = base
        self.__dict__.update(replaced)

    def __getattr__(self, name):
        return getattr(self._base, name)


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_probe_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_poison():
    return _load("probe_poison")


@pytest.fixture(scope="module")
def jax_bc():
    return _load("probe_band_conv")


@pytest.fixture
def interpret(monkeypatch):
    """``interpret(mod)``: that module's ``pl.pallas_call`` runs in interpret
    mode for this test."""
    def apply(mod):
        monkeypatch.setattr(mod, "pl", _Shim(mod.pl, pallas_call=functools.partial(
            mod.pl.pallas_call, interpret=True)))
        return mod
    return apply


def _f32(a):
    return np.asarray(a, np.float32)


def _nchw(d_nhwc, dtype):
    return torch.from_numpy(d_nhwc).to(dtype, copy=True).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


_DTYPES = [(torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)]


@pytest.mark.parametrize("band", [8, 16])
@pytest.mark.parametrize("dtypes", _DTYPES, ids=["bf16", "f32"])
def test_passthrough_plain_matches_pallas_op(jax_poison, interpret, dtypes, band):
    d = np.random.RandomState(0).randn(1, 32, 40, 64).astype(np.float32) * 50
    want = interpret(jax_poison).pallas_op(jnp.asarray(d, dtypes[1]), band=band)
    got = poison.passthrough(_nchw(d, dtypes[0]), band=band)
    assert got.dtype == dtypes[0] and got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(_nhwc(got), _f32(want))


@pytest.mark.parametrize("dtypes", _DTYPES, ids=["bf16", "f32"])
def test_tiny_passthrough_plain_matches_tiny_pallas(jax_poison, interpret, dtypes):
    d = np.random.RandomState(1).randn(1, 16, 160, 8).astype(np.float32) * 50
    want = interpret(jax_poison).tiny_pallas(jnp.asarray(d, dtypes[1]))
    x = _nchw(d, dtypes[0])
    got = poison.tiny_passthrough(x)
    assert got is x                                   # in place
    np.testing.assert_array_equal(_nhwc(got), _f32(want))
    assert not np.array_equal(_nhwc(got), _f32(jnp.asarray(d, dtypes[1])))


def _conv_inputs(h, wp, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(h, wp, 128).astype(np.float32)).bfloat16()
    w = torch.from_numpy(0.05 * rng.randn(3, 3, 128, 128).astype(np.float32)).bfloat16()
    return x, w


def _jax(t):
    """A torch tensor as a JAX array of the same type."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _assert_p3_close(want, got):
    want_t = torch.from_numpy(_f32(want))
    steps = bc.bf16_steps(got, want_t, bc.STEP_FLOOR * float(want_t.abs().max()))
    assert float(steps.max()) <= 2, f"{int((steps > 2).sum())} elements beyond 2 bf16 steps"
    assert parity_db(want_t, got.float()) >= 60.0


@pytest.mark.parametrize("rolls", [True, False], ids=["roll", "noroll"])
@pytest.mark.parametrize("h,band", [(32, 8), (48, 8), (32, 16), (48, 16)])
def test_band_conv_plain_matches_pallas(jax_bc, h, band, rolls):
    x, w = _conv_inputs(h, 40)
    want = jax_bc.band_conv(_jax(x), _jax(w), band=band, rolls=rolls, interpret=True)
    got = bc.band_conv(x, w, band=band, rolls=rolls)
    assert got.shape == (h, 40, 128) and got.dtype == torch.bfloat16
    _assert_p3_close(want, got)
    edges = got.reshape(h // band, band, 40, 128)[:, [0, band - 1]]
    assert not edges.float().any()


@pytest.mark.parametrize("kind,band", [("roll", 8), ("noroll", 8), ("pre", 8), ("roll", 16)])
def test_band_conv_int8_plain_matches_pallas(jax_bc, monkeypatch, kind, band):
    monkeypatch.setattr(jax_bc, "jnp", _Shim(jnp, float32=np.float32))
    x, w = _conv_inputs(32, 40, seed=1)
    x = x * 4            # spread the activations over the int8 range
    wq = bc.quantize(w, 0.01)
    xi = bc.quantize(x, 0.05) if kind == "pre" else x
    want = jax_bc.band_conv_int8(_jax(xi), _jax(wq), band=band, rolls=kind != "noroll",
                                 in_int8=kind == "pre", interpret=True)
    got = bc.band_conv_int8(xi, wq, band=band, rolls=kind != "noroll", in_int8=kind == "pre")
    assert got.dtype == torch.bfloat16 and float(got.float().abs().max()) > 0
    np.testing.assert_array_equal(got.float().numpy(), _f32(want))


def test_band_conv_interior_is_the_library_conv():
    """On each band's interior rows and columns, P3 (with rolls) is the conv."""
    x, w = _conv_inputs(32, 40, seed=2)
    got = bc.band_conv(x, w, band=8).float().reshape(4, 8, 40, 128)[:, 1:-1, 1:-1]
    ref = bc.library_conv(x, w).float().reshape(4, 8, 40, 128)[:, 1:-1, 1:-1]
    assert parity_db(ref, got) >= 60.0


def test_library_conv_matches_xla_conv(jax_bc):
    x, w = _conv_inputs(32, 40, seed=3)
    y = jax_bc.xla_conv(_jax(x), _jax(w))
    want = jnp.maximum(y, 0.1 * y)
    got = bc.library_conv(x, w)
    assert got.shape == (32, 40, 128) and got.dtype == torch.bfloat16
    assert parity_db(torch.from_numpy(_f32(want)), got.float()) >= 60.0


def test_library_conv_int8_matches_xla_conv_int8(jax_bc):
    x, w = _conv_inputs(32, 40, seed=4)
    xq, wq = bc.quantize(x * 4, 0.05), bc.quantize(w, 0.01)
    want = jax_bc.xla_conv_int8(_jax(xq), _jax(wq))
    got = bc.library_conv_int8(xq, wq)
    np.testing.assert_array_equal(got.float().numpy(), _f32(want))


def test_band_conv_checks_arguments():
    x, w = _conv_inputs(36, 16)
    with pytest.raises(ValueError, match="multiple of band"):
        bc.band_conv(x, w, band=8)                   # 36 % 8: rows would go unwritten
    with pytest.raises(ValueError, match="multiple of band"):
        bc.band_conv_int8(x, bc.quantize(w, 0.01), band=8)
    with pytest.raises(ValueError):
        bc.band_conv(x[:32], w[:, :, :64])
    with pytest.raises(TypeError, match="in_int8"):
        bc.band_conv_int8(x[:32], bc.quantize(w, 0.01), band=8, in_int8=True)


def test_work_counts_match_the_jax_scripts_rows():
    tap = bc.work("tap_roll")
    assert tap["ops"] == 90 * 6 * 648 * 9 * 128 * 128 * 2        # 103.2 GFLOP
    assert tap["bytes"] == 2 * 720 * 648 * 128 * 2 + 9 * 128 * 128 * 2
    assert bc.work("int8_pre")["bytes"] == 720 * 648 * 128 * 3 + 9 * 128 * 128
    assert bc.work("library_conv")["ops"] == 720 * 648 * 9 * 128 * 128 * 2
    assert bc.work("int8_roll")["int8"] and not bc.work("tap_noroll")["int8"]


def test_bf16_steps_are_units_in_the_last_place():
    want = torch.tensor([1.0, -1.0, 3.0, 1e-6, 0.0])
    got = want + torch.tensor([2 ** -7, -2 ** -7, 2 ** -5, 1e-6, 0.0])
    assert bc.bf16_steps(got, want).tolist()[:3] == [1.0, 1.0, 2.0]
    assert bc.bf16_steps(got, want).tolist()[4] == 0.0
    assert bc.bf16_steps(got, want)[3] > 100                 # near zero: many steps ...
    assert bc.bf16_steps(got, want, floor=1.0)[3] < 1e-3     # ... but none at the floor


@pytest.fixture(scope="module")
def full_inputs():
    return poison.random_inputs(0)


@pytest.mark.parametrize("variant,jax_variant", [("torch", "xla"), ("tiny", "tiny")])
def test_full_geometry_step_matches_jax(jax_poison, interpret, full_inputs, variant,
                                        jax_variant):
    e_np, params_np = full_inputs
    jstep = interpret(jax_poison).make_step(
        jax_variant, tuple(jnp.asarray(p, jnp.bfloat16) for p in params_np))
    want = jax.jit(jstep)(jnp.asarray(e_np, jnp.bfloat16))
    step = poison.make_step(variant, poison.params_from_jax(params_np))
    got = step(poison.to_nchw(e_np))
    assert got.shape == (1, 128, 720, 640) and got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    got = torch.from_numpy(_nhwc(got))
    assert bool(torch.isfinite(got).all())
    assert parity_db(torch.from_numpy(_f32(want)), got) >= 60.0


@pytest.mark.parametrize("variant", ["cuda", "cuda_b16", "barrier", "convert"])
def test_kernel_variants_equal_torch_on_the_cpu(variant):
    e_np, params_np = poison.random_inputs(1, h=32, w=24, c=16)
    params = poison.params_from_jax(params_np)
    want = poison.make_step("torch", params)(poison.to_nchw(e_np))
    got = poison.make_step(variant, params)(poison.to_nchw(e_np))
    assert torch.equal(got, want)


def test_params_from_jax_is_hwio_to_oihw():
    _, params_np = poison.random_inputs(2, h=4, w=4, c=8)
    for p, t in zip(params_np, poison.params_from_jax(params_np)):
        assert t.shape == (p.shape[3], p.shape[2], p.shape[0], p.shape[1])
        assert t.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_array_equal(t.float().permute(2, 3, 1, 0).numpy(),
                                      torch.from_numpy(p).bfloat16().float().numpy())
    with pytest.raises(ValueError, match="variant"):
        poison.make_step("pallas", poison.params_from_jax(params_np))


def test_band_conv_cli_on_the_cpu(capsys):
    results = bc.main(["--device", "cpu", "--band", "8"])
    assert results[0]["max_abs_err"] < 0.15 and results[0]["shape"] == [32, 40, 128]
    assert "interior max err" in capsys.readouterr().out


def test_poison_cli_on_the_cpu(capsys):
    results = poison.main(["--device", "cpu", "--height", "16", "--width", "128",
                           "--steps", "1", "--iters", "1", "--variants", "torch", "tiny",
                           "cuda_b16"])
    assert [r["variant"] for r in results] == ["torch", "tiny", "cuda_b16"]
    assert all(r["ms_per_step"] > 0 and r["device"] == "cpu" for r in results)
    assert "ms/step" in capsys.readouterr().out


@pytest.mark.parametrize("cli", [bc, poison], ids=["band_conv", "poison"])
def test_clis_default_to_cuda_and_raise_without_it(cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([])
