"""The kernels' launch path on the CPU: the cached conv plan and its
``ConvArgs``, the checks each wrapper makes before it touches the card, and
the P1 / P2 dispatchers against the JAX probes.

A wrapper's launch runs only on the card (``tests/test_torch_cuda.py``).
What it does before the launch is checked here: a tensor that reports
itself on ``cuda:0`` (``_OnCard``) carries a wrong type or layout past the
device check, and every wrapper must raise on it before it allocates.

Tolerances: the plans and ``ConvArgs`` equal, field for field; P1 and P2
bit-exact against the JAX probes' kernels in interpret mode (``2x`` is
exact, then one rounding).
"""

import ctypes
import functools
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke as cs
from refid_tpu_torch.events import voxel_cuda
from refid_tpu_torch.ops import int8_cuda, probe_cuda
from refid_tpu_torch.probes import poison
from refid_tpu_torch.serve.quant import padded_channels

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CONV_ARGS_FIELDS = ["n", "h", "w", "cp", "co", "kh", "kw", "stride", "pad_h", "pad_w", "ho",
                    "wo", "act", "slope", "out_dtype", "bn", "bw", "bh", "chunk", "stages",
                    "resident", "vector_store", "shared"]


def _site_cases():
    """(name, n, ho, wo, cp, co, kh, kw, stride) at every production int8
    site: the flagship's 16 and EVHINet's 14 at 720p, both at their 360-row
    shards (row padding 0), and chip_smoke.py's edge shapes."""
    cases = [(name, 1, h, w, padded_channels(cin), cout, k, k, s)
             for name, (cin, cout, h, w, k, s) in cs.INT8_CONV_SHAPES.items()]
    cases += [(f"evhinet_{name}", 1, h, w, padded_channels(cin), cout, k, k, 1)
              for name, (cin, cout, h, w, k) in cs.EVHINET_INT8_SHAPES.items()]
    for name, (cin, cout, h, w, k, s) in cs.shard_site_shapes().items():
        pad_w = 1 if k == 4 else k // 2
        cases.append((f"shard_{name}", 1, (h - k) // s + 1, (w + 2 * pad_w - k) // s + 1,
                      padded_channels(cin), cout, k, k, s))
    cases += [(f"edge{i}", n, (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1,
               padded_channels(cin), cout, k, k, s)
              for i, (n, cin, cout, h, w, k, s, p) in enumerate(cs.INT8_EDGE_SHAPES)]
    return cases


@pytest.mark.parametrize("out_bytes", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", _site_cases(), ids=lambda c: c[0])
def test_cached_conv_plan_equals_the_uncached_plan_at_every_site(case, out_bytes):
    args = (*case[1:], out_bytes)
    want = int8_cuda.conv_plan.__wrapped__(*args)
    assert int8_cuda.conv_plan(*args) == want
    assert int8_cuda.conv_plan(*args) == want          # a cache hit: the same plan


@pytest.mark.parametrize("co", [8, 16, 24, 32, 48, 64, 96, 128, 136, 256])
def test_cached_conv_plan_equals_the_uncached_plan_on_small_shapes(co):
    for n in (1, 2):
        for cp in (32, 64, 96, 128, 256):
            for k, stride in ((1, 1), (3, 1), (4, 2)):
                for ho, wo in ((1, 1), (3, 17), (9, 13), (16, 64), (33, 130)):
                    for out_bytes in (4, 2):
                        args = (n, ho, wo, cp, co, k, k, stride, out_bytes)
                        assert int8_cuda.conv_plan(*args) == int8_cuda.conv_plan.__wrapped__(*args)


def test_plan_caches_are_bounded():
    for cached in (int8_cuda.conv_plan, int8_cuda.conv_args):
        assert cached.cache_info().maxsize == int8_cuda.PLAN_CACHE_SIZE
    for i in range(int8_cuda.PLAN_CACHE_SIZE + 10):
        int8_cuda.conv_plan(1, 1 + i, 8, 32, 16, 3, 3, 1, 2)
        int8_cuda.conv_args(1, 3 + i, 8, 32, 16, 3, 3, 1, 1, 1, 0, 0.0, 1)
    for cached in (int8_cuda.conv_plan, int8_cuda.conv_args):
        assert cached.cache_info().currsize == int8_cuda.PLAN_CACHE_SIZE


@pytest.mark.parametrize("case", _site_cases()[::4], ids=lambda c: c[0])
def test_conv_args_carry_the_geometry_and_the_plan(case):
    _, n, ho, wo, cp, co, kh, kw, stride = case
    pad = 1 if kh == 4 else kh // 2
    h, w = (ho - 1) * stride + kh - 2 * pad, (wo - 1) * stride + kw - 2 * pad
    for out_dtype, out_bytes in ((0, 4), (1, 2)):
        a = int8_cuda.conv_args(n, h, w, cp, co, kh, kw, stride, pad, pad, 2, 0.1, out_dtype)
        plan = int8_cuda.conv_plan.__wrapped__(n, ho, wo, cp, co, kh, kw, stride, out_bytes)
        assert (a.n, a.h, a.w, a.cp, a.co, a.kh, a.kw, a.stride) == (n, h, w, cp, co, kh, kw,
                                                                     stride)
        assert (a.pad_h, a.pad_w, a.ho, a.wo, a.act, a.out_dtype) == (pad, pad, ho, wo, 2,
                                                                      out_dtype)
        assert a.slope == np.float32(0.1)
        assert (a.bn, a.bw, a.bh, a.chunk, a.stages) == (plan.bn, plan.bw, plan.bh, plan.chunk,
                                                         plan.stages)
        assert (a.resident, a.vector_store, a.shared) == (int(plan.resident),
                                                          int(plan.vector_store),
                                                          int(plan.shared))


def test_conv_args_structure_has_the_documented_layout():
    fields = int8_cuda.ConvArgs._fields_
    assert [name for name, _ in fields] == CONV_ARGS_FIELDS
    assert all(t is (ctypes.c_float if name == "slope" else ctypes.c_int) for name, t in fields)
    assert ctypes.sizeof(int8_cuda.ConvArgs) == 23 * 4
    assert [getattr(int8_cuda.ConvArgs, name).offset for name in CONV_ARGS_FIELDS] == \
        [4 * i for i in range(23)]


def test_conv_args_structure_mirrors_the_c_struct():
    """The C struct in csrc/conv_int8.cu declares the same fields in the
    same order, and its ABI list (CONV_ARGS_FIELDS) names them all."""
    src = (REPO / "refid_tpu_torch" / "csrc" / "conv_int8.cu").read_text()
    body = re.search(r"struct ConvArgs \{(.*?)\};", src, re.S).group(1)
    declared = [name for decl in body.split(";") if decl.strip()
                for name in re.sub(r"^\s*(int|float)\s+", "", decl.strip()).replace(" ", "")
                .split(",")]
    assert declared == CONV_ARGS_FIELDS
    listed = re.search(r"#define CONV_ARGS_FIELDS\(X\)((?:.*\\\n)*.*)", src)  # its continued lines
    assert re.findall(r"X\((\w+)\)", listed.group(1)) == CONV_ARGS_FIELDS


# ---- the wrappers' checks --------------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on ``cuda:0``: it passes a
    wrapper's device check, so the checks after it run here."""
    __torch_function__ = torch._C._disabled_torch_function_impl

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", 0)

    def get_device(self):
        return 0


def _on_card(t):
    return t.as_subclass(_OnCard)


def _bf16(*shape):
    return torch.randn(*shape).bfloat16()


def _wrong_layout_4d(dtype=torch.bfloat16):
    return torch.randn(1, 4, 8, 16).to(dtype).transpose(2, 3)   # neither dense order


def _int8_conv(xq=None, wp=None):
    xq = _on_card(torch.zeros(1, 8, 8, 32, dtype=torch.int8)) if xq is None else xq
    wp = _on_card(torch.zeros(16, 3, 3, 32, dtype=torch.int8)) if wp is None else wp
    scales = [_on_card(torch.ones(16)), _on_card(torch.ones(1)), _on_card(torch.zeros(16))]
    return int8_cuda.conv_int8_cuda(xq, wp, *scales, 1, 1)


_CALLS = {      # wrapper -> {case: (call, exception)}
    "passthrough": {
        "cpu": (lambda: probe_cuda.passthrough_cuda(_bf16(1, 4, 8, 16), 8), ValueError),
        "dtype": (lambda: probe_cuda.passthrough_cuda(_on_card(torch.zeros(1, 4, 8, 16,
                                                                            dtype=torch.int32)),
                                                      8), TypeError),
        "layout": (lambda: probe_cuda.passthrough_cuda(_on_card(_wrong_layout_4d()), 8),
                   ValueError)},
    "passthrough_slice": {
        "cpu": (lambda: probe_cuda.passthrough_slice_cuda(_bf16(1, 4, 8, 128)), ValueError),
        "dtype": (lambda: probe_cuda.passthrough_slice_cuda(
            _on_card(torch.zeros(1, 4, 8, 128, dtype=torch.float64))), TypeError),
        # any strides are the kernel's to take: its layout check is the rank
        "layout": (lambda: probe_cuda.passthrough_slice_cuda(_on_card(_bf16(8, 128))),
                   TypeError)},
    "band_conv": {
        "cpu": (lambda: probe_cuda.band_conv_cuda(_bf16(8, 16, 128), _bf16(3, 3, 128, 128)),
                ValueError),
        "dtype": (lambda: probe_cuda.band_conv_cuda(_on_card(torch.zeros(8, 16, 128)),
                                                    _on_card(torch.zeros(3, 3, 128, 128))),
                  TypeError),
        "layout": (lambda: probe_cuda.band_conv_cuda(
            _on_card(_bf16(128, 16, 8).permute(2, 1, 0)), _on_card(_bf16(3, 3, 128, 128))),
            ValueError)},
    "quantize_int8": {
        "cpu": (lambda: int8_cuda.quantize_int8_cuda(_bf16(1, 4, 8, 16)), ValueError),
        "dtype": (lambda: int8_cuda.quantize_int8_cuda(
            _on_card(torch.zeros(1, 4, 8, 16, dtype=torch.float64))), TypeError),
        "layout": (lambda: int8_cuda.quantize_int8_cuda(_on_card(_wrong_layout_4d())),
                   ValueError)},
    "amax_int8": {
        "cpu": (lambda: int8_cuda.amax_int8_cuda(_bf16(1, 4, 8, 16)), ValueError),
        "dtype": (lambda: int8_cuda.amax_int8_cuda(
            _on_card(torch.zeros(1, 4, 8, 16, dtype=torch.int8))), TypeError),
        "layout": (lambda: int8_cuda.amax_int8_cuda(_on_card(_wrong_layout_4d())),
                   ValueError)},
    "conv_int8": {
        "cpu": (lambda: _int8_conv(xq=torch.zeros(1, 8, 8, 32, dtype=torch.int8)),
                ValueError),
        "dtype": (lambda: _int8_conv(wp=_on_card(torch.zeros(16, 3, 3, 32))), TypeError),
        "layout": (lambda: _int8_conv(
            xq=_on_card(torch.zeros(1, 8, 32, 8, dtype=torch.int8).transpose(2, 3))),
            ValueError)},
    "voxelize": {
        "cpu": (lambda: voxel_cuda.voxelize_cuda(torch.zeros(16, 4), 4, 3, 8, 8), ValueError),
        "dtype": (lambda: voxel_cuda.voxelize_cuda(
            _on_card(torch.zeros(16, 4, dtype=torch.float64)), 4, 3, 8, 8), TypeError),
        "layout": (lambda: voxel_cuda.voxelize_cuda(_on_card(torch.zeros(4, 16).t()), 4, 3,
                                                    8, 8), ValueError)},
}


_REASONS = {"cpu": "needs a CUDA tensor", "dtype": "take|must be float32",
            "layout": "contiguous|4-D"}


@pytest.mark.parametrize("case", ["cpu", "dtype", "layout"])
@pytest.mark.parametrize("wrapper", sorted(_CALLS))
def test_wrapper_raises_before_it_launches(wrapper, case):
    call, exc = _CALLS[wrapper][case]
    with pytest.raises(exc, match=_REASONS[case]):
        call()


def test_p2_wrapper_raises_without_a_window():
    """``d[0, 0, :8, :128]`` of a tensor with no image or channel raises, as
    the slice does on the CPU."""
    with pytest.raises(IndexError):
        probe_cuda.passthrough_slice_cuda(_on_card(torch.zeros(0, 4, 8, 128)))
    with pytest.raises(IndexError):
        poison.tiny_passthrough(torch.zeros(1, 0, 8, 128))


def test_wrappers_bind_nothing_until_a_launch():
    """Nothing above reached a library: each wrapper binds its C functions
    at its first launch, after its checks."""
    for case in ("cpu", "dtype", "layout"):
        for wrapper in _CALLS:
            with pytest.raises((ValueError, TypeError)):
                _CALLS[wrapper][case][0]()
    assert probe_cuda._fns == {} and int8_cuda._fns == {} and voxel_cuda._fns == {}


# ---- the P1 / P2 dispatchers against the JAX probes -----------------------------------

@functools.lru_cache(maxsize=None)
def _jax_poison():
    spec = importlib.util.spec_from_file_location("_launch_probe_poison",
                                                  REPO / "scripts" / "probe_poison.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_poison(monkeypatch):
    """The JAX script with its ``pallas_call`` in interpret mode."""
    mod = _jax_poison()
    monkeypatch.setattr(mod, "pl", _Interpret(mod.pl))
    return mod


class _Interpret:
    """``pl`` with ``pallas_call`` in interpret mode."""

    def __init__(self, base):
        self._base = base
        self.pallas_call = functools.partial(base.pallas_call, interpret=True)

    def __getattr__(self, name):
        return getattr(self._base, name)


_DTYPES = [(torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)]


def _nchw(d_nhwc, dtype):
    return torch.from_numpy(d_nhwc).to(dtype, copy=True).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("shape,band", [((1, 16, 64, 64), 8), ((1, 16, 64, 64), 16),
                                        ((1, 8, 24, 136), 8)])
@pytest.mark.parametrize("dtypes", _DTYPES, ids=["bf16", "f32"])
def test_p1_dispatcher_equals_the_jax_probe(jax_poison, dtypes, shape, band):
    """``poison.passthrough`` (P1's dispatcher; its plain version on the
    CPU) at the probe's layout, channels last, against ``pallas_op``."""
    d = np.random.RandomState(sum(shape) + band).randn(*shape).astype(np.float32) * 50
    want = jax_poison.pallas_op(jnp.asarray(d, dtypes[1]), band=band)
    got = poison.passthrough(_nchw(d, dtypes[0]), band=band)
    assert got.dtype == dtypes[0] and got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want, np.float32))


@pytest.mark.parametrize("shape", [(1, 8, 128, 4), (2, 12, 130, 3)])
@pytest.mark.parametrize("dtypes", _DTYPES, ids=["bf16", "f32"])
def test_p2_dispatcher_equals_the_jax_probe(jax_poison, dtypes, shape):
    """``poison.tiny_passthrough`` (P2's dispatcher: the (8, 128) slice,
    taken each call, updated in place) against ``tiny_pallas``."""
    d = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32) * 50
    want = jax_poison.tiny_pallas(jnp.asarray(d, dtypes[1]))
    x = _nchw(d, dtypes[0])
    got = poison.tiny_passthrough(x)
    assert got is x
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want, np.float32))
