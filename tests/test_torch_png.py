"""The port's PNG codec against cv2, through the JAX package's
``refid_tpu.data.img_util`` (CPU).

Every legal PNG: colour types 0, 2, 3, 4 and 6 at each bit depth PNG allows,
every row filter, Adam7, palettes with and without ``tRNS``.  The files come
from ``_png`` below, a writer independent of the port (rows filtered in a
Python loop), and from the port's own ``png_encode``.

Tolerances: ``color`` and ``unchanged`` are bit-exact (dtype, shape and
every value) against ``refid_tpu.data.img_util.imfrombytes`` (cv2's libpng
read); ``grayscale`` is bit-exact too (libpng's integer weights, and its
gamma tables when the file has a gamma, reproduce it).  The C unfilter
equals the plain ``_unfilter`` byte for byte.
``padding`` is exact against the JAX ``padding`` (cv2's BORDER_REFLECT).
"""

import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from refid_tpu.data import img_util as jax_img
from refid_tpu_torch.data import img_util
from refid_tpu_torch.ops import build

torch.set_num_threads(1)

LEGAL = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
         (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2),
         (0, 1, 2, 2), (1, 0, 2, 1))
FLAGS = ("color", "unchanged", "grayscale")


def _filter_row(kind, line, prev, bpp):
    out = bytearray(len(line))
    for i, x in enumerate(line):
        a = line[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (x - pred) & 0xFF
    return bytes(out)


def _pack_rows(samples, depth):
    """(h, w, c) ints -> list of row byte strings at ``depth``."""
    rows = []
    for row in samples:
        flat = row.reshape(-1)
        if depth == 16:
            rows.append(flat.astype(">u2").tobytes())
        elif depth == 8:
            rows.append(flat.astype(np.uint8).tobytes())
        else:
            bits = np.unpackbits(flat.astype(np.uint8)[:, None], axis=1)[:, 8 - depth:]
            rows.append(np.packbits(bits.reshape(-1)).tobytes())
    return rows


GAMMA = ((b"gAMA", struct.pack(">I", 45455)),)


def _png(samples, depth, colour, filters=(0,), interlace=False, plte=None, trns=None,
         ancillary=GAMMA):
    """PNG bytes of ``samples`` (h, w, c) stored as they are; row r of each
    pass gets ``filters[r % len(filters)]``; ``ancillary`` chunks go before
    PLTE (a file gamma changes only the grey read of colour images)."""
    h, w, c = samples.shape
    bpp = max(1, depth * c // 8)
    stream, row_no = [], 0
    for y0, x0, dy, dx in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        prev = None
        for line in _pack_rows(sub, depth):
            prev = prev or bytes(len(line))
            kind = filters[row_no % len(filters)]
            row_no += 1
            stream.append(bytes([kind]) + _filter_row(kind, line, prev, bpp))
            prev = line

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour,
                                                             0, 0, int(interlace)))
    for kind, body in ancillary:
        out += chunk(kind, body)
    if plte is not None:
        out += chunk(b"PLTE", plte.astype(np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    data = zlib.compress(b"".join(stream), 6)
    return out + chunk(b"IDAT", data[:7]) + chunk(b"IDAT", data[7:]) + chunk(b"IEND", b"")


def _random_image(rng, colour, depth, h=13, w=19, palette_size=None):
    c = CHANNELS[colour]
    top = (1 << depth) - 1
    if colour == 3:
        top = min(top, (palette_size or 256) - 1)
    return rng.randint(0, top + 1, (h, w, c)).astype(np.int64)


def _assert_same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape, (
        got.dtype, got.shape, want.dtype, want.shape)
    np.testing.assert_array_equal(got, want)


def _assert_reads_like_cv2(data, flags=FLAGS):
    for flag in flags:
        _assert_same(img_util.imfrombytes(data, flag), jax_img.imfrombytes(data, flag))


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("colour,depth", LEGAL, ids=[f"type{c}-{d}bit" for c, d in LEGAL])
def test_every_legal_png_reads_like_cv2(colour, depth, interlace):
    rng = np.random.RandomState(colour * 32 + depth + interlace)
    plte = None
    if colour == 3:
        n = min(1 << depth, 200)
        plte = rng.randint(0, 256, (n, 3))
    img = _random_image(rng, colour, depth, palette_size=None if plte is None else len(plte))
    data = _png(img, depth, colour, filters=(0, 1, 2, 3, 4, 4, 3), interlace=interlace,
                plte=plte)
    _assert_reads_like_cv2(data)


@pytest.mark.parametrize("kind", range(5))
@pytest.mark.parametrize("colour,depth", [(2, 8), (6, 16), (0, 2)])
def test_each_row_filter_reads_like_cv2(colour, depth, kind):
    rng = np.random.RandomState(kind)
    img = _random_image(rng, colour, depth, h=9, w=31)
    _assert_reads_like_cv2(_png(img, depth, colour, filters=(kind,)))


@pytest.mark.parametrize("colour,depth,trns", [
    (3, 8, bytes([0, 128, 255, 7])), (3, 2, bytes([10])), (2, 8, struct.pack(">HHH", 3, 1, 2)),
    (2, 16, struct.pack(">HHH", 3, 1, 2)), (0, 8, struct.pack(">H", 2)),
    (0, 16, struct.pack(">H", 2))])
def test_trns_reads_like_cv2(colour, depth, trns):
    """tRNS: alpha in the unchanged read of colour and palette images,
    ignored by the colour read and on grey."""
    rng = np.random.RandomState(depth)
    plte = rng.randint(0, 256, (1 << min(depth, 8), 3)) if colour == 3 else None
    img = rng.randint(0, 4, (11, 14, CHANNELS[colour]))      # many pixels hit the key
    _assert_reads_like_cv2(_png(img, depth, colour, filters=(4, 1), plte=plte, trns=trns))


@pytest.mark.parametrize("ancillary", [
    (), GAMMA, ((b"gAMA", struct.pack(">I", 100000)),), ((b"gAMA", struct.pack(">I", 70000)),),
    ((b"sRGB", bytes([0])),), ((b"sBIT", bytes([12, 12, 12])), *GAMMA)],
    ids=["none", "gamma2.2", "gamma1", "gamma1.43", "srgb", "sbit12"])
@pytest.mark.parametrize("colour,depth", [(2, 8), (2, 16), (6, 16), (3, 8)])
def test_grayscale_reads_like_cv2_under_each_file_gamma(colour, depth, ancillary):
    """libpng's RGB-to-grey runs in linear light when the file has a
    significant gamma; grey pixels (r = g = b) take another path."""
    rng = np.random.RandomState(depth + len(ancillary))
    plte = rng.randint(0, 256, (256, 3)) if colour == 3 else None
    img = _random_image(rng, colour, depth, h=24, w=32)
    if colour != 3:
        img[::3, :, 1:3] = img[::3, :, :1]          # a third of the rows grey
    else:
        plte[::4, 1:] = plte[::4, :1]
    data = _png(img, depth, colour, filters=(1,), plte=plte, ancillary=ancillary)
    _assert_reads_like_cv2(data, ("grayscale",))


def test_short_palette_reads_out_of_range_indices_as_black():
    rng = np.random.RandomState(5)
    img = rng.randint(0, 16, (8, 8, 1))
    data = _png(img, 4, 3, plte=rng.randint(0, 256, (6, 3)))
    _assert_reads_like_cv2(data, ("color", "unchanged"))


@pytest.mark.parametrize("flag", FLAGS)
@pytest.mark.parametrize("float32,rgb", [(False, False), (True, True), (True, False)])
def test_imfrombytes_options_match_jax(flag, float32, rgb):
    rng = np.random.RandomState(7)
    img = _random_image(rng, 6, 16)
    data = _png(img, 16, 6, filters=(3,))
    got = img_util.imfrombytes(data, flag, float32=float32, rgb=rgb)
    want = jax_img.imfrombytes(data, flag, float32=float32, rgb=rgb)
    _assert_same(got, want)
    assert got.flags.writeable and got.flags.c_contiguous


def test_imread_matches_jax_on_a_filtered_file(tmp_path):
    rng = np.random.RandomState(8)
    img = rng.randint(0, 256, (21, 34, 3)).astype(np.uint8)
    path = str(tmp_path / "a.png")
    with open(path, "wb") as f:
        f.write(img_util.png_encode(img, filter="adaptive"))
    _assert_same(img_util.imread(path), jax_img.imread(path))
    _assert_same(img_util.imread(path, float32=False, rgb=False), cv2.imread(path))


def test_bad_files_raise():
    img = np.zeros((4, 4, 3), np.uint8)
    good = img_util.png_encode(img)
    with pytest.raises(ValueError, match="not a PNG"):
        img_util.imfrombytes(b"GIF89a" + good[6:])
    with pytest.raises(ValueError, match="CRC"):
        img_util.imfrombytes(good[:20] + bytes([good[20] ^ 1]) + good[21:])
    with pytest.raises(ValueError, match="legal"):
        img_util.imfrombytes(_bad_depth_png())
    with pytest.raises(ValueError, match="filter"):
        img_util.imfrombytes(_png(img.astype(np.int64), 8, 2, filters=(7,)))
    with pytest.raises(ValueError, match="flag"):
        img_util.imfrombytes(good, "anydepth")


def _bad_depth_png():
    """An RGB image declared at 4 bits (PNG allows 8 and 16 only)."""
    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 2, 4, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(8))) + chunk(b"IEND", b""))


# --- the C unfilter against the plain version ---------------------------------

@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_c_unfilter_equals_plain(bpp):
    rng = np.random.RandomState(bpp)
    height, stride = 23, bpp * 17
    raw = rng.randint(0, 256, (height, stride + 1)).astype(np.uint8)
    raw[:, 0] = rng.randint(0, 5, height)
    raw[0, 0] = 4                     # Paeth and Average on the first row
    raw[1, 0] = 3
    got = img_util.unfilter(raw.reshape(-1), height, stride, bpp)
    want = img_util._unfilter(raw.reshape(-1), height, stride, bpp)
    _assert_same(got, want)


def test_c_unfilter_rejects_an_unknown_filter_and_skips_filter_zero(monkeypatch):
    raw = np.zeros((3, 7), np.uint8)
    assert img_util.unfilter(raw.reshape(-1), 3, 6, 3).shape == (3, 6)
    raw[2, 0] = 5
    with pytest.raises(ValueError, match="filter 5"):
        img_util.unfilter(raw.reshape(-1), 3, 6, 3)
    monkeypatch.setattr(img_util, "_unfilter_lib", None)    # all filter 0: no call
    raw[2, 0] = 0
    assert not img_util.unfilter(raw.reshape(-1), 3, 6, 3).any()


def test_host_build_is_keyed_apart_from_the_cuda_sources():
    """The .c source is in neither the kernel list nor the CUDA libraries'
    hash, and its library is reused once built."""
    assert "png_unfilter" not in build.kernel_names()
    cu = build._library_path("voxelize")
    path = build.build_host("png_unfilter")
    assert path.is_file() and path.parent == build.BUILD_DIR
    assert build.build_host("png_unfilter") == path and build._library_path("voxelize") == cu


def test_missing_c_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CC", "no-such-cc")
    with pytest.raises(RuntimeError, match="no C compiler"):
        build._find_cc()


# --- the encoder ------------------------------------------------------------------

@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "adaptive"])
@pytest.mark.parametrize("dtype,channels", [(np.uint8, 1), (np.uint8, 3), (np.uint8, 4),
                                            (np.uint16, 2), (np.uint16, 3)])
def test_png_encode_round_trips_through_cv2_and_the_port(dtype, channels, filt, interlace):
    rng = np.random.RandomState(channels)
    top = np.iinfo(dtype).max
    img = rng.randint(0, top + 1, (17, 26, channels)).astype(dtype)
    data = img_util.png_encode(img, compress_level=3, filter=filt, interlace=interlace)
    want = img[..., 0] if channels == 1 else img
    port = img_util.imfrombytes(data, "unchanged")
    cv = jax_img.imfrombytes(data, "unchanged")
    if channels >= 3:       # cv2 and the unchanged read give BGR(A)
        want = want[..., [2, 1, 0, 3][:channels]]
    if channels == 2:       # grey-alpha: grey repeated, then alpha
        want = img[..., [0, 0, 0, 1]]
    _assert_same(port, want)
    _assert_same(cv, want)


def test_imwrite_and_imencode_take_cv2_order(tmp_path):
    rng = np.random.RandomState(3)
    bgra = rng.randint(0, 256, (10, 12, 4)).astype(np.uint8)
    _assert_same(cv2.imdecode(np.frombuffer(img_util.imencode_png(bgra, 4), np.uint8),
                              cv2.IMREAD_UNCHANGED), bgra)
    bgr = bgra[..., :3]
    path = str(tmp_path / "d" / "x.png")
    assert img_util.imwrite(bgr, path)
    _assert_same(cv2.imread(path, cv2.IMREAD_UNCHANGED), np.ascontiguousarray(bgr))
    with open(path, "rb") as f:      # cv2.imwrite's settings: Sub rows
        _, lines = img_util.png_scanlines(bgr[..., ::-1], 1)
        written = f.read()
        assert zlib.decompress(written[41:-16]) == lines.tobytes()
    tensor_path = str(tmp_path / "t.png")     # a tensor: reordered where it lies
    assert img_util.imwrite(torch.from_numpy(np.ascontiguousarray(bgr)), tensor_path)
    with open(tensor_path, "rb") as f:
        assert f.read() == written
    grey = bgra[..., 0]
    _assert_same(img_util.png_order(torch.from_numpy(grey)), grey)


def test_png_encode_rejects_what_it_cannot_write():
    with pytest.raises(TypeError):
        img_util.png_encode(np.zeros((2, 2), np.float32))
    with pytest.raises(ValueError):
        img_util.png_encode(np.zeros((2, 2, 5), np.uint8))
    with pytest.raises(ValueError):
        img_util.png_encode(np.zeros((2, 2), np.uint8), filter=5)


# --- padding ------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,gt_size", [(5, 7, 9), (3, 4, 11), (6, 6, 6), (8, 2, 8),
                                         (2, 9, 5)])
@pytest.mark.parametrize("channels", [0, 3, 6])
def test_padding_matches_jax(h, w, gt_size, channels):
    rng = np.random.RandomState(h * w)
    shape = (h, w) if channels == 0 else (h, w, channels)
    lq = rng.rand(*shape).astype(np.float32)
    gt = rng.rand(*shape).astype(np.float32)
    for got, want in zip(img_util.padding(lq, gt, gt_size), jax_img.padding(lq, gt, gt_size)):
        _assert_same(got, want)
