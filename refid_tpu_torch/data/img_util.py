"""Host-side image IO (mirrors ``refid_tpu/data/img_util.py``) without cv2.

Images are HWC float32 RGB in [0, 1] end to end, as in the JAX package.
PNG is read and written with ``zlib`` and numpy, with the row unfiltering
in a host C function (``csrc/png_unfilter.c``, built by ``ops/build.py`` at
first use; an image whose rows are all filter 0 needs no call).

:func:`imfrombytes` reads every legal PNG as cv2's ``imdecode`` does (its
libpng reader): colour types 0, 2, 3, 4 and 6, bit depths 1-16, Adam7
interlace.  Its three flags:

* ``color``: ``(h, w, 3)`` uint8 BGR.  16-bit samples become ``>> 8``,
  sub-byte grey is scaled to 0-255, a palette expands, grey repeats to three
  channels, alpha and ``tRNS`` are dropped.
* ``unchanged``: the stored depth (uint16 stays), grey as ``(h, w)``, alpha
  kept (BGRA; grey-alpha as grey repeated plus alpha), ``tRNS`` as alpha on
  colour and palette images.
* ``grayscale``: ``(h, w)`` uint8; colour through libpng's RGB-to-grey
  weights (9797, 19234, 3737) / 2**15 with truncation (rounded in 16 bits
  before the ``>> 8``), which is what cv2's read gives.

:func:`png_encode` writes 8- and 16-bit images with 1-4 channels at a zlib
level, with any one row filter or libpng's adaptive choice per row, and
optionally Adam7-interlaced.  :func:`imwrite` writes as ``cv2.imwrite``
does with no parameters: level 1, Sub filter, zlib's RLE strategy.
"""

from __future__ import annotations

import ctypes
import math
import os
import struct
import threading
import zlib

import numpy as np
import torch

__all__ = ["imfrombytes", "imread", "imwrite", "imencode_png", "png_order", "tensor2img",
           "padding", "png_decode", "png_encode", "png_scanlines", "png_deflate", "png_chunks",
           "unfilter", "png_size", "unit_float"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # PNG colour type -> samples per pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (first row, first column, row step, column step)
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2),
          (0, 1, 2, 2), (1, 0, 2, 1))
_GREY_WEIGHTS = (9797, 19234, 3737)   # libpng's R, G, B for 0.299, 0.587 (sum 2**15)
_FLAGS = ("color", "grayscale", "unchanged")
_SRGB_GAMMA = 45455                   # libpng's file gamma of an sRGB chunk


def _chunks(data: bytes):
    """(type, body) of each chunk, its CRC checked; bodies are views."""
    view = memoryview(data)
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack_from(">I4s", data, pos)
        body = view[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(crc) < 4 or zlib.crc32(body, zlib.crc32(kind)) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {kind!r}: truncated or CRC mismatch")
        yield kind, body
        pos += 12 + length


# --- unfiltering ----------------------------------------------------------

def _unfilter_row_sequential(kind: int, line: bytearray, prev: bytes, bpp: int) -> bytearray:
    """Filters 3 and 4, byte by byte (each byte needs its reconstructed left
    neighbour)."""
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prev[i]
        if kind == 3:
            line[i] = (line[i] + ((a + b) >> 1)) & 0xFF
        else:
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            line[i] = (line[i] + pred) & 0xFF
    return line


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """The plain version of :func:`unfilter`, in numpy and Python loops."""
    rows = raw.reshape(height, stride + 1)
    kinds = rows[:, 0]
    data = rows[:, 1:]
    if not kinds.any():
        return data
    if kinds.max() > 4:
        raise ValueError(f"PNG row filter {int(kinds.max())} is not 0-4")
    out = np.empty_like(data)
    prev = np.zeros(stride, np.uint8)
    for r in range(height):
        kind, line = int(kinds[r]), data[r]
        if kind == 0:
            cur = line
        elif kind == 1:   # sub: a running sum along the row, per channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:   # up
            cur = line + prev
        else:
            cur = np.frombuffer(_unfilter_row_sequential(
                kind, bytearray(line.tobytes()), prev.tobytes(), bpp), np.uint8)
        out[r] = cur
        prev = out[r]
    return out


_lib = None
_lib_lock = threading.Lock()


def _unfilter_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            from refid_tpu_torch.ops import build
            lib = build.load_host("png_unfilter")
            fn = lib.refid_png_unfilter
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int64
            _lib = lib
        return _lib


def unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the row filters of one image or Adam7 pass: ``raw`` holds
    ``height`` rows of a filter byte and ``stride`` bytes, ``bpp`` is
    max(1, bits per pixel // 8).  Returns ``(height, stride)`` uint8, through
    the host C function unless every row is filter 0."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"PNG data of {raw.size} bytes is not {height} rows of {stride + 1}")
    rows = raw.reshape(height, stride + 1)
    if not rows[:, 0].any():
        return rows[:, 1:]
    out = np.empty((height, stride), np.uint8)
    bad = _unfilter_lib().refid_png_unfilter(raw.ctypes.data, height, stride, bpp,
                                             out.ctypes.data)
    if bad:
        raise ValueError(f"PNG row filter {int(rows[bad - 1, 0])} is not 0-4")
    return out


# --- decoding -------------------------------------------------------------

def _unpack(data: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """``(h, stride)`` unfiltered bytes -> ``(h, width, channels)`` samples
    (uint8, or uint16 for 16-bit)."""
    h = data.shape[0]
    if depth == 8:
        return data[:, :width * channels].reshape(h, width, channels)
    if depth == 16:
        words = np.ascontiguousarray(data[:, :width * channels * 2]).view(">u2")
        return words.astype(np.uint16).reshape(h, width, channels)
    per_byte = 8 // depth       # sub-byte: grey or palette, one channel
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    samples = (data[:, :, None] >> shifts) & ((1 << depth) - 1)
    return samples.reshape(h, data.shape[1] * per_byte)[:, :width, None]


def _samples(data: bytes):
    """PNG bytes -> (``(h, w, c)`` samples as stored, colour type, bit
    depth, ``{"palette": (256, 3) or None, "trns": body or None, "gamma":
    file gamma x 1e5 or None, "sbit": significant bits or None}``)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    header, idat = None, []
    extra = {"palette": None, "trns": None, "gamma": None, "sbit": None}
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.zeros((256, 3), np.uint8)   # libpng: missing entries are black
            entries = np.frombuffer(body, np.uint8)[:768]
            palette.reshape(-1)[:len(entries) // 3 * 3] = entries[:len(entries) // 3 * 3]
            extra["palette"] = palette
        elif kind == b"tRNS":
            extra["trns"] = bytes(body)
        elif kind == b"gAMA" and len(body) == 4 and extra["gamma"] != _SRGB_GAMMA:
            gamma = struct.unpack(">I", body)[0]
            if 16 <= gamma <= 625000000:      # libpng ignores values out of range
                extra["gamma"] = gamma
        elif kind == b"sRGB":
            extra["gamma"] = _SRGB_GAMMA
        elif kind == b"sBIT" and len(body):
            extra["sbit"] = max(body[:3])
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, colour, _, _, interlace = header
    if colour not in _DEPTHS or depth not in _DEPTHS[colour] or interlace not in (0, 1):
        raise ValueError(f"not a legal PNG: colour type {colour}, bit depth {depth}, "
                         f"interlace {interlace}")
    if colour == 3 and extra["palette"] is None:
        raise ValueError("palette PNG without PLTE")
    channels = _CHANNELS[colour]
    bpp = max(1, depth * channels // 8)
    inflate = zlib.decompressobj()
    raw = np.frombuffer(b"".join(inflate.decompress(part) for part in idat), np.uint8)
    if interlace:
        img = np.zeros((height, width, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for y0, x0, dy, dx in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        ph, pw = (height - y0 + dy - 1) // dy, (width - x0 + dx - 1) // dx
        if ph <= 0 or pw <= 0:
            continue
        stride = (pw * channels * depth + 7) // 8
        size = ph * (stride + 1)
        if pos + size > raw.size:
            raise ValueError("PNG image data is truncated")
        rows = unfilter(raw[pos:pos + size], ph, stride, bpp)
        pos += size
        if interlace:
            img[y0::dy, x0::dx] = _unpack(rows, pw, channels, depth)
        else:
            img = _unpack(rows, pw, channels, depth)
    return img, colour, depth, extra


def _significant(gamma: int) -> bool:
    return abs(gamma - 100000) > 5000           # libpng's png_gamma_significant


def _reciprocal(a: int, b: int = 1) -> int:
    """libpng's png_reciprocal (b = 1: 1e10 / a) and png_reciprocal2 (1e15 / a / b)."""
    return int(math.floor((1e10 / a if b == 1 else 1e15 / a / b) + 0.5))


def _table(size: int, top: int, gamma: int) -> np.ndarray:
    """libpng's gamma table: floor(top * (i / (size - 1)) ** (gamma / 1e5) + .5)."""
    i = np.arange(size, dtype=np.float64)
    return np.floor(top * np.power(i / (size - 1), gamma * 1e-5) + 0.5).astype(np.int64)


def _rgb_to_grey(rgb: np.ndarray, gamma, sbit) -> np.ndarray:
    """libpng's ``png_set_rgb_to_gray(1, 0.299, 0.587)`` and then 8 bits, as
    cv2's grey read of a colour PNG runs it.  Without a significant file
    gamma: the weighted sum, truncated (8-bit) or rounded and then ``>> 8``
    (16-bit).  With one (``gAMA``, ``sRGB``), each channel goes through
    libpng's gamma tables to linear light and the sum back; grey pixels
    (r = g = b) pass as they are (8-bit) or rounded to 8 bits (16-bit)."""
    r, g, b = (rgb[..., k].astype(np.int64) for k in range(3))
    wr, wg, wb = _GREY_WEIGHTS
    if gamma is None or not _significant(gamma):
        grey = wr * r + wg * g + wb * b
        if rgb.dtype == np.uint16:
            return ((grey + 16384) >> 23).astype(np.uint8)
        return (grey >> 15).astype(np.uint8)
    screen = _reciprocal(gamma)
    equal = (r == g) & (r == b)
    if rgb.dtype == np.uint8:
        to_1 = _table(256, 255, _reciprocal(gamma))
        from_1 = _table(256, 255, _reciprocal(screen))
        grey = from_1[(wr * to_1[r] + wg * to_1[g] + wb * to_1[b] + 16384) >> 15]
        return np.where(equal, r, grey).astype(np.uint8)
    # 16 bits: tables indexed by the top 16 - shift bits; shift >= 5 when
    # stripping to 8 bits (png_build_gamma_table)
    shift = 16 - sbit if sbit and 0 < sbit < 16 else 0
    shift = min(max(shift, 16 - 11), 8)
    size = 1 << (16 - shift)
    to_1 = _table(size, 65535, _reciprocal(gamma))
    from_1 = _table(size, 65535, _reciprocal(screen))
    grey16 = (wr * to_1[r >> shift] + wg * to_1[g >> shift] + wb * to_1[b >> shift] + 16384) >> 15
    grey = from_1[grey16 >> shift] >> 8
    # grey pixels: png_build_16to8_table, the 8-bit value nearest in the
    # overall gamma (png_reciprocal2(gamma, screen))
    overall = _reciprocal(gamma, screen)
    out = np.arange(255, dtype=np.int64)
    bound = (out * 257 + 128) if not _significant(overall) else np.floor(
        65535 * np.power((out * 257 + 128) / 65535, overall * 1e-5) + 0.5).astype(np.int64)
    bound = (bound * (size - 1) + 32768) // 65535 + 1
    plain = np.searchsorted(bound, (r >> shift), side="right")
    return np.where(equal, plain, grey).astype(np.uint8)


def _to_8bit(img: np.ndarray) -> np.ndarray:
    return (img >> 8).astype(np.uint8) if img.dtype == np.uint16 else img


def _trns_alpha(img, colour, depth, trns):
    """Alpha of an RGB image from its tRNS colour (0 where equal, else the
    maximum); None without one."""
    if trns is None or colour != 2 or len(trns) < 6:
        return None
    key = np.frombuffer(trns[:6], ">u2").astype(img.dtype)
    top = 0xFFFF if depth == 16 else 0xFF
    return np.where((img == key).all(-1), 0, top).astype(img.dtype)


def _decode(data: bytes, flag: str) -> np.ndarray:
    """PNG bytes -> the array cv2's ``imdecode`` gives for ``flag``."""
    if flag not in _FLAGS:
        raise ValueError(f"flag {flag!r} is not one of {_FLAGS}")
    img, colour, depth, extra = _samples(data)
    trns = extra["trns"]
    if colour == 0 and depth < 8:                  # libpng's expand_gray_1_2_4_to_8
        img = img * np.uint8(255 // ((1 << depth) - 1))
    if colour == 3:
        index = img[..., 0]
        alpha = None
        if flag == "unchanged" and trns:
            table = np.full(256, 255, np.uint8)
            entries = np.frombuffer(trns, np.uint8)[:256]
            table[:len(entries)] = entries
            alpha = table[index][..., None]
        img = extra["palette"][index]
        if alpha is not None:
            img = np.concatenate([img, alpha], axis=-1)
        colour = 2 if alpha is None else 6

    if flag == "grayscale":
        if colour in (0, 4):
            return _to_8bit(img[..., 0])
        return _rgb_to_grey(img[..., :3], extra["gamma"], extra["sbit"])

    if flag == "color":
        img = _to_8bit(img)
        if colour in (0, 4):
            return np.repeat(img[..., :1], 3, axis=2)
        return img[..., 2::-1]

    if colour == 0:
        return img[..., 0]
    if colour == 4:
        return img[..., [0, 0, 0, 1]]
    alpha = _trns_alpha(img, colour, depth, trns)
    if alpha is not None:
        return np.concatenate([img[..., ::-1], alpha[..., None]], axis=-1)
    return img[..., [2, 1, 0, 3][:img.shape[2]]]


def imfrombytes(content: bytes, flag: str = "color", float32: bool = False,
                rgb: bool = False) -> np.ndarray:
    """Decode PNG bytes as cv2's ``imdecode`` does (BGR by default;
    ``rgb=True`` flips a 3-channel result).  ``flag`` is ``color``,
    ``grayscale`` or ``unchanged``; ``float32`` divides by 255."""
    img = _decode(content, flag)
    if rgb and img.ndim == 3 and img.shape[2] == 3:
        img = img[..., ::-1]
    if float32:
        img = img.astype(np.float32)
        img /= np.float32(255.0)
    img = np.ascontiguousarray(img)
    return img if img.flags.writeable else img.copy()    # not a view of the file's bytes


def png_decode(data: bytes) -> np.ndarray:
    """PNG bytes -> ``(h, w, 3)`` uint8 RGB: the colour read, in RGB."""
    return imfrombytes(data, "color", rgb=True)


def png_size(path: str):
    """``(height, width)`` of a PNG file, from its header alone."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    width, height = struct.unpack(">II", head[16:24])
    return height, width


def unit_float(img: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [0, 1], as ``imread(..., float32=True)`` does."""
    out = img.astype(np.float32)
    out /= np.float32(255.0)
    return out


def imread(path: str, float32: bool = True, rgb: bool = True) -> np.ndarray:
    """Read a PNG as HWC float32 RGB in [0, 1] (the network input
    convention); ``rgb=False`` gives BGR, ``float32=False`` uint8."""
    with open(path, "rb") as f:
        return imfrombytes(f.read(), float32=float32, rgb=rgb)


# --- encoding -------------------------------------------------------------

def _filter_rows(rows: np.ndarray, bpp: int, kind: int) -> np.ndarray:
    """One PNG filter applied to every row of ``(h, stride)`` bytes, taken
    from the original bytes, so no loop is needed."""
    if kind == 0:
        return rows
    out = np.empty_like(rows)
    if kind == 1:
        out[:, :bpp] = rows[:, :bpp]
        np.subtract(rows[:, bpp:], rows[:, :-bpp], out=out[:, bpp:])
        return out
    if kind == 2:
        out[:1] = rows[:1]
        np.subtract(rows[1:], rows[:-1], out=out[1:])
        return out
    x = rows.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    if kind == 3:
        pred = (left + up) >> 1
    elif kind == 4:
        upleft = np.zeros_like(x)
        upleft[1:, bpp:] = x[:-1, :-bpp]
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    else:
        raise ValueError(f"PNG row filter {kind} is not 0-4")
    np.subtract(x, pred, out=x)
    return x.astype(np.uint8)     # modulo 256


def _filtered(px: np.ndarray, filter) -> np.ndarray:
    """``(h, 1 + stride)``: each row's filter byte, then its filtered bytes,
    from ``px``, the ``(h, w, bpp)`` bytes of each pixel (any strides: a
    channel-reversed view is read as it is).  Filters 0-2 write straight into
    the scanlines; ``filter="adaptive"`` picks, row by row, the filter whose
    bytes have the least sum of absolute values as signed bytes (libpng's
    heuristic)."""
    h, w, bpp = px.shape
    out = np.empty((h, 1 + w * bpp), np.uint8)
    body = np.ndarray((h, w, bpp), np.uint8, out, offset=1, strides=(out.strides[0], bpp, 1))
    if filter == 0:
        out[:, 0] = 0
        body[...] = px
    elif filter == 1:
        out[:, 0] = 1
        body[:, :1] = px[:, :1]
        np.subtract(px[:, 1:], px[:, :-1], out=body[:, 1:])
    elif filter == 2:
        out[:, 0] = 2
        body[:1] = px[:1]
        np.subtract(px[1:], px[:-1], out=body[1:])
    else:
        rows = np.ascontiguousarray(px).reshape(h, -1)
        kinds = [filter] if filter != "adaptive" else range(5)
        cands = [_filter_rows(rows, bpp, k) for k in kinds]
        cost = [np.minimum(c, 256 - c.astype(np.int32)).sum(1) for c in cands]
        pick = np.argmin(np.stack(cost), axis=0)
        out[:, 0] = np.asarray(list(kinds), np.uint8)[pick]
        for k, cand in enumerate(cands):
            out[pick == k, 1:] = cand[pick == k]
    return out


def _chunk(kind: bytes, body) -> list:
    return [struct.pack(">I", len(body)), kind, body,
            struct.pack(">I", zlib.crc32(body, zlib.crc32(kind)))]


def png_scanlines(img: np.ndarray, filter=0, interlace: bool = False):
    """The IHDR fields and the filtered scanlines (one buffer) of a PNG of
    ``img``: uint8 or uint16, ``(h, w)`` or ``(h, w, c)`` with c in 1-4, in
    PNG channel order (grey, grey-alpha, RGB, RGBA)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"PNG writer takes uint8 or uint16, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or not 1 <= img.shape[2] <= 4:
        raise ValueError(f"PNG writer takes (h, w) or (h, w, 1-4), got {img.shape}")
    if filter != "adaptive" and filter not in range(5):
        raise ValueError(f"PNG row filter {filter!r} is not 0-4 or 'adaptive'")
    height, width, channels = img.shape
    depth = 16 if img.dtype == np.uint16 else 8
    colour = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    bpp = channels * depth // 8
    parts = []
    for y0, x0, dy, dx in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = img[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        if depth == 16:
            sub = np.ascontiguousarray(sub, ">u2").view(np.uint8)
        parts.append(_filtered(sub, filter))
    lines = parts[0] if len(parts) == 1 else np.concatenate([p.reshape(-1) for p in parts])
    header = struct.pack(">IIBBBBB", width, height, depth, colour, 0, 0, int(interlace))
    return header, lines


def png_deflate(lines: np.ndarray, compress_level: int = 1,
                strategy: int = zlib.Z_DEFAULT_STRATEGY) -> bytes:
    """zlib stream of the scanlines at ``compress_level``."""
    z = zlib.compressobj(compress_level, zlib.DEFLATED, zlib.MAX_WBITS, 8, strategy)
    return z.compress(lines) + z.flush()


def png_chunks(header: bytes, idat: bytes) -> bytes:
    """The PNG file: signature, IHDR, one IDAT, IEND, each with its CRC."""
    return b"".join([_SIGNATURE, *_chunk(b"IHDR", header), *_chunk(b"IDAT", idat),
                     *_chunk(b"IEND", b"")])


def png_encode(img: np.ndarray, compress_level: int = 1, filter=0, interlace: bool = False,
               strategy: int = zlib.Z_DEFAULT_STRATEGY) -> bytes:
    """8- or 16-bit, 1-4 channel image (PNG channel order) -> PNG bytes.
    ``filter``: a row filter 0-4 for every row, or ``"adaptive"``;
    ``interlace``: Adam7; ``strategy``: zlib's."""
    header, lines = png_scanlines(img, filter, interlace)
    return png_chunks(header, png_deflate(lines, compress_level, strategy))


def png_order(img) -> np.ndarray:
    """cv2's channel order (grey, BGR, BGRA) -> PNG's (grey, RGB, RGBA), as
    a host array.  A torch tensor is reordered where it lies (on the card,
    no host pass over the pixels) and then copied to the host."""
    if isinstance(img, torch.Tensor):
        if img.dim() == 3 and img.shape[2] in (3, 4):
            img = img[..., [2, 1, 0, 3][:img.shape[2]]]
        return img.cpu().numpy()
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] in (3, 4):
        return img[..., [2, 1, 0, 3][:img.shape[2]]]
    return img


def imencode_png(img, compress_level: int = 1, filter=0,
                 strategy: int = zlib.Z_DEFAULT_STRATEGY) -> bytes:
    """A cv2-ordered image (grey, BGR, BGRA; uint8 or uint16; numpy or a
    torch tensor) -> PNG bytes, as ``cv2.imencode('.png', img)`` takes it."""
    return png_encode(png_order(img), compress_level, filter, strategy=strategy)


def imwrite(img, file_path: str, auto_mkdir: bool = True) -> bool:
    """Write a uint8 BGR (as ``tensor2img`` returns it, cv2's order) or
    grey image as PNG, as ``cv2.imwrite`` does with no parameters: level 1,
    the Sub filter, zlib's RLE strategy.  ``img`` may be a torch tensor on
    the card: its channels are reordered there."""
    if not file_path.lower().endswith(".png"):
        raise ValueError(f"only PNG is written, got {file_path!r}")
    if auto_mkdir:
        os.makedirs(os.path.dirname(os.path.abspath(file_path)), exist_ok=True)
    data = imencode_png(img, 1, filter=1, strategy=zlib.Z_RLE)
    with open(file_path, "wb") as f:
        f.write(data)
    return True


def tensor2img(arr, rgb2bgr: bool = True, min_max=(0, 1)):
    """(..., H, W, C) float RGB in [0, 1] -> HWC uint8 [0, 255] BGR, matching
    the reference ``tensor2img``: clip, scale, x255 in float32, round half
    to even (torch's ``round``).  A torch tensor stays on its device and
    gives a uint8 tensor; a numpy array gives a numpy array."""
    img = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.asarray(arr, np.float32))
    img = img.float().clamp(min_max[0], min_max[1])
    img = (img - min_max[0]) / (min_max[1] - min_max[0])
    if rgb2bgr and img.dim() == 3 and img.shape[2] == 3:
        img = img.flip(-1)
    out = (img * 255.0).round().to(torch.uint8)
    return out if isinstance(arr, torch.Tensor) else out.numpy()


def padding(img_lq: np.ndarray, img_gt: np.ndarray, gt_size: int):
    """Pad both images at the bottom and right up to ``gt_size`` with cv2's
    ``BORDER_REFLECT`` (edge pixel repeated: numpy's ``symmetric``)."""
    h, w = img_lq.shape[:2]
    h_pad, w_pad = max(0, gt_size - h), max(0, gt_size - w)
    if h_pad == 0 and w_pad == 0:
        return img_lq, img_gt

    def pad(img):
        widths = [(0, h_pad), (0, w_pad)] + [(0, 0)] * (img.ndim - 2)
        return np.pad(img, widths, mode="symmetric")

    return pad(img_lq), pad(img_gt)
