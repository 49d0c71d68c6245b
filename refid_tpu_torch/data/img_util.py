"""Host-side image IO (mirrors ``refid_tpu/data/img_util.py``) without cv2.

Images are HWC float32 RGB in [0, 1] end to end, as in the JAX package.
PNG is read and written with ``zlib`` and numpy: 8-bit grey, RGB or RGBA
(alpha dropped, grey repeated to three channels, as cv2's colour read
does), non-interlaced, every row filter (0-4) on read.  Rows are written
with filter 0, so the port's own files decode with no per-pixel work;
filters 3 (average) and 4 (Paeth) are sequential along a row and decode
in a Python loop.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

__all__ = ["imread", "imwrite", "tensor2img", "png_decode", "png_encode"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}     # PNG colour type -> samples per pixel


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if zlib.crc32(kind + body) != struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        pos += 12 + length


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


def png_decode(data: bytes) -> np.ndarray:
    """8-bit PNG bytes -> ``(h, w, 3)`` uint8 RGB (grey repeated, alpha
    dropped)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise NotImplementedError(
            f"PNG bit depth {depth}, colour type {colour}, interlace "
            f"{interlace}: only 8-bit non-interlaced grey/RGB/RGBA is read")
    bpp = _CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (width * bpp + 1):
        raise ValueError("PNG image data has the wrong size")
    img = _unfilter(raw, height, width * bpp, bpp).reshape(height, width, bpp)
    if bpp == 1:
        return np.repeat(img, 3, axis=2)
    return img[..., :3]


def png_encode(img: np.ndarray) -> bytes:
    """``(h, w, 3)`` RGB or ``(h, w)`` grey uint8 -> PNG bytes (filter 0)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"PNG writer takes uint8, got {img.dtype}")
    if img.ndim == 2:
        colour = 0
        img = img[..., None]
    elif img.ndim == 3 and img.shape[2] == 3:
        colour = 2
    else:
        raise ValueError(f"PNG writer takes (h, w) or (h, w, 3), got {img.shape}")
    height, width = img.shape[:2]
    rows = np.zeros((height, 1 + width * img.shape[2]), np.uint8)
    rows[:, 1:] = img.reshape(height, -1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    header = struct.pack(">IIBBBBB", width, height, 8, colour, 0, 0, 0)
    return (_SIGNATURE + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))   # fastest level
            + chunk(b"IEND", b""))


def imread(path: str, float32: bool = True, rgb: bool = True) -> np.ndarray:
    """Read a PNG as HWC float32 RGB in [0, 1] (the network input
    convention); ``rgb=False`` gives BGR, ``float32=False`` uint8."""
    with open(path, "rb") as f:
        img = png_decode(f.read())
    if not rgb:
        img = img[..., ::-1]
    if float32:
        img = img.astype(np.float32) / 255.0
    return np.ascontiguousarray(img)


def imwrite(img: np.ndarray, file_path: str, auto_mkdir: bool = True) -> bool:
    """Write a uint8 BGR (as ``tensor2img`` returns it, cv2's order) or
    grey image as PNG."""
    if not file_path.lower().endswith(".png"):
        raise ValueError(f"only PNG is written, got {file_path!r}")
    if auto_mkdir:
        os.makedirs(os.path.dirname(os.path.abspath(file_path)), exist_ok=True)
    img = np.asarray(img)
    if img.ndim == 3:
        img = img[..., ::-1]
    with open(file_path, "wb") as f:
        f.write(png_encode(img))
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
