"""A small PNG writer in NumPy and ``zlib``, for fixtures and tests of every
kind PNG allows: colour types 0 (gray), 2 (RGB), 3 (palette), 4
(gray+alpha) and 6 (RGBA) at each of their bit depths, with or without
Adam7 interlacing. PIL writes no interlaced PNG and no sub-byte gray; the
decoder is held to PIL's decode of what this writes.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

from topo4d_tpu_torch.utils.png import ADAM7, CHANNELS, DEPTHS, SIGNATURE
from topo4d_tpu_torch.utils.png import _chunk as chunk


def pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(H, W * C) integer samples -> (H, row bytes) uint8: big-endian at 16
    bits, packed from the high bit down below 8."""
    h, n = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, 2 * n)
    if depth == 8:
        return samples.astype(np.uint8)
    bits = ((samples[..., None].astype(np.uint8) >> np.arange(depth - 1, -1, -1, dtype=np.uint8)) & 1).reshape(h, -1)
    return np.packbits(bits, axis=1)


def filter_row(kind: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """The encoder's filter ``kind`` (0-4) of one row of bytes (PNG section 9.2)."""
    x = row.astype(np.int32)
    up = prev.astype(np.int32)
    left = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])[: x.size]
    upleft = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])[: x.size]
    if kind == 0:
        pred = np.zeros_like(x)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = up
    elif kind == 3:
        pred = (left + up) // 2
    else:
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    return ((x - pred) % 256).astype(np.uint8)


def _filtered(img: np.ndarray, depth: int, c: int, first_kind: int) -> bytes:
    """An image (or pass) as filtered rows, the filter type cycling 0-4 from
    ``first_kind``."""
    h, w = img.shape[:2]
    if h == 0 or w == 0:
        return b""
    rows = pack_rows(img.reshape(h, w * c), depth)
    bpp = max(1, c * depth // 8)
    prev = np.zeros(rows.shape[1], np.uint8)
    out = bytearray()
    for y in range(h):
        kind = (first_kind + y) % 5
        out += bytes([kind]) + filter_row(kind, rows[y], prev, bpp).tobytes()
        prev = rows[y]
    return bytes(out)


def encode_png_any(
    img: np.ndarray,
    depth: int,
    color_type: int,
    interlace: bool = False,
    palette: Optional[np.ndarray] = None,
    trns: Optional[bytes] = None,
    idat_chunks: int = 1,
) -> bytes:
    """(H, W) or (H, W, C) integer samples in [0, 2^depth) -> the bytes of a
    PNG of ``color_type`` at ``depth`` (palette indices for type 3, with
    ``palette`` (N, 3) uint8 as its PLTE, gray when None), Adam7 when
    ``interlace``; ``trns`` is written as a tRNS chunk; the deflate stream
    is split over ``idat_chunks`` IDAT chunks."""
    if depth not in DEPTHS[color_type]:
        raise ValueError(f"bit depth {depth} is not allowed for color type {color_type}")
    c = CHANNELS[color_type]
    img = np.asarray(img).reshape(img.shape[0], img.shape[1], c)
    h, w = img.shape[:2]
    if interlace:
        raw = b"".join(
            _filtered(img[y0::dy, x0::dx], depth, c, p) for p, (x0, y0, dx, dy) in enumerate(ADAM7)
        )
    else:
        raw = _filtered(img, depth, c, 0)
    z = zlib.compress(raw, 9)
    cut = np.linspace(0, len(z), idat_chunks + 1).astype(int)
    out = SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, int(interlace)))
    if color_type == 3:
        if palette is None:
            palette = np.repeat(np.linspace(0, 255, 1 << depth).astype(np.uint8)[:, None], 3, axis=1)
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    out += b"".join(chunk(b"IDAT", z[a:b]) for a, b in zip(cut[:-1], cut[1:]))
    return out + chunk(b"IEND", b"")
