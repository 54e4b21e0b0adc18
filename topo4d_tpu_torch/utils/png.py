"""An 8-bit RGB PNG writer on ``zlib`` and ``struct`` alone.

The JAX package writes its textures through PIL (``pipeline/export.py``);
this package must not need it. One IDAT chunk, filter type 0 (none) on
every row, deflate at ``level`` (6, PIL's default).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """(H, W, 3) uint8 -> the bytes of a PNG file."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) uint8 image, got {img.dtype} {img.shape}")
    h, w, _ = img.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)  # column 0: each row's filter byte
    raw[:, 1:] = img.reshape(h, 3 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB, deflate, no interlace
    return (
        SIGNATURE
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(raw.data, level=level))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    with open(path, "wb") as fh:
        fh.write(encode_png(img, level=level))
