"""A baseline JPEG reader: the C decoder of ``csrc/imgdec.c``.

``decode_jpeg`` returns what ``np.asarray(PIL.Image.open(f))`` returns for
the JPEGs it reads, bit for bit: (H, W, 3) uint8 for YCbCr, (H, W) for
gray, decoded as libjpeg-turbo decodes at its defaults (islow IDCT, fancy
upsampling, its integer color tables). It reads sequential Huffman files
with 8-bit samples, 1 or 3 components, sampling 4:4:4, 4:2:2 or 4:2:0 and
restart markers. Progressive, arithmetic-coded, lossless and 12-bit files,
CMYK and Adobe-marked files and other sampling raise ``ValueError``, naming
the file.
"""

from __future__ import annotations

import ctypes

import numpy as np

from topo4d_tpu_torch import native

SOI = b"\xff\xd8"


def _call(fn, buf: bytes, out, name: str) -> None:
    err = ctypes.create_string_buffer(256)
    if fn(buf, len(buf), out, err, len(err)) != 0:
        raise ValueError(f"{name}: {err.value.decode('latin-1')}")


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The bytes of a JPEG file -> (H, W, 3) or (H, W) uint8. ``name``
    labels the errors."""
    lib = native.library()
    hwc = np.zeros(3, np.int32)
    _call(lib.jpeg_info, data, hwc.ctypes.data, name)
    h, w, c = (int(v) for v in hwc)
    out = np.empty((h, w, c) if c > 1 else (h, w), np.uint8)
    _call(lib.jpeg_decode, data, out.ctypes.data, name)
    return out


def read_jpeg(path: str) -> np.ndarray:
    """``decode_jpeg`` of the file at ``path``."""
    with open(path, "rb") as fh:
        return decode_jpeg(fh.read(), path)
