"""A JPEG reader: the C decoder of ``csrc/imgdec.c``.

``decode_jpeg`` returns what ``np.asarray(PIL.Image.open(f))`` returns for
the JPEGs it reads, bit for bit: (H, W, 3) uint8 for three components,
(H, W) for gray, decoded as libjpeg-turbo decodes at its defaults on x86-64
(the islow IDCT of its SIMD code, the upsampler it picks, its colour-space
choice and integer colour tables). It reads sequential and progressive
files, Huffman-coded or arithmetic-coded (SOF9/SOF10, DAC conditioning),
with 8-bit samples, 1 or 3 components coded as YCbCr or RGB (JFIF, Adobe
APP14 or 'R', 'G', 'B' component ids), any sampling factors whose ratios
are whole, and restart markers; progressive files whose scans leave bits
of coefficients 1-9 unsent are smoothed as libjpeg-turbo's block smoothing
does. Lossless, hierarchical and 12-bit files, 2 components, DNL-sized
frames, fractional sampling, MCUs of more than 10 blocks and bad DAC
segments, on which PIL fails too, and CMYK/YCCK (4 components, which PIL
reads as four channels) raise ``ValueError``, naming the file. Unlike PIL,
which reads a file in 64 KiB blocks that libjpeg's arithmetic decoder
cannot wait on, it reads arithmetic-coded files of any size.
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
