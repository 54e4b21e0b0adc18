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

Damaged and cut-off files read, or raise, as PIL reads them:

- Huffman scans past their data (a marker, or the end of a cut file): the
  MCU that reads past it is decoded with zero bits, the MCUs after it are
  skipped up to the next restart that reads its marker (sequential blocks
  gray, progressive coefficients as earlier scans left them), and a
  progressive file smooths the rows past the last MCU its final scan decoded with
  the record from before that scan;
- a cut file raises where libjpeg, fed PIL's 64 KiB reads, would wait for
  data that never comes before its last row is out: a bit read past the
  end, a restart with no marker after it, its bit reader's look-ahead (up
  to 8 bytes) reaching the end before the last MCU, an arithmetic decoder
  wanting a byte past the end; a progressive file, or a sequential one of
  several scans, also without EOI;
- after a sequential file's one scan, the markers up to EOI (or the end)
  are read as PIL's ``jpeg_finish_decompress`` reads them: a reserved
  marker, a second frame header or scan, or a bad table raises;
- a code no Huffman table holds takes 17 bits (libjpeg's
  ``jpeg_huff_decode``), and a table is checked when a scan first uses it.
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
