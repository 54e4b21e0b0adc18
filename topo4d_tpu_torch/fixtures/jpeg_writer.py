"""A small baseline JPEG writer in NumPy, for fixtures that PIL cannot write.

PIL's encoder writes chroma sampling 4:4:4, 4:2:2 and 4:2:0 only (its
"4:1:1" writes 4:2:0) and always codes three components as YCbCr (or RGB
behind an Adobe marker with ``keep_rgb``). ``encode_baseline`` writes a
sequential Huffman file (SOF0) at any sampling factors 1-4, with the
component ids, JFIF and Adobe APP14 markers and restart interval asked
for: a float DCT, the quality-scaled tables of JPEG Annex K (K.1, K.2) and
its typical Huffman tables (K.3). The file only has to be valid; what a
test holds the port's decoder to is PIL's decode of it.
"""

from __future__ import annotations

import struct
from typing import Optional, Sequence, Tuple

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])

# Annex K.1 and K.2, natural order
LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
])
CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
] + [99] * 32)

# Annex K.3: (code counts of lengths 1-16, values)
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
    0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
    0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
    0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
])
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
    0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
    0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
    0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
    0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
])

_u = np.arange(8)
DCT = np.sqrt(2.0 / 8.0) * np.cos((2 * _u[None, :] + 1) * _u[:, None] * np.pi / 16)
DCT[0] /= np.sqrt(2.0)


def _codes(table) -> dict:
    """value -> (code, length) of a (counts, values) Huffman table."""
    counts, values = table
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out[values[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


def _quant(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's quality scaling of an Annex K table (jcparam.c)."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


class _Bits:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, code: int, length: int) -> None:
        self.acc = (self.acc << length) | code
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)  # byte stuffing
        self.acc &= (1 << self.n) - 1

    def flush(self) -> None:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)  # pad with 1 bits


def _magnitude(v: int) -> Tuple[int, int]:
    """(category, bits) of a coefficient difference (F.1.2.1)."""
    s = int(abs(v)).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def encode_baseline(
    img: np.ndarray,
    sampling: Sequence[Tuple[int, int]] = ((2, 2), (1, 1), (1, 1)),
    quality: int = 85,
    ids: Optional[Sequence[int]] = None,
    ycbcr: bool = True,
    jfif: bool = True,
    adobe_transform: Optional[int] = None,
    restart: int = 0,
) -> bytes:
    """(H, W, 3) or (H, W) uint8 -> the bytes of a baseline JPEG.

    ``sampling`` gives each component's (h, v) factors; ``ids`` its
    component ids (default 1, 2, 3); ``ycbcr`` converts RGB to YCbCr first
    (JFIF's equations), else the channels are coded as they are;
    ``jfif`` writes a JFIF APP0 marker and ``adobe_transform`` an Adobe APP14
    marker with that transform; ``restart`` is the restart interval in MCUs
    (0: none). Each chroma component averages the pixels it covers.
    """
    img = np.asarray(img)
    planes = [img.astype(np.float64)] if img.ndim == 2 else [img[..., c].astype(np.float64) for c in range(3)]
    if img.ndim == 3 and ycbcr:
        r, g, b = planes
        planes = [
            0.299 * r + 0.587 * g + 0.114 * b,
            -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
            0.5 * r - 0.418688 * g - 0.081312 * b + 128,
        ]
    nc = len(planes)
    sampling = [(1, 1)] if nc == 1 else list(sampling)
    ids = list(ids) if ids is not None else list(range(1, nc + 1))
    h, w = img.shape[:2]
    hmax = max(f[0] for f in sampling)
    vmax = max(f[1] for f in sampling)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    qt = [_quant(LUMA_Q, quality), _quant(CHROMA_Q, quality)]
    tables = [(_codes(DC_LUMA), _codes(AC_LUMA)), (_codes(DC_CHROMA), _codes(AC_CHROMA))]

    blocks = []  # per component: (by, bx, 64) quantized coefficients in zigzag order
    for c, plane in enumerate(planes):
        fh, fv = sampling[c]
        rh, rv = hmax // fh, vmax // fv
        full = np.pad(plane, ((0, mcuy * 8 * vmax - h), (0, mcux * 8 * hmax - w)), mode="edge")
        ds = full.reshape(full.shape[0] // rv, rv, full.shape[1] // rh, rh).mean(axis=(1, 3)) - 128.0
        nby, nbx = ds.shape[0] // 8, ds.shape[1] // 8
        tiles = ds.reshape(nby, 8, nbx, 8).transpose(0, 2, 1, 3)
        coef = np.einsum("ux,abxy,vy->abuv", DCT, tiles, DCT).reshape(nby, nbx, 64)
        q = qt[min(c, 1)]
        blocks.append(np.rint(coef / q).astype(np.int64)[..., ZIGZAG])

    bits = _Bits()
    pred = [0] * nc
    total = mcux * mcuy
    for m in range(total):
        if restart and m and m % restart == 0:
            bits.flush()
            bits.out += bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
            pred = [0] * nc
        my, mx = divmod(m, mcux)
        for c in range(nc):
            fh, fv = sampling[c] if nc > 1 else (1, 1)
            dc_codes, ac_codes = tables[min(c, 1)]
            for v in range(fv):
                for u in range(fh):
                    blk = blocks[c][my * fv + v, mx * fh + u]
                    s, val = _magnitude(int(blk[0]) - pred[c])
                    pred[c] = int(blk[0])
                    bits.put(*dc_codes[s])
                    if s:
                        bits.put(val, s)
                    run = 0
                    last = int(np.flatnonzero(blk[1:])[-1]) + 1 if blk[1:].any() else 0
                    for k in range(1, last + 1):
                        a = int(blk[k])
                        if a == 0:
                            run += 1
                            continue
                        while run > 15:
                            bits.put(*ac_codes[0xF0])
                            run -= 16
                        s, val = _magnitude(a)
                        bits.put(*ac_codes[(run << 4) | s])
                        bits.put(val, s)
                        run = 0
                    if last < 63:
                        bits.put(*ac_codes[0x00])
    bits.flush()

    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe_transform is not None:
        out += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe_transform))
    for t in range(min(nc, 2)):
        out += _segment(0xDB, bytes([t]) + bytes(int(x) for x in qt[t][ZIGZAG]))
    sof = struct.pack(">BHHB", 8, h, w, nc)
    for c in range(nc):
        fh, fv = sampling[c]
        sof += bytes([ids[c], (fh << 4) | fv, min(c, 1)])
    out += _segment(0xC0, sof)
    for t, (dc, ac) in enumerate([(DC_LUMA, AC_LUMA), (DC_CHROMA, AC_CHROMA)][: min(nc, 2)]):
        out += _segment(0xC4, bytes([t]) + bytes(dc[0]) + bytes(dc[1]))
        out += _segment(0xC4, bytes([0x10 | t]) + bytes(ac[0]) + bytes(ac[1]))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    sos = bytes([nc]) + b"".join(bytes([ids[c], (min(c, 1) << 4) | min(c, 1)]) for c in range(nc)) + b"\x00\x3f\x00"
    out += _segment(0xDA, sos) + bits.out + b"\xff\xd9"
    return bytes(out)
