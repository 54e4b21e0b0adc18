"""A small JPEG writer in NumPy, for fixtures that PIL cannot write.

PIL's encoder writes chroma sampling 4:4:4, 4:2:2 and 4:2:0 only (its
"4:1:1" writes 4:2:0), always codes three components as YCbCr (or RGB
behind an Adobe marker with ``keep_rgb``), writes progressive files only
under libjpeg's ``jpeg_simple_progression`` script and never codes
arithmetically. ``encode_baseline`` writes a sequential Huffman file (SOF0)
at any sampling factors 1-4, with the component ids, JFIF and Adobe APP14
markers and restart interval asked for: a float DCT, the quality-scaled
tables of JPEG Annex K (K.1, K.2) and its typical Huffman tables (K.3).
``encode_scans`` writes the same coefficients as a progressive Huffman file
(SOF2) under any scan script, or arithmetic-coded (T.81 Annex D, the coder
of libjpeg's jcarith.c): sequential (SOF9) or progressive (SOF10), with a
DAC segment when the conditioning values are not the defaults. The files
only have to be valid; what a test holds the port's decoder to is PIL's
decode of them.
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


def _prepare(img, sampling, quality: int, ycbcr: bool, gray_factors: bool):
    """The quantized coefficients of ``img``: (components, their sampling
    factors, hmax, vmax, MCUs across, MCUs down, the two quantization
    tables, per component its (blocks down, blocks across, 64) coefficients
    in zigzag order over whole MCUs). A gray image takes (1, 1), or with
    ``gray_factors`` the one pair ``sampling`` gives."""
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
    sampling = ([tuple(sampling[0])] if gray_factors else [(1, 1)]) if nc == 1 else [tuple(f) for f in sampling]
    h, w = img.shape[:2]
    hmax = max(f[0] for f in sampling)
    vmax = max(f[1] for f in sampling)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    qt = [_quant(LUMA_Q, quality), _quant(CHROMA_Q, quality)]

    blocks = []
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
    return nc, sampling, hmax, vmax, mcux, mcuy, qt, blocks


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
    nc, sampling, hmax, vmax, mcux, mcuy, qt, blocks = _prepare(img, sampling, quality, ycbcr, gray_factors=False)
    ids = list(ids) if ids is not None else list(range(1, nc + 1))
    h, w = img.shape[:2]
    tables = [(_codes(DC_LUMA), _codes(AC_LUMA)), (_codes(DC_CHROMA), _codes(AC_CHROMA))]

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

    out = _frame(0xC0, h, w, sampling, ids, qt, jfif, adobe_transform, restart, huffman=True)
    sos = bytes([nc]) + b"".join(bytes([ids[c], (min(c, 1) << 4) | min(c, 1)]) for c in range(nc)) + b"\x00\x3f\x00"
    out += _segment(0xDA, sos) + bits.out + b"\xff\xd9"
    return bytes(out)


def _frame(sof: int, h: int, w: int, sampling, ids, qt, jfif: bool, adobe_transform: Optional[int], restart: int,
           huffman: bool, dac: bytes = b"") -> bytearray:
    """SOI and the segments before the first scan: JFIF, Adobe, the
    quantization tables, the frame header ``sof``, the Annex K Huffman
    tables (``huffman``) or the DAC body ``dac`` (when not empty), the
    restart interval. Component c takes tables min(c, 1)."""
    nc = len(sampling)
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe_transform is not None:
        out += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe_transform))
    for t in range(min(nc, 2)):
        out += _segment(0xDB, bytes([t]) + bytes(int(x) for x in qt[t][ZIGZAG]))
    body = struct.pack(">BHHB", 8, h, w, nc)
    for c in range(nc):
        fh, fv = sampling[c]
        body += bytes([ids[c], (fh << 4) | fv, min(c, 1)])
    out += _segment(sof, body)
    if huffman:
        for t, (dc, ac) in enumerate([(DC_LUMA, AC_LUMA), (DC_CHROMA, AC_CHROMA)][: min(nc, 2)]):
            out += _segment(0xC4, bytes([t]) + bytes(dc[0]) + bytes(dc[1]))
            out += _segment(0xC4, bytes([0x10 | t]) + bytes(ac[0]) + bytes(ac[1]))
    if dac:
        out += _segment(0xCC, dac)
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    return out


# T.81 Table D.2: (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS); entry 113
# is libjpeg's fixed estimate 0.5 (the sign bit and DC refinements)
QE_TABLE = [
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080B, 18, 4, 0), (0x03D8, 20, 5, 0),
    (0x01DA, 23, 6, 0), (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0), (0x0036, 30, 9, 0), (0x001A, 33, 10, 0),
    (0x000D, 35, 11, 0), (0x0006, 9, 12, 0), (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1),
    (0x3F25, 36, 16, 0), (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0), (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0CEF, 43, 21, 0), (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0), (0x0406, 49, 25, 0),
    (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01B1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0),
    (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0), (0x0068, 62, 33, 0), (0x004E, 63, 34, 0), (0x003B, 32, 35, 0),
    (0x002C, 33, 9, 0), (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0), (0x2EF1, 67, 40, 0),
    (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0), (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0), (0x0861, 78, 49, 0), (0x0706, 79, 50, 0),
    (0x05CD, 48, 51, 0), (0x04DE, 50, 52, 0), (0x040F, 50, 53, 0), (0x0363, 51, 54, 0), (0x02D4, 52, 55, 0),
    (0x025C, 53, 56, 0), (0x01F8, 54, 57, 0), (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0), (0x008F, 61, 32, 0), (0x5B12, 65, 65, 1),
    (0x4D04, 80, 66, 0), (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0), (0x2FE8, 83, 69, 0), (0x293C, 84, 70, 0),
    (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0), (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119C, 74, 76, 0), (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0), (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0), (0x34EE, 91, 85, 0),
    (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0), (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0),
    (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0), (0x3824, 99, 93, 0), (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0),
    (0x56A8, 95, 96, 1), (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0), (0x3C3D, 104, 100, 0),
    (0x375E, 99, 93, 0), (0x5231, 105, 102, 0), (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0), (0x415E, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0), (0x5597, 110, 109, 0), (0x504F, 111, 107, 0),
    (0x5A10, 110, 111, 1), (0x5522, 112, 109, 0), (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0),
]
# each state: (Qe, the state byte after an LPS, the state byte after an MPS),
# the MPS sense in bit 7 flipped by Switch_MPS
_QE = [(qe, (sw << 7) | lps, mps) for qe, lps, mps, sw in QE_TABLE]


class _Arith:
    """The Annex D encoder as libjpeg's jcarith.c writes it: C and A
    registers, a byte buffer with its stacked 0xFF bytes (sc) and zero
    bytes (zc) waiting on a carry, stuffing after each 0xFF."""

    def __init__(self):
        self.out = bytearray()
        self.start()

    def start(self) -> None:
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _zeros(self) -> None:
        self.out += bytes(self.zc)
        self.zc = 0

    def _carry(self) -> None:
        """The buffered byte plus a carry (the stacked 0xFF bytes become 0x00)."""
        if self.buffer >= 0:
            self._zeros()
            self.out.append(self.buffer + 1)
            if self.buffer + 1 == 0xFF:
                self.out.append(0)
        self.zc += self.sc
        self.sc = 0

    def _settle(self) -> None:
        """The buffered byte and the stacked 0xFF bytes, which no carry can reach."""
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._zeros()
            self.out.append(self.buffer)
        if self.sc:
            self._zeros()
            self.out += b"\xff\x00" * self.sc
            self.sc = 0

    def code(self, stats: bytearray, i: int, val: int) -> None:
        """Encode the decision ``val`` in bin ``stats[i]`` (D.1.4-D.1.6)."""
        sv = stats[i]
        qe, after_lps, after_mps = _QE[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ after_lps
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ after_mps
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._carry()
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._settle()
                    self.buffer = temp
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                return

    def finish(self) -> None:
        """D.1.8: the shortest tail that ends inside the interval."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            self._carry()
        else:
            self._settle()
        if self.c & 0x7FFF800:
            self._zeros()
            for shift, mask in ((19, 0x7FFF800), (11, 0x7F800)):
                if self.c & mask:
                    byte = (self.c >> shift) & 0xFF
                    self.out.append(byte)
                    if byte == 0xFF:
                        self.out.append(0)
        self.zc = 0


def _point(v: int, al: int) -> int:
    """An AC coefficient's point transform: |v| >> al with v's sign."""
    return v >> al if v >= 0 else -((-v) >> al)


def _arith_dc(enc: _Arith, st: bytearray, ctx: int, v: int, cond) -> int:
    """A DC difference v in the bins of ``st`` from context ``ctx``
    (F.1.4.1, Figures F.4 and F.6-F.9) -> the next context."""
    if v == 0:
        enc.code(st, ctx, 0)
        return 0
    enc.code(st, ctx, 1)
    nxt = 4 if v > 0 else 8
    enc.code(st, ctx + 1, v < 0)
    i = ctx + (2 if v > 0 else 3)
    v = abs(v) - 1
    m = 0
    if v:
        enc.code(st, i, 1)
        m, v2, i = 1, v >> 1, 20
        while v2:
            enc.code(st, i, 1)
            m, v2, i = m << 1, v2 >> 1, i + 1
    enc.code(st, i, 0)
    low, up, _ = cond
    if m < (1 << low) >> 1:
        nxt = 0
    elif m > (1 << up) >> 1:
        nxt += 8
    i += 14
    m >>= 1
    while m:
        enc.code(st, i, 1 if m & v else 0)
        m >>= 1
    return nxt


def _arith_ac(enc: _Arith, st: bytearray, fixed: bytearray, blk, ss: int, se: int, al: int, kx: int) -> None:
    """AC coefficients ss..se of a zigzag block, point-transformed by al
    (F.1.4.2, Figures F.5 and F.8-F.9; G.1.3.2)."""
    vals = [_point(int(x), al) for x in blk]
    ke = se
    while ke > 0 and vals[ke] == 0:
        ke -= 1
    k = ss
    while k <= ke:
        i = 3 * (k - 1)
        enc.code(st, i, 0)
        while vals[k] == 0:
            enc.code(st, i + 1, 0)
            i += 3
            k += 1
        v = vals[k]
        enc.code(st, i + 1, 1)
        enc.code(fixed, 0, v < 0)
        i += 2
        v = abs(v) - 1
        m = 0
        if v:
            enc.code(st, i, 1)
            m, v2 = 1, v >> 1
            if v2:
                enc.code(st, i, 1)
                m, v2, i = 2, v2 >> 1, 189 if k <= kx else 217
                while v2:
                    enc.code(st, i, 1)
                    m, v2, i = m << 1, v2 >> 1, i + 1
        enc.code(st, i, 0)
        i += 14
        m >>= 1
        while m:
            enc.code(st, i, 1 if m & v else 0)
            m >>= 1
        k += 1
    if k <= se:
        enc.code(st, 3 * (k - 1), 1)


def _arith_ac_refine(enc: _Arith, st: bytearray, fixed: bytearray, blk, ss: int, se: int, al: int) -> None:
    """Bit al of AC coefficients ss..se (G.1.3.3, Figure G.10)."""
    vals = [abs(_point(int(x), al)) for x in blk]
    ke = se
    while ke > 0 and vals[ke] == 0:
        ke -= 1
    kex = ke
    while kex > 0 and vals[kex] >> 1 == 0:
        kex -= 1
    k = ss
    while k <= ke:
        i = 3 * (k - 1)
        if k > kex:
            enc.code(st, i, 0)
        while vals[k] == 0:
            enc.code(st, i + 1, 0)
            i += 3
            k += 1
        if vals[k] >> 1:
            enc.code(st, i + 2, vals[k] & 1)  # previously nonzero: its next bit
        else:
            enc.code(st, i + 1, 1)  # newly nonzero: its sign
            enc.code(fixed, 0, int(blk[k]) < 0)
        k += 1
    if k <= se:
        enc.code(st, 3 * (k - 1), 1)


def _huff_value(bits: _Bits, codes: dict, v: int, run: int = 0) -> None:
    """A (run, size) symbol and the value's bits (F.1.2)."""
    s, val = _magnitude(v)
    bits.put(*codes[(run << 4) | s])
    if s:
        bits.put(val, s)


def _huff_ac_first(bits: _Bits, codes: dict, blk, ss: int, se: int, al: int) -> None:
    """AC coefficients ss..se, point-transformed by al (G.1.2.2), each
    block ending in its own end of band (EOB0)."""
    run = 0
    for k in range(ss, se + 1):
        v = _point(int(blk[k]), al)
        if v == 0:
            run += 1
            continue
        while run > 15:
            bits.put(*codes[0xF0])
            run -= 16
        _huff_value(bits, codes, v, run)
        run = 0
    if run:
        bits.put(*codes[0x00])


def _huff_ac_refine(bits: _Bits, codes: dict, blk, ss: int, se: int, al: int) -> None:
    """Bit al of AC coefficients ss..se (G.1.2.3): newly nonzero ones as
    (run, 1) symbols with a sign bit, the correction bits of those already
    nonzero after the symbol that passes them, EOB0 for the rest."""
    absval = [abs(_point(int(x), al)) for x in blk]
    eob = max([k for k in range(ss, se + 1) if absval[k] == 1], default=-1)
    run, pending = 0, []
    for k in range(ss, se + 1):
        if absval[k] == 0:
            run += 1
            continue
        while run > 15 and k <= eob:
            bits.put(*codes[0xF0])
            run -= 16
            for b in pending:
                bits.put(b, 1)
            pending = []
        if absval[k] > 1:
            pending.append(absval[k] & 1)
            continue
        bits.put(*codes[(run << 4) | 1])
        bits.put(1 if int(blk[k]) > 0 else 0, 1)
        for b in pending:
            bits.put(b, 1)
        run, pending = 0, []
    if run or pending:
        bits.put(*codes[0x00])
        for b in pending:
            bits.put(b, 1)


def simple_progression(nc: int):
    """libjpeg's ``jpeg_simple_progression`` script (jcparam.c) for YCbCr
    or gray, as PIL writes progressive files: (components, Ss, Se, Ah, Al)
    per scan."""
    if nc == 3:
        return [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
                ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1), ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
                ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]
    each = [(c,) for c in range(nc)]
    return ([(tuple(range(nc)), 0, 0, 0, 1)] + [(c, 1, 5, 0, 2) for c in each] + [(c, 6, 63, 0, 2) for c in each]
            + [(c, 1, 63, 2, 1) for c in each] + [(tuple(range(nc)), 0, 0, 1, 0)] + [(c, 1, 63, 1, 0) for c in each])


DEFAULT_CONDITIONING = (0, 1, 5)  # DC L, DC U, AC Kx without a DAC segment (T.81 F.1.4.4)


def encode_scans(
    img: np.ndarray,
    sampling: Sequence[Tuple[int, int]] = ((2, 2), (1, 1), (1, 1)),
    quality: int = 85,
    arithmetic: bool = False,
    progressive: bool = True,
    scans=None,
    conditioning: Optional[Sequence[Tuple[int, int, int]]] = None,
    restart: int = 0,
) -> bytes:
    """(H, W, 3) or (H, W) uint8 -> a JPEG of ``encode_baseline``'s
    coefficients (three components as YCbCr): progressive Huffman (SOF2, the Annex K tables, every
    block ending in its own EOB0), or with ``arithmetic`` sequential (SOF9)
    or progressive (SOF10) arithmetic coding.

    ``scans`` is the progressive script, a list of (component indices,
    Ss, Se, Ah, Al); its default is ``simple_progression``. The script need
    not send every bit: the decoder smooths what is left out.
    ``conditioning`` gives the arithmetic (DC L, DC U, AC Kx) of table 0
    (luma) and table 1 (chroma); a DAC segment carries those that are not
    ``DEFAULT_CONDITIONING``. ``restart`` is the restart interval in MCUs of
    each scan. A gray image may declare its sampling factors as
    ``sampling[0]`` (the scans are its blocks either way).
    """
    img = np.asarray(img)
    nc, sampling, hmax, vmax, mcux, mcuy, qt, blocks = _prepare(img, sampling, quality, True, gray_factors=True)
    h, w = img.shape[:2]
    ids = list(range(1, nc + 1))
    if not progressive:
        scans = [(tuple(range(nc)), 0, 63, 0, 0)]
    elif scans is None:
        scans = simple_progression(nc)
    cond = [tuple(c) for c in (conditioning or [DEFAULT_CONDITIONING] * 2)]
    dac = b""
    if arithmetic:
        for t in range(min(nc, 2)):
            low, up, kx = cond[t]
            if (low, up) != DEFAULT_CONDITIONING[:2]:
                dac += bytes([t, (up << 4) | low])
            if kx != DEFAULT_CONDITIONING[2]:
                dac += bytes([16 + t, kx])
    sof = (0xCA if progressive else 0xC9) if arithmetic else 0xC2
    out = _frame(sof, h, w, sampling, ids, qt, jfif=True, adobe_transform=None, restart=restart,
                 huffman=not arithmetic, dac=dac)
    codes = [(_codes(DC_LUMA), _codes(AC_LUMA)), (_codes(DC_CHROMA), _codes(AC_CHROMA))]
    for comps, ss, se, ah, al in scans:
        comps = tuple(comps)
        sos = bytes([len(comps)]) + b"".join(bytes([ids[c], (min(c, 1) << 4) | min(c, 1)]) for c in comps)
        out += _segment(0xDA, sos + bytes([ss, se, (ah << 4) | al]))
        if len(comps) > 1:
            units = [(c, u, v) for c in comps for v in range(sampling[c][1]) for u in range(sampling[c][0])]
            mcus = [[(c, my * sampling[c][1] + v, mx * sampling[c][0] + u) for c, u, v in units]
                    for my in range(mcuy) for mx in range(mcux)]
        else:
            c = comps[0]
            cw = -(-w * sampling[c][0] // hmax)
            ch = -(-h * sampling[c][1] // vmax)
            mcus = [[(c, by, bx)] for by in range(-(-ch // 8)) for bx in range(-(-cw // 8))]
        enc, bits = _Arith(), _Bits()
        dc_stats = [bytearray(64), bytearray(64)]
        ac_stats = [bytearray(256), bytearray(256)]
        fixed = bytearray([113])
        pred, ctx = {}, {}
        for m, units in enumerate(mcus):
            if m == 0 or (restart and m % restart == 0):
                if m:
                    if arithmetic:
                        enc.finish()
                        enc.out += bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
                        enc.start()
                    else:
                        bits.flush()
                        bits.out += bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
                pred = {c: 0 for c in comps}
                ctx = {c: 0 for c in comps}
                dc_stats = [bytearray(64), bytearray(64)]
                ac_stats = [bytearray(256), bytearray(256)]
            for c, by, bx in units:
                blk = blocks[c][by, bx]
                t = min(c, 1)
                if ss == 0 and ah:
                    b = (int(blk[0]) >> al) & 1
                    if arithmetic:
                        enc.code(fixed, 0, b)
                    else:
                        bits.put(b, 1)
                    continue
                if ss == 0:
                    dc = int(blk[0]) >> al
                    if arithmetic:
                        ctx[c] = _arith_dc(enc, dc_stats[t], ctx[c], dc - pred[c], cond[t])
                    else:
                        _huff_value(bits, codes[t][0], dc - pred[c])
                    pred[c] = dc
                    if se == 0:
                        continue
                    ss_ac = 1
                else:
                    ss_ac = ss
                if arithmetic:
                    (_arith_ac_refine(enc, ac_stats[t], fixed, blk, ss_ac, se, al) if ah
                     else _arith_ac(enc, ac_stats[t], fixed, blk, ss_ac, se, al, cond[t][2]))
                else:
                    (_huff_ac_refine if ah else _huff_ac_first)(bits, codes[t][1], blk, ss_ac, se, al)
        if arithmetic:
            enc.finish()
            out += enc.out
        else:
            bits.flush()
            out += bits.out
    return bytes(out + b"\xff\xd9")
