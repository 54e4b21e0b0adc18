"""Image fixtures with each one's shape and the SHA-256 of PIL's decode
(``manifest.json``): what ``utils/jpeg.py`` and ``utils/png.py`` are held to
where PIL is absent, as on the card's host (``chip_smoke.py`` phases 9 and
13).

``BASELINE`` are the sequential JPEGs PIL wrote: ``DENSE``, a dense view at
the capture size, 4096x3000 (a landscape sensor), 4:2:0 with a restart
interval; working-size views in 4:2:2 and 4:4:4 and a gray image. ``KINDS``
are the other kinds the loader reads: ``DENSE_PROGRESSIVE``, the same dense
image as PIL's progressive JPEG; progressive 4:4:4 and gray views; an Adobe
APP14 marker of transform 0 (RGB) and of transform 1 (YCbCr) spliced into
PIL's output in place of its JFIF marker; 4:4:0 and 4:1:1 views from
``jpeg_writer.encode_baseline`` (PIL writes neither sampling); an
Adam7-interlaced 16-bit RGB PNG from ``png_writer.encode_png_any``; and
arithmetic-coded files from ``jpeg_writer.encode_scans``: a working-size
4:2:2 sequential (SOF9) view, progressive (SOF10) 4:4:4 and gray views, a
4:2:0 view whose DAC segment sets non-default conditioning values; two
progressive files whose scans leave coefficient bits unsent (which the
decoder smooths as libjpeg-turbo does): PIL's 4:2:0 file cut after its DC
scan, and a SOF10 file whose coefficients 1-9 keep their lowest bit
unsent; and two 61x43 arithmetic files (SOF9, SOF10) libjpeg wrote through
``libjpeg_arith.c``, an encoder independent of the writer's; and an 8-bit
RGB PNG from ``utils/png.py`` ``encode_png``.
Regenerate them by ``python -m topo4d_tpu_torch.fixtures`` (the images are
made from a seed; the hashes are PIL's decode of the files written). Every
arithmetic file stays under PIL's 64 KiB read block: PIL, and so JAX's
loader, fails on a larger one.

``damaged(name, case)`` makes a damaged copy of a fixture at run time, the
same bytes on every host: ``DAMAGED`` lists each fixture's cases (JPEG cut
off, cut off and closed by an EOI marker, or a restart marker deleted; PNG
cut inside IEND, with a bad CRC, an inflated stream of other lengths, IDAT
chunks split by another chunk). PIL's outcome of each, the shape and
SHA-256 of its array or "raises", is the manifest entry's ``damaged``
record (``damaged_outcome``).
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import zlib
from typing import Dict, Union

import numpy as np

FIXTURE_DIR = os.path.dirname(os.path.abspath(__file__))
MANIFEST = os.path.join(FIXTURE_DIR, "manifest.json")
DENSE = "dense_4096x3000_q85_420.jpg"
DENSE_PROGRESSIVE = "dense_4096x3000_q85_420_progressive.jpg"
PNG8 = "view_127x93_rgb8.png"
BASELINE = (DENSE, "view_517x389_q75_422.jpg", "view_517x389_q95_444.jpg", "gray_515x387_q85.jpg")
KINDS = (
    DENSE_PROGRESSIVE,
    "view_259x195_q90_444_progressive.jpg",
    "gray_257x193_q85_progressive.jpg",
    "view_261x197_q85_adobe0.jpg",
    "view_261x197_q85_adobe1.jpg",
    "view_263x199_q85_440.jpg",
    "view_263x199_q85_411.jpg",
    "view_127x93_rgb16_adam7.png",
    PNG8,
    "libjpeg_61x43_q85_420_arith.jpg",
    "libjpeg_61x43_q85_420_arith_progressive.jpg",
    "view_517x389_q75_422_arith.jpg",
    "view_259x195_q90_444_arith_progressive.jpg",
    "gray_257x193_q85_arith_progressive.jpg",
    "view_261x197_q85_420_arith_dac.jpg",
    "view_259x195_q90_420_progressive_dc_only.jpg",
    "view_259x195_q85_444_arith_progressive_ac1_9_partial.jpg",
)


def manifest() -> Dict[str, dict]:
    """file name -> {"shape": [H, W(, 3)], "sha256": hex digest of PIL's
    decoded bytes, "save": how it was written (PIL's save options, or the
    writer's and splice's)}."""
    with open(MANIFEST) as fh:
        return json.load(fh)


def path(name: str) -> str:
    return os.path.join(FIXTURE_DIR, name)


def sha256(pixels: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest()


# JPEG cases: the file cut at 30, 60, 90 or 99% of its bytes, or without its
# last 2 (EOI) or 10 bytes; cut at 60% and closed by an EOI marker; with the
# FF D2 restart marker nearest its middle deleted
JPEG_CUTS = ("cut30", "cut60", "cut90", "cut99", "eoi_removed", "tail10_removed")
# PNG cases: cut 4 or 10 bytes before its end (inside IEND); a bad CRC on
# IHDR, IDAT, IEND, or a tEXt chunk put after IDAT; the image data as a
# zlib stream with 1,000 bytes more than the image needs (stored blocks),
# without its Adler-32, with a bad one, or cut in half; the IDAT data split
# over two IDAT chunks with a tEXt chunk between them
PNG_CASES = ("iend_cut4", "iend_cut10", "ihdr_crc", "idat_crc", "iend_crc", "text_after_idat_crc",
             "zlib_extra", "zlib_no_adler", "zlib_bad_adler", "zlib_short", "text_between_idats")
DAMAGED = {
    DENSE: ("cut30", "cut60", "cut90", "cut99", "eoi_removed", "tail10_removed", "cut60_eoi", "rst_deleted"),
    DENSE_PROGRESSIVE: ("cut60", "eoi_removed", "cut60_eoi", "rst_deleted"),
    "view_517x389_q75_422.jpg": JPEG_CUTS + ("cut60_eoi",),
    "gray_515x387_q85.jpg": JPEG_CUTS + ("cut60_eoi",),
    "view_263x199_q85_411.jpg": ("cut60", "eoi_removed", "cut60_eoi", "rst_deleted"),
    "view_259x195_q90_444_progressive.jpg": ("cut60", "eoi_removed", "cut60_eoi"),
    "gray_257x193_q85_progressive.jpg": ("cut30", "cut60_eoi"),
    "view_517x389_q75_422_arith.jpg": JPEG_CUTS + ("cut60_eoi",),
    "view_127x93_rgb16_adam7.png": PNG_CASES,
    PNG8: PNG_CASES,
}


def _png_parts(data: bytes):
    """A PNG file -> (the bytes before its first IDAT chunk, the joined IDAT
    data, the chunks after its last IDAT)."""
    pos, spans = 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        if data[pos + 4 : pos + 8] == b"IDAT":
            spans.append((pos, pos + 12 + n))
        pos += 12 + n
    stream = b"".join(data[a + 8 : b - 4] for a, b in spans)
    return data[: spans[0][0]], stream, data[spans[-1][1] :]


def _chunk(kind: bytes, body: bytes, bad_crc: bool = False) -> bytes:
    crc = zlib.crc32(kind + body) ^ (1 if bad_crc else 0)
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def _stored_zlib(raw: bytes) -> bytes:
    """``raw`` as a zlib stream of stored blocks: the same bytes from every
    zlib build."""
    out = bytearray(b"\x78\x01")
    for i in range(0, len(raw), 65535):
        block = raw[i : i + 65535]
        out += bytes([i + 65535 >= len(raw)]) + struct.pack("<HH", len(block), 0xFFFF ^ len(block)) + block
    return bytes(out) + struct.pack(">I", zlib.adler32(raw))


def _flip_last(data: bytes, end: int) -> bytes:
    return data[: end - 1] + bytes([data[end - 1] ^ 1]) + data[end:]


def damaged(name: str, case: str) -> bytes:
    """The fixture ``name`` damaged as ``case`` says (``DAMAGED``)."""
    with open(path(name), "rb") as fh:
        data = fh.read()
    n = len(data)
    if case.startswith("cut") and case[3:].isdigit():
        return data[: n * int(case[3:]) // 100]
    if case in ("eoi_removed", "tail10_removed"):
        return data[: n - (2 if case == "eoi_removed" else 10)]
    if case == "cut60_eoi":
        return data[: n * 60 // 100] + b"\xff\xd9"
    if case == "rst_deleted":
        sos = data.index(b"\xff\xda")
        marks = [i for i in range(sos, n - 1) if data[i] == 0xFF and data[i + 1] == 0xD2]
        at = min(marks, key=lambda i: abs(i - n // 2))
        return data[:at] + data[at + 2 :]
    head, stream, tail = _png_parts(data)
    if case in ("iend_cut4", "iend_cut10"):
        return data[: n - int(case[8:])]
    if case == "ihdr_crc":
        return _flip_last(data, 33)  # signature, then IHDR: length, type, 13 bytes, CRC
    if case == "idat_crc":
        return _flip_last(data, n - len(tail))
    if case == "iend_crc":
        return _flip_last(data, n)
    if case == "text_after_idat_crc":
        return data[: n - 12] + _chunk(b"tEXt", b"Comment\0damaged", bad_crc=True) + data[n - 12 :]
    if case == "text_between_idats":
        half = len(stream) // 2
        return head + _chunk(b"IDAT", stream[:half]) + _chunk(b"tEXt", b"Comment\0between") + (
            _chunk(b"IDAT", stream[half:]) + tail)
    new_stream = {
        "zlib_extra": lambda: _stored_zlib(zlib.decompress(stream) + bytes(1000)),
        "zlib_no_adler": lambda: stream[:-4],
        "zlib_bad_adler": lambda: _flip_last(stream, len(stream)),
        "zlib_short": lambda: stream[: len(stream) // 2],
    }[case]()
    return head + _chunk(b"IDAT", new_stream) + tail


def damaged_outcome(pixels: Union[np.ndarray, None]):
    """A manifest ``damaged`` record: the shape and SHA-256 of a decode, or
    "raises" (``pixels`` None)."""
    return "raises" if pixels is None else {"shape": list(pixels.shape), "sha256": sha256(pixels)}
