"""An 8-bit PNG writer and a PNG reader on ``zlib``, ``struct`` and the host C
library.

The JAX package reads and writes images through PIL (``pipeline/data.py``,
``pipeline/export.py``); this package must not need it. The writer emits
8-bit gray, RGB or RGBA, one IDAT chunk, filter type 0 (none) on every row,
deflate at ``level`` (6, PIL's default). The reader takes every PNG: each
colour type at each bit depth PNG allows, with or without Adam7
interlacing, any number of IDAT chunks, a filter type from 0 to 4 chosen
per row, ancillary chunks (``tRNS``, ``gAMA``, ...) skipped as they change
nothing in PIL's array. It returns what ``np.asarray(PIL.Image.open(f))``
gives (Pillow 12.1), whatever the interlace:

    colour type     depth   PIL mode  array
    0 gray          1       1         (H, W) bool
    0 gray          2       L         (H, W) uint8, sample * 85
    0 gray          4       L         (H, W) uint8, sample * 17
    0 gray          8       L         (H, W) uint8
    0 gray          16      I;16      (H, W) uint16
    2 RGB           8       RGB       (H, W, 3) uint8
    2 RGB           16      RGB       (H, W, 3) uint8, the high bytes
    3 palette       1-8     P         (H, W) uint8, the indices
    4 gray+alpha    8       LA        (H, W, 2) uint8
    4 gray+alpha    16      RGBA      (H, W, 4) uint8: gray, gray, gray, alpha, the high bytes
    6 RGBA          8       RGBA      (H, W, 4) uint8
    6 RGBA          16      RGBA      (H, W, 4) uint8, the high bytes

Filtered rows are undone by ``png_unfilter`` of ``csrc/imgdec.c``
(``unfilter``) at the real bytes per pixel (2 per sample at 16 bits, 1 below
8 bits), which holds no interpreter lock; ``unfilter_plain`` is its NumPy
mirror, for the tests. Sub-byte samples are unpacked after the unfilter.
An interlaced image is seven filtered passes, each unfiltered alone and
scattered into place. Damaged and cut-off files read, or raise, as PIL's
plugin reads them (``decode_png``): CRCs are checked only before the image
data, which is the first run of IDAT chunks, inflated only as far as the
image needs.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from topo4d_tpu_torch import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4, 3: 1}  # color type -> samples per pixel (gray, gray+alpha, RGB, RGBA, palette)
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (first column, first row, column step, row step)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """(H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA uint8 -> the bytes of a
    PNG file."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] in (3, 4))):
        raise ValueError(f"expected an (H, W), (H, W, 3) or (H, W, 4) uint8 image, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    raw = np.zeros((h, 1 + c * w), np.uint8)  # column 0: each row's filter byte
    raw[:, 1:] = img.reshape(h, c * w)
    color_type = {1: 0, 3: 2, 4: 6}[c]
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)  # 8-bit, deflate, no interlace
    return (
        SIGNATURE
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(raw.data, level=level))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    with open(path, "wb") as fh:
        fh.write(encode_png(img, level=level))


def _unfilter_sequential(kind: int, line: np.ndarray, prev: np.ndarray, c: int) -> np.ndarray:
    """Average (3) and Paeth (4): each pixel depends on the one decoded
    before it, so walk the pixels with the channels as a vector (int16,
    reduced mod 256 per pixel)."""
    w = line.shape[0] // c
    cur = line.reshape(w, c).astype(np.int16)
    up = prev.reshape(w, c).astype(np.int16)
    left = np.zeros(c, np.int16)
    upleft = np.zeros(c, np.int16)
    for x in range(w):
        b = up[x]
        if kind == 3:
            pred = (left + b) >> 1
        else:
            p = left + b - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - b), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, b, upleft))
        left = (cur[x] + pred) & 255
        cur[x] = left
        upleft = b
    return cur.reshape(-1).astype(np.uint8)


def unfilter_plain(raw: np.ndarray, c: int) -> np.ndarray:
    """(H, 1 + stride) filtered rows (the filter byte first) of ``c``
    bytes per pixel -> (H, stride) pixels, in NumPy: Sub as a running sum,
    Up as a sum, Average and Paeth pixel by pixel (``_unfilter_sequential``)."""
    h, stride = raw.shape[0], raw.shape[1] - 1
    w = stride // c
    out = raw[:, 1:].copy()
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        line = out[y]
        kind = raw[y, 0]
        if kind == 1:  # Sub: a running sum mod 256 per channel
            line[:] = np.cumsum(line.reshape(w, c), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            line += prev
        elif kind in (3, 4):
            line[:] = _unfilter_sequential(int(kind), line, prev, c)
        prev = line
    return out


def unfilter(raw: np.ndarray, c: int) -> np.ndarray:
    """``unfilter_plain``'s result from the C library's ``png_unfilter``."""
    raw = np.ascontiguousarray(raw, np.uint8)
    h, stride = raw.shape[0], raw.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    bad = native.library().png_unfilter(raw.ctypes.data, h, stride, c, out.ctypes.data)
    if bad:
        raise ValueError(f"filter type {int(raw[bad - 1, 0])} in row {bad - 1}")
    return out


def _row_bytes(w: int, c: int, depth: int) -> int:
    return (w * c * depth + 7) // 8


def _unpack(rows: np.ndarray, w: int, c: int, depth: int) -> np.ndarray:
    """(H, row bytes) unfiltered rows -> (H, W * C) samples: uint16 at 16
    bits, uint8 otherwise (sub-byte samples from the high bits down)."""
    if depth == 16:
        return rows.view(">u2").astype(np.uint16)
    if depth == 8:
        return rows
    h = rows.shape[0]
    bits = np.unpackbits(rows, axis=1)[:, : w * c * depth].reshape(h, w * c, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)


def _pass(raw: np.ndarray, h: int, w: int, c: int, depth: int, name: str) -> np.ndarray:
    """One image (or Adam7 pass) of ``h`` filtered rows -> (h, W * C) samples."""
    rows = raw.reshape(h, 1 + _row_bytes(w, c, depth))
    kinds = rows[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"{name}: filter type {int(kinds.max())} in row {int(np.argmax(kinds > 4))}")
    bpp = max(1, c * depth // 8)
    out = unfilter(rows, bpp) if kinds.any() else rows[:, 1:].copy()
    return _unpack(out, w, c, depth)


def _as_pil(samples: np.ndarray, h: int, w: int, ctype: int, depth: int) -> np.ndarray:
    """(H, W * C) samples -> what PIL's array holds (the table above)."""
    c = CHANNELS[ctype]
    px = samples.reshape(h, w, c) if c > 1 else samples.reshape(h, w)
    if ctype == 0:
        if depth == 1:
            return px != 0
        if depth < 8:
            return px * np.uint8(255 // ((1 << depth) - 1))
        return px
    if depth == 16:
        px = (px >> 8).astype(np.uint8)
        if ctype == 4:  # PIL reads 16-bit gray+alpha as RGBA
            return px[..., [0, 0, 0, 1]]
    return px


PIL_BLOCK = 65536  # ImageFile.MAXBLOCK: PIL reads a chunk's image data in blocks of this size


def _is_type(kind: bytes) -> bool:
    """A chunk type as PIL's ``is_cid`` takes one: four ASCII letters,
    digits or underscores."""
    return len(kind) == 4 and all(c == 95 or 48 <= c <= 57 or 65 <= c <= 90 or 97 <= c <= 122 for c in kind)


def _inflate_as_pil(view: memoryview, run, total: int, name: str):
    """PIL's zip decoder (``ZipDecode.c``) over the IDAT run: inflate fed
    each chunk's data in PIL's reads, stopped as soon as the image's
    ``total`` bytes are out. So what follows them (more data, the Adler-32,
    or nothing) is read only as far as that read reaches, and a data error
    there raises only then. -> (the image's filtered bytes, the index in
    ``run`` of the chunk they ended in)."""
    inflater = zlib.decompressobj()
    parts, got = [], 0
    for i, (start, stop, _) in enumerate(run):
        for a in range(start, stop, PIL_BLOCK):
            try:
                part = inflater.decompress(view[a : min(a + PIL_BLOCK, stop)], total - got)
            except zlib.error as e:
                raise ValueError(f"{name}: broken image data ({e})") from None
            parts.append(part)
            got += len(part)
            if got == total:
                return np.frombuffer(b"".join(parts), np.uint8), i
    raise ValueError(f"{name}: image file is truncated ({got} of {total} bytes of image data)")


def _inflate(view: memoryview, run, total: int, name: str):
    """``_inflate_as_pil``'s result. An intact run of chunks inflates in one
    call into a buffer of the image's size, which holds no interpreter lock
    while the loader's threads read (a growing buffer, or one call per PIL
    read, takes the lock at each step). Where that call ends without error,
    PIL, which reads a part of the same stream, reads the same bytes; where
    it fails, or the file cuts the run, which of PIL's reads ends the image
    decides what PIL sees, and ``_inflate_as_pil`` reads as PIL does."""
    start, stop, declared = run[-1]
    if stop == declared:
        stream = view[run[0][0] : stop] if len(run) == 1 else b"".join(view[a:b] for a, b, _ in run)
        try:
            raw = zlib.decompress(stream, bufsize=total + 1)
        except zlib.error:
            raw = b""
        if len(raw) >= total:
            return np.frombuffer(raw, np.uint8, total), len(run) - 1
    return _inflate_as_pil(view, run, total, name)


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The bytes of a PNG file -> what ``np.asarray(PIL.Image.open(...))``
    gives for it (the table in the module docstring). ``name`` labels the
    errors. Damaged and cut-off files read, or raise ``ValueError``, as PIL
    12 reads them, chunk by chunk:

    - ``Image.open``: the chunks before the first IDAT, each CRC checked; a
      chunk cut by the file's end, a bad chunk type or CRC, or no IHDR
      raises. Ancillary chunks are skipped.
    - ``load``: the image data is the first run of consecutive IDAT chunks
      (``load_read``); their CRCs are not checked. It is inflated only as
      far as the image needs (``_inflate``): more data than that, or a
      stream without its Adler-32, reads; too little, or a bad Adler-32 in
      the read that ends the image, raises.
    - ``load_end``: after the chunk in which the image ended, the chunks up
      to IEND, without their CRCs; one whose data the file cuts raises. A
      cut chunk header, or one of no chunk type, ends the file. (PIL also
      parses the text and animation chunks it meets there; such chunks are
      only skipped here.)
    """
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    # chunk bodies as views of ``data``: a reading thread copies as little
    # as it can while it holds the interpreter lock
    view = memoryview(data)
    n = len(data)
    pos, header = 8, None
    while True:
        kind = bytes(view[pos + 4 : pos + 8])
        if pos + 8 > n or not _is_type(kind):
            raise ValueError(f"{name}: no image data (a cut or broken chunk header at byte {pos})")
        (length,) = struct.unpack_from(">I", data, pos)
        if kind == b"IDAT":
            break
        if kind == b"IEND" or pos + 12 + length > n:
            raise ValueError(f"{name}: no image data ({kind.decode('latin-1')} chunk at byte {pos})")
        body = view[pos + 8 : pos + 8 + length]
        if zlib.crc32(body, zlib.crc32(kind)) != struct.unpack_from(">I", data, pos + 8 + length)[0]:
            raise ValueError(f"{name}: bad CRC in its {kind.decode('latin-1')} chunk")
        if kind == b"IHDR":
            if length < 13:
                raise ValueError(f"{name}: truncated IHDR chunk")
            header = struct.unpack_from(">IIBBBBB", data, pos + 8)
        pos += 12 + length
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, ctype, _, filtering, interlace = header  # PIL reads any compression method as deflate
    if ctype not in DEPTHS or depth not in DEPTHS[ctype] or filtering != 0 or interlace > 1:
        raise ValueError(
            f"{name}: bit depth {depth}, color type {ctype}, filter method {filtering}, "
            f"interlace {interlace} is not a valid PNG header"
        )
    run = []  # (data start, data end in the file, declared end) of each IDAT chunk
    while True:
        (length,) = struct.unpack_from(">I", data, pos)
        run.append((pos + 8, min(pos + 8 + length, n), pos + 8 + length))
        pos += 12 + length
        if pos + 8 > n or view[pos + 4 : pos + 8] not in (b"IDAT", b"DDAT"):
            break
    c = CHANNELS[ctype]
    passes = [(0, 0, 1, 1)] if interlace == 0 else ADAM7
    sizes = [(-(-(h - y0) // dy), -(-(w - x0) // dx)) for x0, y0, dx, dy in passes]
    sizes = [(ph, pw) if ph > 0 and pw > 0 else (0, 0) for ph, pw in sizes]  # an empty pass has no rows
    total = sum(ph * (1 + _row_bytes(pw, c, depth)) for ph, pw in sizes)
    raw, last = _inflate(view, run, total, name)
    pos = run[last][2] + 4  # past the rest of that chunk and its CRC
    while pos + 8 <= n and _is_type(bytes(view[pos + 4 : pos + 8])) and view[pos + 4 : pos + 8] != b"IEND":
        (length,) = struct.unpack_from(">I", data, pos)
        if pos + 8 + length > n:
            raise ValueError(f"{name}: image file is truncated (its {bytes(view[pos + 4 : pos + 8]).decode()} chunk)")
        pos += 12 + length
    if interlace == 0:
        samples = _pass(raw, h, w, c, depth, name)
    else:
        samples = np.empty((h, w * c), np.uint16 if depth == 16 else np.uint8)
        grid = samples.reshape(h, w, c)
        off = 0
        for (x0, y0, dx, dy), (ph, pw) in zip(passes, sizes):
            if ph == 0:
                continue
            size = ph * (1 + _row_bytes(pw, c, depth))
            grid[y0::dy, x0::dx] = _pass(raw[off : off + size], ph, pw, c, depth, name).reshape(ph, pw, c)
            off += size
    return _as_pil(samples, h, w, ctype, depth)


def read_png(path: str) -> np.ndarray:
    """``decode_png`` of the file at ``path``."""
    with open(path, "rb") as fh:
        return decode_png(fh.read(), path)
