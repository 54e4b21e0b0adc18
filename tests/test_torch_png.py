"""The PNG decoder of ``topo4d_tpu_torch/utils/png.py`` against PIL.

Exact: the decoder must return what ``np.asarray(Image.open(f))`` returns,
dtype and shape included, on files PIL writes (gray, gray+alpha, RGB, RGBA,
odd widths; PIL picks a filter per row) and on files built here row by row
with each filter type 0-4 and the image data split over several IDAT
chunks. It round-trips the port's writer, reads 16-bit, palette and
interlaced files as PIL does (``test_torch_image_kinds.py`` holds every
kind) and refuses a header PNG does not allow, a bad CRC before the image
data and a bad Adler-32 (``test_torch_damaged_captures.py`` holds the
damaged files PIL reads); ``read_image``
reads a JPEG view as PIL does, whatever its extension, a progressive one
too. The C unfilter (``unfilter``) equals its NumPy mirror
(``unfilter_plain``) and PIL on rows of each filter type.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from topo4d_tpu_torch.pipeline.data import read_image
from topo4d_tpu_torch.utils.png import (
    CHANNELS,
    SIGNATURE,
    _chunk,
    decode_png,
    encode_png,
    read_png,
    unfilter,
    unfilter_plain,
)

MODES = {"L": 0, "LA": 4, "RGB": 2, "RGBA": 6}


def _pil_bytes(arr):
    """PIL's PNG of ``arr`` (its mode inferred: L, LA, RGB, RGBA, I;16)."""
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _pil_decode(data):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im)


def _image(shape, seed, smooth):
    rng = np.random.default_rng(seed)
    if smooth:  # gradients: PIL's adaptive filter picks Sub, Up, Average and Paeth rows
        h, w = shape[:2]
        yy, xx = np.mgrid[0:h, 0:w]
        base = (3 * xx + 5 * yy + rng.integers(0, 4, (h, w))) % 256
        arr = base if len(shape) == 2 else np.stack([(base + 40 * c) % 256 for c in range(shape[2])], -1)
        return arr.astype(np.uint8)
    return rng.integers(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("size", [(1, 1), (7, 13), (33, 17)])
@pytest.mark.parametrize("smooth", [False, True])
def test_decoder_matches_pil_on_pil_files(mode, size, smooth):
    c = CHANNELS[MODES[mode]]
    shape = size if c == 1 else size + (c,)
    arr = _image(shape, seed=size[0] * 31 + c, smooth=smooth)
    data = _pil_bytes(arr)
    assert _pil_decode(data).shape == arr.shape
    got, want = decode_png(data), _pil_decode(data)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, arr)


def _filter_row(kind, row, prev, c):
    """The PNG encoder's filter ``kind`` of one scanline (spec section 9.2)."""
    x = row.astype(np.int32)
    up = prev.astype(np.int32)
    left = np.concatenate([np.zeros(c, np.int32), x[:-c]])
    upleft = np.concatenate([np.zeros(c, np.int32), up[:-c]])
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


def _hand_built(arr, kinds, ctype, chunks):
    """A PNG whose row y uses filter kinds[y], its deflate stream split into
    ``chunks`` IDAT chunks."""
    h, w = arr.shape[:2]
    c = CHANNELS[ctype]
    rows = arr.reshape(h, w * c)
    prev = np.zeros(w * c, np.uint8)
    raw = b""
    for y in range(h):
        raw += bytes([kinds[y]]) + _filter_row(kinds[y], rows[y], prev, c).tobytes()
        prev = rows[y]
    z = zlib.compress(raw)
    cut = np.linspace(0, len(z), chunks + 1).astype(int)
    idat = b"".join(_chunk(b"IDAT", z[a:b]) for a, b in zip(cut[:-1], cut[1:]))
    header = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return SIGNATURE + _chunk(b"IHDR", header) + idat + _chunk(b"IEND", b"")


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("mode", list(MODES))
def test_each_filter_type_built_by_hand(kind, mode):
    ctype = MODES[mode]
    c = CHANNELS[ctype]
    h, w = 11, 9
    arr = _image((h, w) if c == 1 else (h, w, c), seed=ctype, smooth=False)
    kinds = [y % 5 for y in range(h)] if kind == "mixed" else [kind] * h
    data = _hand_built(arr, kinds, ctype, chunks=3)
    got = decode_png(data)
    np.testing.assert_array_equal(got, _pil_decode(data))
    np.testing.assert_array_equal(got, arr)


def _filtered_rows(arr, kinds, c):
    """(H, 1 + W * c) raw rows of ``arr``, row y filtered with kinds[y]."""
    h = arr.shape[0]
    rows = arr.reshape(h, -1)
    prev = np.zeros(rows.shape[1], np.uint8)
    out = np.zeros((h, 1 + rows.shape[1]), np.uint8)
    for y in range(h):
        out[y, 0] = kinds[y]
        out[y, 1:] = _filter_row(kinds[y], rows[y], prev, c)
        prev = rows[y]
    return out


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("size", [(1, 1), (6, 1), (23, 17)])
def test_c_unfilter_equals_numpy_mirror_and_pil(kind, mode, size):
    ctype = MODES[mode]
    c = CHANNELS[ctype]
    arr = _image(size if c == 1 else size + (c,), seed=size[0] + ctype, smooth=False)
    kinds = [y % 5 for y in range(size[0])] if kind == "mixed" else [kind] * size[0]
    raw = _filtered_rows(arr, kinds, c)
    got = unfilter(raw, c)
    np.testing.assert_array_equal(got, unfilter_plain(raw, c))
    np.testing.assert_array_equal(got.reshape(arr.shape), arr)
    np.testing.assert_array_equal(got.reshape(arr.shape), _pil_decode(_hand_built(arr, kinds, ctype, chunks=1)))


@pytest.mark.parametrize("mode", list(MODES))
def test_c_unfilter_on_pil_files(mode):
    """PIL's own filter choice per row (Average and Paeth among them on the
    gradients) through both unfilters."""
    c = CHANNELS[MODES[mode]]
    arr = _image((40, 37) if c == 1 else (40, 37, c), seed=c, smooth=True)
    data = _pil_bytes(arr)
    pos, idat = 8, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        if data[pos + 4 : pos + 8] == b"IDAT":
            idat += data[pos + 8 : pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(40, -1)
    assert len(set(raw[:, 0].tolist())) > 1  # PIL filtered rows of more than one type
    np.testing.assert_array_equal(unfilter(raw, c), unfilter_plain(raw, c))
    np.testing.assert_array_equal(unfilter(raw, c).reshape(arr.shape), _pil_decode(data))


def test_c_unfilter_refuses_a_bad_filter_type():
    raw = _filtered_rows(np.zeros((3, 4, 3), np.uint8), [0, 0, 0], 3)
    raw[2, 0] = 7
    with pytest.raises(ValueError, match="filter type 7 in row 2"):
        unfilter(raw, 3)


@pytest.mark.parametrize("shape", [(1, 1, 3), (37, 53, 3), (20, 301, 3), (9, 7), (5, 6, 4)])
def test_round_trip_with_encode_png(shape, tmp_path):
    arr = np.random.default_rng(shape[1]).integers(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "t.png")
    with open(path, "wb") as fh:
        fh.write(encode_png(arr, level=1))
    np.testing.assert_array_equal(read_png(path), arr)


def test_refusals(tmp_path):
    rgb = np.zeros((4, 5, 3), np.uint8)
    # 16-bit samples, palettes and interlacing read as PIL reads them
    sixteen = _pil_bytes(np.arange(20, dtype=np.uint16).reshape(4, 5) * 3000)
    np.testing.assert_array_equal(decode_png(sixteen, "sixteen.png"), _pil_decode(sixteen))
    buf = io.BytesIO()
    Image.fromarray(_image((4, 5, 3), seed=2, smooth=False)).convert("P").save(buf, format="PNG")
    np.testing.assert_array_equal(decode_png(buf.getvalue(), "palette.png"), _pil_decode(buf.getvalue()))
    np.testing.assert_array_equal(decode_png(_interlaced(rgb), "adam7.png"), rgb)
    with pytest.raises(ValueError, match="bad.png: bit depth 16, color type 3"):
        decode_png(_interlaced(rgb, depth=16, ctype=3), "bad.png")
    data = bytearray(encode_png(rgb))
    data[32] ^= 0xFF  # IHDR's CRC: PIL checks the CRCs of the chunks before IDAT
    with pytest.raises(ValueError, match="crc.png: bad CRC in its IHDR chunk"):
        decode_png(bytes(data), "crc.png")
    data = bytearray(encode_png(rgb))
    data[-20] ^= 0xFF  # inside the IDAT body, its Adler-32: PIL reads no IDAT CRC, but inflate fails
    with pytest.raises(ValueError, match="adler.png: broken image data .*incorrect data check"):
        decode_png(bytes(data), "adler.png")
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a", "x.gif")
    # a JPEG view reads as PIL reads it, told apart by its leading bytes
    # whatever its extension, a progressive one too
    arr = _image((13, 21, 3), seed=5, smooth=True)
    for name in ("view.jpg", "jpeg_named.png"):
        path = tmp_path / name
        Image.fromarray(arr).save(str(path), format="JPEG")
        with Image.open(str(path)) as im:
            np.testing.assert_array_equal(read_image(str(path)), np.asarray(im))
    path = tmp_path / "progressive.jpg"
    Image.fromarray(arr).save(str(path), format="JPEG", progressive=True)
    with Image.open(str(path)) as im:
        np.testing.assert_array_equal(read_image(str(path)), np.asarray(im))
    path.write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="progressive.jpg: neither a PNG nor a JPEG"):
        read_image(str(path))


def _interlaced(rgb, depth=8, ctype=2):
    """An Adam7-interlaced PNG of ``rgb``, each pass's rows unfiltered; with
    ``depth`` and ``ctype`` other than 8 and 2 a header over it that PNG
    does not allow (the decoder refuses it from the header)."""
    h, w, _ = rgb.shape
    passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
    raw = b"".join(
        b"\x00" + row.tobytes() for x0, y0, dx, dy in passes if x0 < w and y0 < h for row in rgb[y0::dy, x0::dx]
    )
    header = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 1)
    return SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")
