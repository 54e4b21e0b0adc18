"""The PNG decoder of ``topo4d_tpu_torch/utils/png.py`` against PIL.

Exact: the decoder must return what ``np.asarray(Image.open(f))`` returns,
dtype and shape included, on files PIL writes (gray, gray+alpha, RGB, RGBA,
odd widths; PIL picks a filter per row) and on files built here row by row
with each filter type 0-4 and the image data split over several IDAT
chunks. It round-trips the port's writer and refuses what it does not read
(16-bit samples, palettes, interlacing, a bad CRC, a JPEG view).
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from topo4d_tpu_torch.pipeline.data import read_image
from topo4d_tpu_torch.utils.png import CHANNELS, SIGNATURE, _chunk, decode_png, encode_png, read_png

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


@pytest.mark.parametrize("shape", [(1, 1, 3), (37, 53, 3), (20, 301, 3)])
def test_round_trip_with_encode_png(shape, tmp_path):
    arr = np.random.default_rng(shape[1]).integers(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "t.png")
    with open(path, "wb") as fh:
        fh.write(encode_png(arr, level=1))
    np.testing.assert_array_equal(read_png(path), arr)


def test_refusals(tmp_path):
    rgb = np.zeros((4, 5, 3), np.uint8)
    with pytest.raises(ValueError, match="bit depth 16"):
        decode_png(_pil_bytes(np.zeros((4, 5), np.uint16)), "sixteen.png")
    with pytest.raises(ValueError, match="color type 3"):
        buf = io.BytesIO()
        Image.fromarray(rgb).convert("P").save(buf, format="PNG")
        decode_png(buf.getvalue(), "palette.png")
    with pytest.raises(ValueError, match="interlace 1"):
        decode_png(_interlaced(rgb), "adam7.png")
    data = bytearray(encode_png(rgb))
    data[-20] ^= 0xFF  # inside the IDAT body: its CRC no longer holds
    with pytest.raises(ValueError, match="bad CRC"):
        decode_png(bytes(data), "crc.png")
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a", "x.gif")
    path = tmp_path / "view.jpg"
    path.write_bytes(b"\xff\xd8\xff")
    with pytest.raises(NotImplementedError, match="view.jpg"):
        read_image(str(path))


def _interlaced(rgb):
    """An Adam7-interlaced header over a valid stream (the decoder refuses
    it from the header)."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 1)
    return SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")
