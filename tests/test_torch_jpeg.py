"""The JPEG decoder of ``topo4d_tpu_torch/utils/jpeg.py`` (the C library
``csrc/imgdec.c``) against PIL, bit for bit.

PIL here runs libjpeg-turbo at its defaults (islow IDCT, fancy upsampling),
whose arithmetic the decoder repeats: every case must equal
``np.asarray(PIL.Image.open(f))`` exactly, dtype and shape included, on
files PIL writes in the test (qualities 75 and 95; chroma subsampling 4:4:4,
4:2:2 and 4:2:0; sizes that are not multiples of the MCU, down to 1x1 and
chroma planes 1 and 2 samples wide, where libjpeg replicates instead of
interpolating; restart intervals; optimized Huffman tables; gray) and on the
committed fixtures, whose PIL decodes must also still hash as
``fixtures/manifest.json`` says (what the card's host, which has no PIL, is
held to). CMYK files
raise, naming the file; progressive and arithmetic-coded ones read as PIL
reads them, and so does a sequential scan whose Ss, Se, Ah and Al bytes
are not 0, 63, 0, 0 (libjpeg-turbo only warns); ``test_torch_image_kinds.py``
holds every other kind the decoder reads.
"""

import io
import os
import platform
import struct

import numpy as np
import pytest
from PIL import Image

from topo4d_tpu_torch import fixtures
from topo4d_tpu_torch.fixtures.jpeg_writer import AC_LUMA, DC_LUMA, ZIGZAG, _Bits, _codes, _magnitude, _segment
from topo4d_tpu_torch.pipeline.data import read_image
from topo4d_tpu_torch.utils.jpeg import decode_jpeg, read_jpeg


def _image(h, w, seed, gray=False):
    """Gradients plus noise: smooth areas and every DCT band."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(3 * xx + 2 * yy) % 256, (5 * xx) % 256, (7 * yy + xx) % 256], -1)
    arr = np.clip(base + rng.integers(-40, 40, base.shape), 0, 255).astype(np.uint8)
    return arr[..., 0] if gray else arr


def _jpeg(arr, **save):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", **save)
    return buf.getvalue()


def _pil(data):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im)


def _assert_equal_to_pil(data):
    got, want = decode_jpeg(data), _pil(data)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


SIZES = [(1, 1), (9, 15), (3, 4), (5, 6), (16, 16), (389, 517)]  # (H, W): 15x9 and 517x389 images


@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("size", SIZES)
def test_color_matches_pil(quality, subsampling, size):
    h, w = size
    _assert_equal_to_pil(_jpeg(_image(h, w, seed=h * w + quality), quality=quality, subsampling=subsampling))


@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("size", SIZES)
def test_gray_matches_pil(quality, size):
    h, w = size
    data = _jpeg(_image(h, w, seed=h + w, gray=True), quality=quality)
    assert _pil(data).ndim == 2
    _assert_equal_to_pil(data)


@pytest.mark.parametrize("save", [
    {"restart_marker_blocks": 1, "subsampling": 2},
    {"restart_marker_blocks": 3, "subsampling": 0},
    {"restart_marker_rows": 1, "subsampling": 1},
    {"restart_marker_rows": 2, "subsampling": 2, "quality": 95},
])
def test_restart_intervals_match_pil(save):
    data = _jpeg(_image(131, 203, seed=7), **save)
    assert b"\xff\xdd" in data and b"\xff\xd0" in data  # a DRI segment and restart markers
    _assert_equal_to_pil(data)


def test_optimized_huffman_tables_match_pil():
    _assert_equal_to_pil(_jpeg(_image(77, 91, seed=9), optimize=True, quality=85))


@pytest.mark.parametrize("scan_bytes", [b"\x00\x00\x00", b"\x01\x05\x00", b"\x00\x3f\x03"],
                         ids=["Se0", "Ss1_Se5", "Al3"])
def test_sequential_scan_bytes_are_not_read(scan_bytes):
    """libjpeg-turbo warns on a sequential scan whose Ss, Se, Ah and Al are
    not 0, 63, 0, 0 and reads its blocks whole; so does the decoder."""
    data = _jpeg(_image(43, 61, seed=3))
    sos = data.index(b"\xff\xda")
    end = sos + 2 + int.from_bytes(data[sos + 2 : sos + 4], "big")
    _assert_equal_to_pil(data[: end - 3] + scan_bytes + data[end:])


def test_refusals_name_the_file(tmp_path):
    arr = _image(20, 24, seed=1)
    path = tmp_path / "prog.jpg"
    path.write_bytes(_jpeg(arr, progressive=True))
    np.testing.assert_array_equal(read_jpeg(str(path)), _pil(path.read_bytes()))  # progressive: read
    path = tmp_path / "arith.jpg"
    path.write_bytes(_jpeg(arr).replace(b"\xff\xc0", b"\xff\xc9", 1))  # the frame header of arithmetic coding
    np.testing.assert_array_equal(read_jpeg(str(path)), _pil(path.read_bytes()))  # Huffman bytes read as PIL reads
    path = tmp_path / "lossless.jpg"
    path.write_bytes(_jpeg(arr).replace(b"\xff\xc0", b"\xff\xc3", 1))
    with pytest.raises(OSError):
        _pil(path.read_bytes())
    with pytest.raises(ValueError, match="lossless.jpg: lossless JPEG"):
        read_jpeg(str(path))
    with pytest.raises(ValueError, match="cmyk.jpg: 4 components"):
        buf = io.BytesIO()
        Image.fromarray(arr).convert("CMYK").save(buf, format="JPEG")
        decode_jpeg(buf.getvalue(), "cmyk.jpg")
    with pytest.raises(ValueError, match="x.png: not a JPEG file"):
        decode_jpeg(b"\x89PNG", "x.png")
    with pytest.raises(ValueError, match="cut.jpg: truncated marker segment"):
        decode_jpeg(_jpeg(arr)[:100], "cut.jpg")


def _coefficient_jpeg(blocks, quant):
    """A gray SOF1 file of the (blocks down, blocks across, 64) zigzag
    coefficients ``blocks`` under the 16-bit quantization table ``quant``
    (natural order)."""
    dc, ac = _codes(DC_LUMA), _codes(AC_LUMA)
    bits, pred = _Bits(), 0
    for blk in blocks.reshape(-1, 64):
        s, val = _magnitude(int(blk[0]) - pred)
        pred = int(blk[0])
        bits.put(*dc[s])
        bits.put(val, s)
        run = 0
        last = int(np.flatnonzero(blk[1:])[-1]) + 1 if blk[1:].any() else 0
        for k in range(1, last + 1):
            if blk[k] == 0:
                run += 1
                continue
            while run > 15:
                bits.put(*ac[0xF0])
                run -= 16
            s, val = _magnitude(int(blk[k]))
            bits.put(*ac[(run << 4) | s])
            bits.put(val, s)
            run = 0
        if last < 63:
            bits.put(*ac[0x00])
    bits.flush()
    h, w = 8 * blocks.shape[0], 8 * blocks.shape[1]
    return (b"\xff\xd8" + _segment(0xDB, b"\x10" + b"".join(struct.pack(">H", int(x)) for x in quant[ZIGZAG]))
            + _segment(0xC1, struct.pack(">BHHB", 8, h, w, 1) + b"\x01\x11\x00")
            + _segment(0xC4, b"\x00" + bytes(DC_LUMA[0]) + bytes(DC_LUMA[1]))
            + _segment(0xC4, b"\x10" + bytes(AC_LUMA[0]) + bytes(AC_LUMA[1]))
            + _segment(0xDA, b"\x01\x01\x00\x00\x3f\x00") + bits.out + b"\xff\xd9")


@pytest.mark.skipif(platform.machine().lower() not in ("x86_64", "amd64") or bool(os.environ.get("JSIMD_FORCENONE")),
                    reason="holds the decoder to the 16-bit lanes of libjpeg-turbo's x86-64 SIMD IDCT, which PIL "
                           "runs only on an x86-64 host with SIMD on")
@pytest.mark.parametrize("layout", ["dc_only", "row0_only", "sparse", "dense", "saturating"])
def test_out_of_range_coefficients_match_pil(layout):
    """Coefficients no 8-bit encoder writes (corrupt or junk data) under
    16-bit quantizers: PIL's IDCT on x86-64 is libjpeg-turbo's SIMD one,
    whose 16-bit lanes wrap and saturate where the C IDCT would not.
    "saturating": small quantizers, so that blocks stay in the decoder's C
    passes with samples far beyond 0-255, which saturate there too."""
    rng = np.random.default_rng(len(layout))
    for i in range(12):
        blocks = rng.integers(-1023, 1024, (3, 4, 64))
        keep = rng.uniform(size=blocks.shape) < {"dc_only": 0, "row0_only": 0.5, "sparse": 0.05, "dense": 0.6,
                                                 "saturating": 0.05}[layout]
        if layout == "row0_only":  # every column's rows 1-7 zero, but not the block's
            keep &= np.isin(ZIGZAG, np.arange(8))
        blocks[~keep] = 0
        # DC differences within the Annex K DC table's 11 bits
        blocks[..., 0] = np.cumsum(rng.integers(-2047, 2048, 12)).clip(-4000, 4000).reshape(3, 4)
        quant = rng.integers(1, 16 if layout == "saturating" else (300, 5000, 65536)[i % 3], 64)
        _assert_equal_to_pil(_coefficient_jpeg(blocks, quant))


@pytest.mark.parametrize("name", list(fixtures.manifest()))
def test_fixtures_match_pil_and_manifest(name):
    """Every fixture, the PNG among them, through the loader's reader."""
    entry = fixtures.manifest()[name]
    want = np.asarray(Image.open(fixtures.path(name)))
    assert list(want.shape) == entry["shape"] and fixtures.sha256(want) == entry["sha256"]
    got = read_image(fixtures.path(name))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
