"""The baseline JPEG decoder of ``topo4d_tpu_torch/utils/jpeg.py`` (the C
library ``csrc/imgdec.c``) against PIL, bit for bit.

PIL here runs libjpeg-turbo at its defaults (islow IDCT, fancy upsampling),
whose arithmetic the decoder repeats: every case must equal
``np.asarray(PIL.Image.open(f))`` exactly, dtype and shape included, on
files PIL writes in the test (qualities 75 and 95; chroma subsampling 4:4:4,
4:2:2 and 4:2:0; sizes that are not multiples of the MCU, down to 1x1 and
chroma planes 1 and 2 samples wide, where libjpeg replicates instead of
interpolating; restart intervals; optimized Huffman tables; gray) and on the
committed fixtures, whose PIL decodes must also still hash as
``fixtures/manifest.json`` says (what the card's host, which has no PIL, is
held to). CMYK and arithmetic-coded files raise, naming the file; a
progressive one reads as PIL reads it (``test_torch_image_kinds.py`` holds
every other kind the decoder reads).
"""

import io

import numpy as np
import pytest
from PIL import Image

from topo4d_tpu_torch import fixtures
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


def test_refusals_name_the_file(tmp_path):
    arr = _image(20, 24, seed=1)
    path = tmp_path / "prog.jpg"
    path.write_bytes(_jpeg(arr, progressive=True))
    np.testing.assert_array_equal(read_jpeg(str(path)), _pil(path.read_bytes()))  # progressive: read
    path = tmp_path / "arith.jpg"
    path.write_bytes(_jpeg(arr).replace(b"\xff\xc0", b"\xff\xc9", 1))  # the frame header of arithmetic coding
    with pytest.raises(ValueError, match="arith.jpg: arithmetic-coded JPEG"):
        read_jpeg(str(path))
    with pytest.raises(ValueError, match="cmyk.jpg: 4 components"):
        buf = io.BytesIO()
        Image.fromarray(arr).convert("CMYK").save(buf, format="JPEG")
        decode_jpeg(buf.getvalue(), "cmyk.jpg")
    with pytest.raises(ValueError, match="x.png: not a JPEG file"):
        decode_jpeg(b"\x89PNG", "x.png")
    with pytest.raises(ValueError, match="cut.jpg: truncated marker segment"):
        decode_jpeg(_jpeg(arr)[:100], "cut.jpg")


@pytest.mark.parametrize("name", list(fixtures.manifest()))
def test_fixtures_match_pil_and_manifest(name):
    """Every fixture, the PNG among them, through the loader's reader."""
    entry = fixtures.manifest()[name]
    want = np.asarray(Image.open(fixtures.path(name)))
    assert list(want.shape) == entry["shape"] and fixtures.sha256(want) == entry["sha256"]
    got = read_image(fixtures.path(name))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
