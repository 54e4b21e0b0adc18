"""Every image kind the JAX loader reads through PIL, read by the port's
decoders (``utils/jpeg.py`` over ``csrc/imgdec.c``, ``utils/png.py``) as
``np.asarray(PIL.Image.open(f))`` gives it: shape, dtype and bytes.

JPEG at odd sizes (partial MCUs): progressive files PIL writes (4:2:0,
4:2:2, 4:4:4, gray, restart intervals, optimized tables), PIL's files with
an Adobe APP14 marker spliced in place of the JFIF one (transforms 0, 1 and
an unknown one), PIL's ``keep_rgb`` files, and files from the fixtures'
baseline writer at samplings PIL cannot write (4:4:0, 4:1:1, 4:1:0, 3x1,
1x4, 2x4, chroma finer than luma, mixed) and with 'R', 'G', 'B' or unknown
component ids. PNG: all 15 (colour type, bit depth) pairs, each with and
without Adam7, from the fixtures' NumPy writer, at sizes with empty passes
too, and with ancillary chunks. A progressive tree and a 16-bit PNG tree
read by the port's ``DiskSequence`` and by JAX's, equal after the division.
Each kind still refused raises ``ValueError`` naming the file: arithmetic
coding (spliced SOF9 and DAC), lossless, hierarchical, 12-bit, CMYK, more
than 10 blocks per MCU, fractional sampling, progressive scans that leave
coefficient bits unsent (PIL smooths those blocks), a PNG header PNG does
not allow.
"""

import io
import os
import shutil
import struct

import numpy as np
import pytest
from PIL import Image

from topo4d_tpu.config import Config as JConfig
from topo4d_tpu.pipeline.data import DiskSequence as JDiskSequence

from topo4d_tpu_torch.config import Config
from topo4d_tpu_torch.fixtures.__main__ import splice_adobe
from topo4d_tpu_torch.fixtures.jpeg_writer import encode_baseline
from topo4d_tpu_torch.fixtures.png_writer import CHANNELS, DEPTHS, chunk, encode_png_any
from topo4d_tpu_torch.pipeline.data import DiskSequence, frame_tensor, read_image
from topo4d_tpu_torch.testing import write_disk_sequence
from topo4d_tpu_torch.utils.jpeg import decode_jpeg
from topo4d_tpu_torch.utils.png import decode_png

SIZES = [(43, 61), (1, 1), (9, 15)]  # (H, W): 61x43 leaves partial MCUs at every sampling


def _image(h, w, seed, gray=False):
    """Gradients plus noise: smooth areas and every DCT band."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(3 * xx + 2 * yy) % 256, (5 * xx) % 256, (7 * yy + xx) % 256], -1)
    arr = np.clip(base + rng.integers(-40, 40, base.shape), 0, 255).astype(np.uint8)
    return arr[..., 0] if gray else arr


def _pil_jpeg(arr, **save):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", **save)
    return buf.getvalue()


def _pil(data):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im)


def _assert_like_pil(got, data):
    want = _pil(data)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# kind -> (h, w, seed) -> JPEG bytes
JPEG_KINDS = {
    "progressive_420": lambda a: _pil_jpeg(a, progressive=True),
    "progressive_422": lambda a: _pil_jpeg(a, progressive=True, subsampling=1, quality=75),
    "progressive_444": lambda a: _pil_jpeg(a, progressive=True, subsampling=0, quality=95),
    "progressive_gray": lambda a: _pil_jpeg(a[..., 0], progressive=True),
    "progressive_restart_blocks": lambda a: _pil_jpeg(a, progressive=True, restart_marker_blocks=3),
    "progressive_restart_rows": lambda a: _pil_jpeg(a, progressive=True, restart_marker_rows=1, subsampling=0),
    "progressive_optimized": lambda a: _pil_jpeg(a, progressive=True, optimize=True, quality=90),
    "adobe0_spliced": lambda a: splice_adobe(_pil_jpeg(a, subsampling=2), 0),
    "adobe1_spliced": lambda a: splice_adobe(_pil_jpeg(a, subsampling=1), 1),
    "adobe2_spliced": lambda a: splice_adobe(_pil_jpeg(a, subsampling=0), 2),  # unknown: YCbCr
    "adobe0_progressive": lambda a: splice_adobe(_pil_jpeg(a, progressive=True), 0),
    "adobe_gray": lambda a: splice_adobe(_pil_jpeg(a[..., 0]), 0),
    "keep_rgb": lambda a: _pil_jpeg(a, keep_rgb=True),
    "keep_rgb_progressive": lambda a: _pil_jpeg(a, keep_rgb=True, progressive=True),
    "rgb_ids_no_marker": lambda a: encode_baseline(a, ((2, 1), (1, 1), (1, 1)), ids=(82, 71, 66), ycbcr=False,
                                                   jfif=False),
    "unknown_ids_no_marker": lambda a: encode_baseline(a, ids=(5, 6, 7), jfif=False),
    "jfif_beats_adobe0": lambda a: encode_baseline(a, adobe_transform=0),
    "440": lambda a: encode_baseline(a, ((1, 2), (1, 1), (1, 1))),
    "411": lambda a: encode_baseline(a, ((4, 1), (1, 1), (1, 1)), restart=2),
    "410": lambda a: encode_baseline(a, ((4, 2), (1, 1), (1, 1))),
    "3x1": lambda a: encode_baseline(a, ((3, 1), (1, 1), (1, 1))),
    "1x4": lambda a: encode_baseline(a, ((1, 4), (1, 1), (1, 1))),
    "2x4": lambda a: encode_baseline(a, ((2, 4), (1, 1), (1, 1))),
    "luma_2x2_chroma_1x2": lambda a: encode_baseline(a, ((2, 2), (1, 2), (1, 2))),
    "luma_2x2_chroma_2x1": lambda a: encode_baseline(a, ((2, 2), (2, 1), (2, 1))),
    "chroma_finer_than_luma": lambda a: encode_baseline(a, ((1, 1), (2, 2), (2, 2))),
    "mixed": lambda a: encode_baseline(a, ((2, 2), (1, 2), (2, 1)), quality=60),
}


@pytest.mark.parametrize("kind", list(JPEG_KINDS))
def test_jpeg_kind_matches_pil(kind):
    for h, w in SIZES:
        data = JPEG_KINDS[kind](_image(h, w, seed=h * w + len(kind)))
        _assert_like_pil(decode_jpeg(data, kind), data)


PNG_KINDS = [(t, d, il) for t, depths in DEPTHS.items() for d in depths for il in (False, True)]


@pytest.mark.parametrize("ctype,depth,interlace", PNG_KINDS)
def test_png_kind_matches_pil(ctype, depth, interlace):
    rng = np.random.default_rng(ctype * 100 + depth)
    c = CHANNELS[ctype]
    for h, w in SIZES + [(3, 2), (8, 8)]:  # below 8 pixels some Adam7 passes are empty
        px = rng.integers(0, 1 << depth, (h, w, c) if c > 1 else (h, w))
        data = encode_png_any(px, depth, ctype, interlace=interlace, idat_chunks=2)
        _assert_like_pil(decode_png(data, "kind.png"), data)


def test_png_ancillary_chunks_change_nothing():
    """tRNS and gAMA (PIL keeps them in ``info``, not in the array)."""
    rng = np.random.default_rng(4)
    cases = [
        (rng.integers(0, 16, (9, 15)), 4, 3, b"\x00\x80\xff"),
        (rng.integers(0, 65536, (9, 15)), 16, 0, b"\x01\x02"),
        (rng.integers(0, 2, (9, 15)), 1, 0, b"\x00\x01"),
        (rng.integers(0, 256, (9, 15, 3)), 8, 2, b"\x00\x01\x00\x02\x00\x03"),
    ]
    for px, depth, ctype, trns in cases:
        data = encode_png_any(px, depth, ctype, interlace=True, trns=trns)
        iend = data.rindex(b"IEND") - 4
        data = data[:iend] + chunk(b"gAMA", struct.pack(">I", 45455)) + data[iend:]
        _assert_like_pil(decode_png(data, "trns.png"), data)


def _scans_cut(data, keep):
    """``data`` (a progressive JPEG) ending after its first ``keep`` scans:
    the later scans, which refine the coefficients, are left out."""
    pos, scans = 2, 0
    while True:
        marker = data[pos + 1]
        if marker == 0xDA:
            scans += 1
            end = pos + 2 + int.from_bytes(data[pos + 2 : pos + 4], "big")
            while not (data[end] == 0xFF and data[end + 1] not in (0x00, *range(0xD0, 0xD8))):
                end += 1
            if scans == keep:
                return data[:end] + b"\xff\xd9"
            pos = end
        else:
            pos += 2 + int.from_bytes(data[pos + 2 : pos + 4], "big")


def _png_header(depth, ctype):
    """A PNG whose IHDR says ``depth`` and ``ctype`` over an 8-bit gray image."""
    data = encode_png_any(np.zeros((3, 4), np.uint8), 8, 0)
    end = 8 + 25  # the signature and the IHDR chunk
    return data[:8] + chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 3, depth, ctype, 0, 0, 0)) + data[end:]


def _cmyk_jpeg(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).convert("CMYK").save(buf, format="JPEG")
    return buf.getvalue()


def _sof_set(data, offset, value):
    """``data`` with byte ``offset`` of its SOF0 segment set to ``value``."""
    i = data.index(b"\xff\xc0") + 2 + offset
    return data[:i] + bytes([value]) + data[i + 1 :]


REFUSALS = {
    "arith_sof9.jpg": (lambda a: _pil_jpeg(a).replace(b"\xff\xc0", b"\xff\xc9", 1), "arithmetic-coded JPEG \\(SOF9"),
    "arith_sof10.jpg": (lambda a: _pil_jpeg(a, progressive=True).replace(b"\xff\xc2", b"\xff\xca", 1),
                        "arithmetic-coded JPEG \\(SOF10"),
    "arith_dac.jpg": (lambda a: _pil_jpeg(a).replace(b"\xff\xc0", b"\xff\xcc\x00\x04\x01\x10\xff\xc0", 1),
                      "a DAC marker"),
    "lossless.jpg": (lambda a: _pil_jpeg(a).replace(b"\xff\xc0", b"\xff\xc3", 1), "lossless JPEG"),
    "hierarchical.jpg": (lambda a: _pil_jpeg(a).replace(b"\xff\xc0", b"\xff\xc5", 1), "hierarchical JPEG \\(SOF5"),
    "twelve_bit.jpg": (lambda a: _sof_set(_pil_jpeg(a), 2, 12), "12-bit samples"),
    "cmyk.jpg": (lambda a: _cmyk_jpeg(a), "4 components"),
    "eleven_blocks.jpg": (lambda a: encode_baseline(a, ((4, 2), (2, 1), (1, 1))), "11 blocks per MCU"),
    "fractional.jpg": (lambda a: encode_baseline(a, ((3, 1), (2, 1), (1, 1))), "fractional sampling"),
    "unsent_bits.jpg": (lambda a: _scans_cut(_pil_jpeg(a, progressive=True), 4), "progressive scans leave bits"),
    "palette16.png": (lambda a: _png_header(16, 3), "bit depth 16, color type 3"),
    "gray3.png": (lambda a: _png_header(3, 0), "bit depth 3, color type 0"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refused_kinds_name_the_file(name, tmp_path):
    make, message = REFUSALS[name]
    path = tmp_path / name
    path.write_bytes(make(_image(43, 61, seed=3)))
    with pytest.raises(ValueError, match=f"{name}: .*{message}"):
        read_image(str(path))


def test_pil_reads_progressive_scans_left_unsent():
    """The progressive refusal is of a kind PIL reads (JAX fits it): PIL's
    libjpeg-turbo smooths the blocks whose coefficient bits are unsent, which
    the port does not, so it refuses the file rather than give other bits."""
    data = _pil_jpeg(_image(43, 61, seed=3), progressive=True)
    cut = _scans_cut(data, 4)
    assert _pil(cut).shape == _pil(data).shape and not np.array_equal(_pil(cut), _pil(data))
    with pytest.raises(ValueError, match="cut.jpg: progressive scans leave bits"):
        decode_jpeg(cut, "cut.jpg")


@pytest.fixture(scope="module")
def small_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kinds"))
    return write_disk_sequence(root, num_views=2, num_frames=1, rows=6, cols=6, width=32, height=48, ratio=2,
                               device="cpu")


def _rewrite(roots, seq, rewrite):
    """Every view and parsing image of sequence ``seq`` under ``roots``
    (working and dense) turned by ``rewrite(path, pixels)`` into a new file;
    the old one removed when the name changed."""
    for base in roots:
        for dirpath, _, files in os.walk(os.path.join(base, seq)):
            for f in files:
                if f.endswith(".png"):
                    path = os.path.join(dirpath, f)
                    with Image.open(path) as im:
                        px = np.asarray(im)
                    new = rewrite(path, px)
                    if new != path:
                        os.remove(path)


def _progressive(path, px):
    new = path[:-4] + ".jpg"
    Image.fromarray(px).save(new, format="JPEG", progressive=True, quality=90, subsampling=0)
    return new


def _sixteen_bit(path, px):
    low = np.random.default_rng(len(path)).integers(0, 256, px.shape)
    with open(path, "wb") as fh:
        fh.write(encode_png_any(px.astype(np.uint16) * 256 + low, 16, 2, interlace=True))
    return path


@pytest.mark.parametrize("rewrite", [_progressive, _sixteen_bit], ids=["progressive_jpeg", "png16_adam7"])
def test_tree_frame_matches_jax(small_tree, tmp_path, rewrite):
    root = str(tmp_path / "t")
    shutil.copytree(small_tree.input_dir, root)
    shutil.copytree(small_tree.dense_input_dir, root + "_dense")
    _rewrite([root, root + "_dense"], small_tree.seq, rewrite)
    cfgs = []
    for c in (Config(), JConfig()):
        c.data.input_dir, c.data.dense_input_dir, c.data.seq = root, root + "_dense", small_tree.seq
        c.data.down_ratio, c.data.dense_down_ratio, c.data.use_mask, c.data.use_mask_dense = 2, 1, True, True
        cfgs.append(c)
    src, jsrc = DiskSequence(cfgs[0], device="cpu"), JDiskSequence(cfgs[1])
    assert src.view_files == jsrc.view_files and all(f.endswith(".jpg" if rewrite is _progressive else ".png")
                                                    for f in src.view_files)
    for full in (False, True):
        got, want = src.frame(1, full_res=full), jsrc.frame(1, full_res=full)
        np.testing.assert_array_equal(frame_tensor(got.images, "cpu").numpy(), want.images)
        np.testing.assert_array_equal(frame_tensor(got.masks, "cpu").numpy(), want.masks)
