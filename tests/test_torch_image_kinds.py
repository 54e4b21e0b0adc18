"""Every image kind the JAX loader reads through PIL, read by the port's
decoders (``utils/jpeg.py`` over ``csrc/imgdec.c``, ``utils/png.py``) as
``np.asarray(PIL.Image.open(f))`` gives it: shape, dtype and bytes.

JPEG at odd sizes (partial MCUs): progressive files PIL writes (4:2:0,
4:2:2, 4:4:4, gray, restart intervals, optimized tables), cut after every
one of their scans (coefficient bits left unsent, which libjpeg-turbo
smooths), arithmetic-coded files from the fixtures' writer (sequential and
progressive, at six samplings, with and without restarts and DAC
conditioning, cut after every scan too, and under scan scripts PIL never
writes), PIL's files with
an Adobe APP14 marker spliced in place of the JFIF one (transforms 0, 1 and
an unknown one), PIL's ``keep_rgb`` files, and files from the fixtures'
baseline writer at samplings PIL cannot write (4:4:0, 4:1:1, 4:1:0, 3x1,
1x4, 2x4, chroma finer than luma, mixed) and with 'R', 'G', 'B' or unknown
component ids. PNG: all 15 (colour type, bit depth) pairs, each with and
without Adam7, from the fixtures' NumPy writer, at sizes with empty passes
too, and with ancillary chunks. A progressive tree and a 16-bit PNG tree
read by the port's ``DiskSequence`` and by JAX's, equal after the division,
and so are an arithmetic-coded tree and a tree of progressive files cut
after their DC scan. Each kind still refused raises ``ValueError`` naming
the file, and PIL fails on the same bytes (CMYK apart, which PIL reads as
four channels): lossless and hierarchical files (Huffman and arithmetic),
12-bit samples, two components, more than 10 blocks per MCU, fractional
sampling, a DNL-sized frame, bad DAC segments, a PNG header PNG does not
allow.
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
from topo4d_tpu_torch.fixtures.__main__ import keep_scans, splice_adobe
from topo4d_tpu_torch.fixtures.jpeg_writer import encode_baseline, encode_scans
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


def _segment_before_sof(data, marker, body):
    """``data`` (PIL's baseline file) with a segment spliced in before its
    SOF0 marker."""
    return data.replace(b"\xff\xc0", bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body + b"\xff\xc0", 1)


def _dnl(data):
    """A frame of height 0 whose DNL segment, after the scan, gives 43 rows."""
    data = _sof_set(_sof_set(data, 3, 0), 4, 0)
    eoi = data.rindex(b"\xff\xd9")
    return data[:eoi] + b"\xff\xdc\x00\x04\x00\x2b" + data[eoi:]


# name -> (bytes from the 61x43 test image, the port's message)
REFUSALS = {
    "lossless.jpg": (lambda a: _pil_jpeg(a).replace(b"\xff\xc0", b"\xff\xc3", 1), "lossless JPEG \\(SOF3"),
    "lossless_arith.jpg": (lambda a: _pil_jpeg(a).replace(b"\xff\xc0", b"\xff\xcb", 1), "lossless JPEG \\(SOF11"),
    "hierarchical.jpg": (lambda a: _pil_jpeg(a).replace(b"\xff\xc0", b"\xff\xc5", 1), "hierarchical JPEG \\(SOF5"),
    "hierarchical_arith.jpg": (lambda a: _pil_jpeg(a).replace(b"\xff\xc0", b"\xff\xcd", 1),
                               "hierarchical JPEG \\(SOF13"),
    "twelve_bit.jpg": (lambda a: _sof_set(_pil_jpeg(a), 2, 12), "12-bit samples"),
    "two_components.jpg": (lambda a: _sof_set(_pil_jpeg(a), 7, 2), "2 components"),
    "cmyk.jpg": (lambda a: _cmyk_jpeg(a), "4 components"),
    "eleven_blocks.jpg": (lambda a: encode_baseline(a, ((4, 2), (2, 1), (1, 1))), "11 blocks per MCU"),
    "fractional.jpg": (lambda a: encode_baseline(a, ((3, 1), (2, 1), (1, 1))), "fractional sampling"),
    "dnl.jpg": (lambda a: _dnl(_pil_jpeg(a)), "DNL"),
    "dac_l_above_u.jpg": (lambda a: _segment_before_sof(_pil_jpeg(a), 0xCC, b"\x00\x12"), "bad DAC segment \\(DC L 2"),
    "dac_odd_length.jpg": (lambda a: _segment_before_sof(_pil_jpeg(a), 0xCC, b"\x00\x10\x01"),
                           "bad DAC segment \\(odd length"),
    "dac_table_32.jpg": (lambda a: _segment_before_sof(_pil_jpeg(a), 0xCC, b"\x20\x10"),
                         "bad DAC segment \\(table index 32"),
    "palette16.png": (lambda a: _png_header(16, 3), "bit depth 16, color type 3"),
    "gray3.png": (lambda a: _png_header(3, 0), "bit depth 3, color type 0"),
}
# why PIL's failure is not shown on these bytes
PIL_READS = {"cmyk.jpg": "PIL reads CMYK as four channels; the loader's views are three-channel RGB"}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refused_kinds_name_the_file(name, tmp_path):
    make, message = REFUSALS[name]
    path = tmp_path / name
    path.write_bytes(make(_image(43, 61, seed=3)))
    if name not in PIL_READS:
        with pytest.raises(OSError):  # PIL (so JAX's loader) fails on the same bytes
            _pil(path.read_bytes())
    with pytest.raises(ValueError, match=f"{name}: .*{message}"):
        read_image(str(path))


# kinds the port refused before it read arithmetic coding and smoothed
# unsent bits: Huffman bytes under an arithmetic frame header (junk, the
# same junk as PIL's: a bad code leaves the rest of the scan unread), a DAC
# segment in a Huffman file, a progressive file cut after its fourth scan
ONCE_REFUSED = {
    "arith_sof9.jpg": lambda a: _pil_jpeg(a).replace(b"\xff\xc0", b"\xff\xc9", 1),
    "arith_sof10.jpg": lambda a: _pil_jpeg(a, progressive=True).replace(b"\xff\xc2", b"\xff\xca", 1),
    "arith_dac.jpg": lambda a: _pil_jpeg(a).replace(b"\xff\xc0", b"\xff\xcc\x00\x04\x01\x10\xff\xc0", 1),
    "unsent_bits.jpg": lambda a: keep_scans(_pil_jpeg(a, progressive=True), 4),
}


@pytest.mark.parametrize("name", list(ONCE_REFUSED))
def test_once_refused_kinds_match_pil(name, tmp_path):
    path = tmp_path / name
    path.write_bytes(ONCE_REFUSED[name](_image(43, 61, seed=3)))
    _assert_like_pil(read_image(str(path)), path.read_bytes())


def test_pil_reads_progressive_scans_left_unsent():
    """PIL's libjpeg-turbo smooths the blocks whose coefficient bits are
    unsent, so a cut file decodes to other pixels than the whole file; the
    port smooths them alike."""
    data = _pil_jpeg(_image(43, 61, seed=3), progressive=True)
    cut = keep_scans(data, 4)
    assert _pil(cut).shape == _pil(data).shape and not np.array_equal(_pil(cut), _pil(data))
    _assert_like_pil(decode_jpeg(cut, "cut.jpg"), cut)


SAMPLINGS = {"420": ((2, 2), (1, 1), (1, 1)), "422": ((2, 1), (1, 1), (1, 1)), "444": ((1, 1), (1, 1), (1, 1)),
             "440": ((1, 2), (1, 1), (1, 1)), "411": ((4, 1), (1, 1), (1, 1)), "gray": ((1, 1),)}
CONDITIONING = ((2, 6, 2), (1, 4, 12))  # (DC L, DC U, AC Kx) of the luma and chroma tables: not the defaults


@pytest.mark.parametrize("sampling", list(SAMPLINGS))
@pytest.mark.parametrize("progressive", [False, True], ids=["sof9", "sof10"])
def test_arithmetic_matches_pil(progressive, sampling):
    """The writer's arithmetic files with no restarts, a restart every MCU
    and every 3 MCUs, at default and at other conditioning values (a DAC
    segment). Each also decodes to the bits of the baseline file of the
    same coefficients: a scan that stopped early, which PIL would read
    alike, fails there."""
    img = _image(43, 61, seed=len(sampling) + progressive)
    img = img[..., 0] if sampling == "gray" else img
    baseline = decode_jpeg(encode_baseline(img, SAMPLINGS[sampling]), sampling)
    for restart in (0, 1, 3):
        for cond in (None, CONDITIONING):
            data = encode_scans(img, SAMPLINGS[sampling], arithmetic=True, progressive=progressive, restart=restart,
                                conditioning=cond)
            assert bytes([0xFF, 0xCA if progressive else 0xC9]) in data
            assert (b"\xff\xcc" in data) == (cond is not None) and (b"\xff\xdd" in data) == bool(restart)
            got = decode_jpeg(data, sampling)
            _assert_like_pil(got, data)
            np.testing.assert_array_equal(got, baseline)


def _restart_markers(data):
    """The offsets of the RSTn markers in ``data``'s entropy-coded segments."""
    return [k for k in range(data.index(b"\xff\xda"), len(data) - 1)
            if data[k] == 0xFF and 0xD0 <= data[k + 1] <= 0xD7]


@pytest.mark.parametrize("damage", ["deleted", "renumbered", "doubled", "junk_before"])
def test_arithmetic_damaged_restarts_match_pil(damage):
    """A restart marker missing, misnumbered, repeated or preceded by junk
    bytes: the decoder resyncs as libjpeg's jpeg_resync_to_restart does
    (the interval whose marker is lost reads as zeros)."""
    rng = np.random.default_rng(len(damage))
    for progressive in (False, True):
        data = encode_scans(_image(43, 61, seed=5), arithmetic=True, progressive=progressive, restart=2)
        for k in _restart_markers(data)[::3]:
            if damage == "deleted":
                bad = data[:k] + data[k + 2 :]
            elif damage == "renumbered":
                bad = data[:k + 1] + bytes([0xD0 + int(rng.integers(0, 8))]) + data[k + 2 :]
            elif damage == "doubled":
                bad = data[:k + 2] + data[k : k + 2] + data[k + 2 :]
            else:
                bad = data[:k] + bytes(rng.integers(1, 255, 3).tolist()) + data[k:]
            _assert_like_pil(decode_jpeg(bad, damage), bad)


CUT_KINDS = {
    "pil_420": lambda a: _pil_jpeg(a, progressive=True),
    "pil_gray": lambda a: _pil_jpeg(a[..., 0], progressive=True, quality=95),
    "pil_444_restart": lambda a: _pil_jpeg(a, progressive=True, subsampling=0, restart_marker_blocks=2),
    "arith_420": lambda a: encode_scans(a, arithmetic=True),
    "arith_gray": lambda a: encode_scans(a[..., 0], arithmetic=True),
    "arith_422_restart": lambda a: encode_scans(a, SAMPLINGS["422"], arithmetic=True, restart=2),
}
# the writer's kinds -> the baseline file of the same coefficients
CUT_BASELINES = {
    "arith_420": lambda a: encode_baseline(a),
    "arith_gray": lambda a: encode_baseline(a[..., 0]),
    "arith_422_restart": lambda a: encode_baseline(a, SAMPLINGS["422"]),
}


@pytest.mark.parametrize("kind", list(CUT_KINDS))
def test_progressive_cut_at_every_scan_matches_pil(kind):
    """The default progressive script (libjpeg's jpeg_simple_progression)
    cut after each of its scans: DC alone (the DC smoothed too), DC and
    some AC bands, unrefined bits; and the whole file, which for the
    writer's kinds also equals the baseline file of its coefficients."""
    for h, w in ((43, 61), (17, 40)):  # 17 rows: the last iMCU row of 4:2:0 luma has one block row
        img = _image(h, w, seed=h + len(kind))
        data = CUT_KINDS[kind](img)
        scans = data.count(b"\xff\xda")
        assert scans == (6 if "gray" in kind else 10)
        for keep in range(1, scans + 1):
            cut = keep_scans(data, keep)
            got = decode_jpeg(cut, f"{kind}_{keep}")
            _assert_like_pil(got, cut)
        if kind in CUT_BASELINES:
            np.testing.assert_array_equal(got, decode_jpeg(CUT_BASELINES[kind](img), kind))


SCRIPTS = {
    # DC, then AC 1-9 of each component: coefficients 10-63 never sent,
    # which libjpeg-turbo does not smooth
    "ac10_63_unsent": [((0, 1, 2), 0, 0, 0, 0)] + [((c,), 1, 9, 0, 0) for c in range(3)],
    "ac1_9_lowest_bit_unsent": [((0, 1, 2), 0, 0, 0, 0), ((0,), 1, 9, 0, 2), ((1,), 1, 9, 0, 1), ((2,), 1, 9, 0, 1),
                                ((0,), 10, 63, 0, 0), ((0,), 1, 9, 2, 1)],
    "dc_point_transform_3": [((0, 1, 2), 0, 0, 0, 3)],
    "ac1_2_only": [((0, 1, 2), 0, 0, 0, 0), ((0,), 1, 2, 0, 0), ((1,), 1, 2, 0, 1), ((2,), 1, 2, 0, 0)],
    "cb_dc_never": [((0,), 0, 0, 0, 0), ((2,), 0, 0, 0, 0), ((0,), 1, 63, 0, 0), ((1,), 1, 63, 0, 0)],
    "cb_in_no_scan": [((0, 2), 0, 0, 0, 0), ((0,), 1, 63, 0, 0), ((2,), 1, 63, 0, 0)],
    "ac_before_dc": [((0,), 1, 5, 0, 0), ((0, 1, 2), 0, 0, 0, 0)],
    # complete scripts: every bit of every coefficient sent
    "spectral_bands": [((0, 1, 2), 0, 0, 0, 0)] + [((c,), lo, hi, 0, 0) for c in range(3)
                                                   for lo, hi in ((1, 1), (2, 5), (6, 20), (21, 63))],
    "every_bit_refined": [((0, 1, 2), 0, 0, 0, 2)] + [((c,), 1, 63, 0, 3) for c in range(3)]
                         + [((0, 1, 2), 0, 0, 2, 1), ((0, 1, 2), 0, 0, 1, 0)]
                         + [((c,), 1, 63, ah, ah - 1) for ah in (3, 2, 1) for c in range(3)],
}
COMPLETE_SCRIPTS = ("spectral_bands", "every_bit_refined")


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_scan_scripts_match_pil(script):
    """Progressive scripts PIL never writes, Huffman and arithmetic; where
    a component's DC is never sent nothing is smoothed, as in libjpeg-turbo.
    A complete script decodes to the bits of the baseline file of the same
    coefficients."""
    img = _image(43, 61, seed=3)
    for arithmetic in (False, True):
        data = encode_scans(img, arithmetic=arithmetic, scans=SCRIPTS[script])
        got = decode_jpeg(data, script)
        _assert_like_pil(got, data)
        if script in COMPLETE_SCRIPTS:
            np.testing.assert_array_equal(got, decode_jpeg(encode_baseline(img), script))


@pytest.mark.parametrize("factors", [(2, 2), (1, 2), (1, 4)])
def test_gray_declared_sampling_cut_matches_pil(factors):
    """A gray file whose frame declares other factors than 1x1: the blocks
    are the same, but libjpeg-turbo's smoothing counts block rows by iMCU
    rows of the declared height."""
    for h in (17, 25, 41):
        data = encode_scans(_image(h, 21, seed=h)[..., 0], (factors,), arithmetic=h == 25)
        for keep in range(1, 7):
            cut = keep_scans(data, keep)
            _assert_like_pil(decode_jpeg(cut, f"gray_{h}_{keep}"), cut)


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


def _arithmetic(path, px):
    new = path[:-4] + ".jpg"
    with open(new, "wb") as fh:
        fh.write(encode_scans(px, ((2, 1), (1, 1), (1, 1)), arithmetic=True, progressive=len(path) % 2 == 0,
                              restart=3))
    return new


def _dc_only(path, px):
    new = path[:-4] + ".jpg"
    with open(new, "wb") as fh:
        fh.write(keep_scans(_pil_jpeg(px, progressive=True, quality=90), 1))
    return new


@pytest.mark.parametrize("rewrite", [_progressive, _sixteen_bit, _arithmetic, _dc_only],
                         ids=["progressive_jpeg", "png16_adam7", "arithmetic_jpeg", "progressive_dc_only"])
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
    assert src.view_files == jsrc.view_files and all(f.endswith(".png" if rewrite is _sixteen_bit else ".jpg")
                                                    for f in src.view_files)
    for full in (False, True):
        got, want = src.frame(1, full_res=full), jsrc.frame(1, full_res=full)
        np.testing.assert_array_equal(frame_tensor(got.images, "cpu").numpy(), want.images)
        np.testing.assert_array_equal(frame_tensor(got.masks, "cpu").numpy(), want.masks)
