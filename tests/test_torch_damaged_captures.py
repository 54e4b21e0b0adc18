"""Damaged and cut-off captures, read by the port's loader (``read_image``:
``csrc/imgdec.c`` for JPEG, ``utils/png.py`` for PNG) as the JAX loader
reads them, ``np.asarray(PIL.Image.open(path))``: the same array, or both
raise, the port with a ``ValueError`` that names the file.

The cases are the fixtures' damaged copies (``fixtures.DAMAGED``), each
also held to its manifest record, which the card's host (no PIL) checks
(``chip_smoke.py`` phase 13d):

- J1: a sequential, arithmetic or progressive JPEG cut at 30-99% of its
  bytes, or without its last 2 (EOI) or 10 bytes: PIL raises "image file is
  truncated";
- J2 / J4: a sequential / progressive JPEG cut at 60% and closed by an EOI
  marker: libjpeg-turbo skips the MCUs after the one that read past the
  data (gray; progressive coefficients kept), and smooths a progressive
  file's rows past the cut with the previous scan's record;
- J3: a JPEG with restart markers, one FF D2 deleted;
- P1-P4: a PNG cut inside IEND; a bad CRC on IHDR (raises), IDAT, IEND or
  a tEXt chunk after IDAT (PIL checks CRCs only before IDAT); a zlib stream
  with more data than the image needs, without its Adler-32, with a bad one
  or cut short; IDAT chunks split by a tEXt chunk (PIL reads only the first
  run of IDAT chunks).

Sweeps settle each rule on many cut points: every cut through the last
300 bytes of small sequential files (with and without restarts, Huffman
and arithmetic) and a stride through the rest; cuts closed by EOI through
progressive and sequential files; each restart marker deleted or
renumbered; random small PIL files without their last 1-9 bytes, some of
which PIL reads (libjpeg's bit reader reads at most 8 bytes ahead, and
only where it needs them); PNG cuts; 1-3 bytes of entropy-coded data set
at random (a code no table holds takes 17 bits; a marker the damage makes
ends the scan, and PIL raises on the reserved and repeated ones that
libjpeg meets as it reads on to EOI). A tree with damaged views reads
through the port's ``DiskSequence`` as through JAX's.
"""

import io
import os
import re
import shutil

import numpy as np
import pytest
from PIL import Image

from topo4d_tpu.config import Config as JConfig
from topo4d_tpu.pipeline.data import DiskSequence as JDiskSequence

from topo4d_tpu_torch import fixtures
from topo4d_tpu_torch.config import Config
from topo4d_tpu_torch.fixtures.__main__ import pil_decode
from topo4d_tpu_torch.pipeline.data import DiskSequence, frame_tensor, read_image
from topo4d_tpu_torch.testing import write_disk_sequence


def _hold(data, path):
    """``data`` written to ``path`` and read by both, the port and the JAX
    loader's ``np.asarray(Image.open(...))`` (``pil_decode``): the same
    array, or both raise, the port's error a ``ValueError`` naming the file.
    -> PIL's array or None."""
    with open(path, "wb") as fh:
        fh.write(data)
    want = pil_decode(data)
    if want is None:
        with pytest.raises(ValueError, match=f"^{re.escape(path)}: "):
            read_image(path)
        return None
    got = read_image(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return want


def _cases(ext):
    return [(name, case) for name, cases in fixtures.DAMAGED.items() if name.endswith(ext) for case in cases]


def _hold_case(name, case, tmp_path):
    stem, ext = os.path.splitext(name)
    want = _hold(fixtures.damaged(name, case), str(tmp_path / f"{stem}.{case}{ext}"))
    assert fixtures.manifest()[name]["damaged"][case] == fixtures.damaged_outcome(want)


@pytest.mark.parametrize("name,case", _cases(".jpg"), ids=[f"{n}:{c}" for n, c in _cases(".jpg")])
def test_damaged_jpeg_matches_pil(name, case, tmp_path):
    _hold_case(name, case, tmp_path)


@pytest.mark.parametrize("name,case", _cases(".png"), ids=[f"{n}:{c}" for n, c in _cases(".png")])
def test_damaged_png_matches_pil(name, case, tmp_path):
    _hold_case(name, case, tmp_path)


def _cut_points(data, stride, tail=300, eoi=False):
    """From the first SOS (or the first IDAT) to the end: every ``stride``-th
    byte, and every byte of the last ``tail``."""
    first = data.find(b"\xff\xda") if data[:2] == b"\xff\xd8" else data.find(b"IDAT") - 4
    end = len(data) - (2 if eoi else 0)
    return sorted(set(range(first, end, stride)) | set(range(max(first, end - tail), end)))


def _restart_markers(data):
    sos = data.find(b"\xff\xda")
    return [i for i in range(sos, len(data) - 1) if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]


def _sweep(name, kind):
    with open(fixtures.path(name), "rb") as fh:
        data = fh.read()
    if kind == "cut":
        return [data[:c] for c in _cut_points(data, 97)]
    if kind == "cut_eoi":
        return [data[:c] + b"\xff\xd9" for c in _cut_points(data, 41, tail=60, eoi=True)]
    if kind == "restart_deleted":
        return [data[:i] + data[i + 2 :] for i in _restart_markers(data)]
    if kind == "restart_renumbered":
        return [data[: i + 1] + bytes([0xD0 + (data[i + 1] + 3) % 8]) + data[i + 2 :] for i in _restart_markers(data)]
    assert kind == "flip"
    rng = np.random.default_rng(len(data))
    first, files = data.rfind(b"\xff\xda") + 20, []
    for _ in range(150):  # 1-3 bytes of the entropy-coded data set at random
        d = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            d[int(rng.integers(first, len(d) - 2))] = int(rng.integers(0, 256))
        files.append(bytes(d))
    return files


SWEEPS = {
    "sequential_cuts": ("view_263x199_q85_440.jpg", "cut"),
    "restart_cuts": ("view_263x199_q85_411.jpg", "cut"),
    "arithmetic_cuts": ("libjpeg_61x43_q85_420_arith.jpg", "cut"),
    "sequential_cuts_closed": ("view_263x199_q85_440.jpg", "cut_eoi"),
    "progressive_cuts_closed": ("view_259x195_q90_444_progressive.jpg", "cut_eoi"),
    "gray_progressive_cuts_closed": ("gray_257x193_q85_progressive.jpg", "cut_eoi"),
    "arithmetic_progressive_cuts_closed": ("view_259x195_q85_444_arith_progressive_ac1_9_partial.jpg", "cut_eoi"),
    "restarts_deleted": ("view_263x199_q85_411.jpg", "restart_deleted"),
    "restarts_renumbered": ("view_263x199_q85_411.jpg", "restart_renumbered"),
    "png_cuts": (fixtures.PNG8, "cut"),
    "sequential_flips": ("view_263x199_q85_440.jpg", "flip"),
    "restart_flips": ("view_263x199_q85_411.jpg", "flip"),
    "progressive_flips": ("view_259x195_q90_444_progressive.jpg", "flip"),
    "arithmetic_flips": ("view_261x197_q85_420_arith_dac.jpg", "flip"),
}


@pytest.mark.parametrize("sweep", list(SWEEPS))
def test_damage_sweeps_match_pil(sweep, tmp_path):
    name, kind = SWEEPS[sweep]
    files = _sweep(name, kind)
    outcomes = [_hold(data, str(tmp_path / f"{i}{os.path.splitext(name)[1]}")) for i, data in enumerate(files)]
    assert len(files) >= 30
    if kind.startswith("restart") or kind in ("cut_eoi", "flip"):
        assert sum(o is not None for o in outcomes) > len(files) // 2  # mostly read: the damage is held, not refused


EOI = b"\xff\xd9"
# what follows a sequential file's one scan in place of its EOI: PIL's
# jpeg_finish_decompress reads it (up to EOI, or the end of the data), and
# raises on a reserved or repeated marker or a bad table, while a segment
# the end cuts raises only if libjpeg fails on the bytes there are
AFTER_SCAN = {
    "reserved_marker": b"\xff\x8c" + EOI,
    "second_soi": b"\xff\xd8" + EOI,
    "second_frame_header_cut": b"\xff\xc0\x7f\xff\x08\x00\x10\x00\x10\x03",
    "second_frame_header_cut_short": b"\xff\xc2\x7f",
    "dac_bad_index_cut": b"\xff\xcc\x7f\xff\x40\x00",
    "dac_cut": b"\xff\xcc\x7f\xff\x01\x11",
    "dht_over_full_count_cut": b"\xff\xc4\x7f\xff\x00" + bytes([255] * 16),
    "dht_cut": b"\xff\xc4\x7f\xff\x00\x00\x01" + bytes(14) + b"\x00",
    "dri_long": b"\xff\xdd\x00\x05\x00\x01\x00" + EOI,
    "dri_cut": b"\xff\xdd\x7f\xff",
    "dqt_bad_index_cut": b"\xff\xdb\x7f\xff\x05",
    "sos_bad_length_cut": b"\xff\xda\x7f\xff\x01",
    "app_cut": b"\xff\xe1\x7f\xffExif",
    "comment": b"\xff\xfe\x00\x05abc" + EOI,
    "dnl": b"\xff\xdc\x00\x04\x00\x10" + EOI,
    "junk": b"junk" + EOI,
}


def _dht(index, bits, vals):
    """A DHT segment of one table: class and id ``index``, code counts
    ``bits`` per length 1-16, values ``vals``."""
    body = bytes([index]) + bytes(bits) + bytes(vals)
    return b"\xff\xc4" + (len(body) + 2).to_bytes(2, "big") + body


DC_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]  # the Annex K luminance DC table
# a table put in just before the scan: checked when the scan uses it
TABLES = {
    "dc_table_all_ones_code": _dht(0x00, DC_BITS[:8] + [2] + DC_BITS[9:], range(13)),
    "dc_table_value_above_15": _dht(0x00, DC_BITS, list(range(11)) + [16]),
    "unused_table_all_ones_code": _dht(0x13, DC_BITS[:8] + [2] + DC_BITS[9:], range(13)),
}


@pytest.mark.parametrize("case", list(AFTER_SCAN) + list(TABLES))
def test_markers_and_tables_match_pil(case, tmp_path):
    with open(fixtures.path("view_263x199_q85_440.jpg"), "rb") as fh:
        data = fh.read()
    if case in AFTER_SCAN:
        data = data[:-2] + AFTER_SCAN[case]
    else:
        sos = data.rfind(b"\xff\xda")
        data = data[:sos] + TABLES[case] + data[sos:]
    _hold(data, str(tmp_path / "t.jpg"))


def test_truncated_small_files_match_pil(tmp_path):
    """Random small PIL files (gray and RGB, each sampling, some with
    restart intervals) without their last 1-9 bytes. PIL reads 16 of these
    1,200 cuts: libjpeg's bit reader never needed the lost bytes."""
    rng = np.random.default_rng(17)
    read = total = 0
    for i in range(240):
        h, w = rng.integers(8, 64, 2)
        img = rng.integers(0, 256, (h, w, 3), np.uint8) if i % 2 else rng.integers(60, 200, (h, w), np.uint8)
        save = {"quality": int(rng.integers(30, 100))}
        if i % 2:
            save["subsampling"] = int(rng.integers(0, 3))
        if i % 3 == 0:
            save["restart_marker_blocks"] = int(rng.integers(1, 30))
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", **save)
        data = buf.getvalue()
        for k in (1, 2, 3, 5, 9):
            read += _hold(data[:-k], str(tmp_path / "t.jpg")) is not None
            total += 1
    assert 0 < read < total // 5


@pytest.fixture(scope="module")
def small_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("damaged"))
    return write_disk_sequence(root, num_views=2, num_frames=1, rows=6, cols=6, width=32, height=48, ratio=2,
                               device="cpu")


def _damage_tree(tree, root, damage):
    """A copy of ``tree`` under ``root`` whose views (not their parsing
    images) are ``damage(png bytes, pixels)`` -> (bytes, extension)."""
    shutil.copytree(tree.input_dir, root)
    shutil.copytree(tree.dense_input_dir, root + "_dense")
    for base in (root, root + "_dense"):
        fdir = os.path.join(base, tree.seq, "000001")
        for f in sorted(os.listdir(fdir)):
            path = os.path.join(fdir, f)
            with open(path, "rb") as fh:
                png = fh.read()
            data, ext = damage(png, np.asarray(Image.open(io.BytesIO(png))))
            os.remove(path)
            with open(path[:-4] + ext, "wb") as fh:
                fh.write(data)


def _jpeg(px, **save):
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, format="JPEG", quality=90, **save)
    return buf.getvalue()


def _cut(data, eoi):
    """``data`` cut at 60% of the bytes from its first SOS on (a small
    view's tables take half its bytes), closed by EOI or not."""
    sos = data.find(b"\xff\xda")
    return data[: sos + (len(data) - sos) * 6 // 10] + (b"\xff\xd9" if eoi else b"")


DAMAGES = {
    "jpeg_cut_closed": lambda png, px: (_cut(_jpeg(px), True), ".jpg"),
    "progressive_cut_closed": lambda png, px: (_cut(_jpeg(px, progressive=True), True), ".jpg"),
    "png_bad_idat_crc": lambda png, px: (png[:-13] + bytes([png[-13] ^ 1]) + png[-12:], ".png"),
    "jpeg_cut": lambda png, px: (_cut(_jpeg(px), False), ".jpg"),
}


@pytest.mark.parametrize("damage", list(DAMAGES))
def test_damaged_tree_reads_as_jax(small_tree, tmp_path, damage):
    root = str(tmp_path / "t")
    _damage_tree(small_tree, root, DAMAGES[damage])
    cfgs = []
    for c in (Config(), JConfig()):
        c.data.input_dir, c.data.dense_input_dir, c.data.seq = root, root + "_dense", small_tree.seq
        c.data.down_ratio, c.data.dense_down_ratio, c.data.use_mask, c.data.use_mask_dense = 2, 1, True, True
        cfgs.append(c)
    src, jsrc = DiskSequence(cfgs[0], device="cpu"), JDiskSequence(cfgs[1])
    for full in (False, True):
        if damage == "jpeg_cut":
            with pytest.raises(OSError, match="truncated"):
                jsrc.frame(1, full_res=full)
            with pytest.raises(ValueError, match="image file is truncated"):
                src.frame(1, full_res=full)
            continue
        got, want = src.frame(1, full_res=full), jsrc.frame(1, full_res=full)
        np.testing.assert_array_equal(frame_tensor(got.images, "cpu").numpy(), want.images)
        np.testing.assert_array_equal(frame_tensor(got.masks, "cpu").numpy(), want.masks)
