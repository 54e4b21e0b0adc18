"""The disk sequence of ``topo4d_tpu_torch/pipeline/data.py`` and the asset
loaders against the JAX package's, on the CPU.

In both directions, exact: JAX's ``scripts/fabricate_dataset.py`` tree (as
``tests/test_data_loader.py`` builds it) and the port's
``write_disk_sequence`` tree (views named after rotated cameras, one not
rotated, a ``<components>`` transform) are read by both loaders at working
and full resolution with masks on: images and masks bit for bit, view
names, ``trans_g`` and the cameras exactly (float32 fields from the same
float64 calibration), and the port's tree equal to the targets it was
written from (its rig within 1e-6). The port's frames stay on the host
as their files hold them (``HostViews``: uint8 pixels and each view's
quarter turns) and ``frame_tensor`` turns and converts them; its values are
held to JAX's float32 ones. The same tree re-saved by PIL as JPEG (views
and parsing images, at several qualities and chroma samplings) reads alike
too. Then the refusals and degradations (a size mismatch with JAX's
message, a missing mask dir, a missing per-view mask, an arithmetic-coded
``.jpg`` view) and the asset loaders (``load_obj`` with its ``vt``
fallback, ``sample_vertex_colors`` through the port's PNG decoder,
``load_facial_regions``).
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

from topo4d_tpu.config import Config as JConfig
from topo4d_tpu.pipeline.data import DiskSequence as JDiskSequence
from topo4d_tpu.topology.obj_io import load_obj as j_load_obj
from topo4d_tpu.topology.obj_io import sample_vertex_colors as j_sample_vertex_colors
from topo4d_tpu.topology.regions import load_facial_regions as j_load_facial_regions

from topo4d_tpu_torch.config import Config
from topo4d_tpu_torch.pipeline.data import DiskSequence, HostViews, frame_tensor
from topo4d_tpu_torch.testing import write_disk_sequence
from topo4d_tpu_torch.topology.obj_io import load_obj, sample_vertex_colors
from topo4d_tpu_torch.topology.regions import load_facial_regions
from topo4d_tpu_torch.utils.png import read_png

CPU = "cpu"
COMPONENT = np.array([[0.0, -1.0, 0.0, 0.1], [1.0, 0.0, 0.0, 0.2], [0.0, 0.0, 1.0, 0.3], [0.0, 0.0, 0.0, 1.0]])


@pytest.fixture(scope="module")
def jax_tree(tmp_path_factory):
    from fabricate_dataset import fabricate

    root = str(tmp_path_factory.mktemp("jfab"))
    fabricate(root, num_views=2, num_frames=1, rows=6, cols=6, work_w=48, work_h=32, ratio=4)
    return root, 4


@pytest.fixture(scope="module")
def port_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pfab"))
    tree = write_disk_sequence(
        root, num_views=3, num_frames=2, rows=6, cols=6, width=32, height=48, ratio=2,
        view_names=["K98707293", "K98707288", "view02"], component=COMPONENT, device=CPU,
    )
    return tree


def _cfgs(root, ratio, dense_root=None, seq="seq01"):
    out = []
    for c in (Config(), JConfig()):
        c.data.input_dir = root
        c.data.dense_input_dir = dense_root or root + "_dense"
        c.data.seq = seq
        c.data.down_ratio = ratio
        c.data.dense_down_ratio = 1
        c.data.use_mask = True
        c.data.use_mask_dense = True
        out.append(c)
    return out


def _assert_cameras_equal(cam, jcam, atol=0.0):
    assert (cam.width, cam.height, cam.near, cam.far) == (jcam.width, jcam.height, jcam.near, jcam.far)
    for f in ("w2c", "fx", "fy", "cx", "cy"):
        np.testing.assert_allclose(getattr(cam, f).numpy(), np.asarray(getattr(jcam, f)), rtol=0, atol=atol, err_msg=f)


def _unit(x):
    return frame_tensor(x, CPU).numpy()


def test_frame_tensor_divides_as_jax_loader():
    # every uint8 value, and a float32 frame passed through
    x = np.arange(256 * 3, dtype=np.uint16).astype(np.uint8).reshape(1, 3, 16, 16)
    got = frame_tensor(HostViews([np.ascontiguousarray(x[0].transpose(1, 2, 0))], [0]), CPU)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), x.astype(np.float32) / 255.0)
    f = np.linspace(0, 1, 12, dtype=np.float32).reshape(1, 3, 2, 2)
    np.testing.assert_array_equal(frame_tensor(f, CPU).numpy(), f)


def test_frame_tensor_turns_host_views():
    """Each view's quarter turns (np.rot90 over axes (0, 1), any sign) and
    the permute into planes, then the JAX loader's division."""
    rng = np.random.default_rng(3)
    turns = [0, 1, -1, 2, 3]
    planes = rng.integers(0, 256, (len(turns), 3, 5, 5), dtype=np.uint8)  # square: every turn fits one stack
    views = HostViews([np.ascontiguousarray(np.rot90(p.transpose(1, 2, 0), -k)) for p, k in zip(planes, turns)], turns)
    got = frame_tensor(views, CPU)
    assert got.dtype == torch.float32 and got.shape == planes.shape
    np.testing.assert_array_equal(got.numpy(), planes.astype(np.float32) / 255.0)
    wide = rng.integers(0, 256, (2, 3, 4, 7), dtype=np.uint8)  # stored landscape, read portrait and back
    views = HostViews([np.ascontiguousarray(np.rot90(p.transpose(1, 2, 0), -k)) for p, k in zip(wide, (1, -1))], [1, -1])
    assert views.pixels[0].shape == (7, 4, 3) and views.nbytes == wide.nbytes
    np.testing.assert_array_equal(frame_tensor(views, CPU).numpy(), wide.astype(np.float32) / 255.0)


def _assert_loaders_agree(src, jsrc, frames):
    assert src.view_names == jsrc.view_names and src.view_files == jsrc.view_files
    np.testing.assert_array_equal(src.trans_g, jsrc.trans_g)
    _assert_cameras_equal(src.cameras, jsrc.cameras)
    _assert_cameras_equal(src.cameras_full, jsrc.cameras_full)
    for t in frames:
        for full in (False, True):
            got, want = src.frame(t, full_res=full), jsrc.frame(t, full_res=full)
            assert got.view_names == want.view_names
            assert isinstance(got.images, HostViews) and isinstance(got.masks, HostViews)
            assert all(p.dtype == np.uint8 for p in got.images.pixels + got.masks.pixels)
            assert want.images.dtype == np.float32
            np.testing.assert_array_equal(_unit(got.images), want.images)
            assert want.masks is not None
            np.testing.assert_array_equal(_unit(got.masks), want.masks)
    assert src.frame(max(frames) + 1) is None and jsrc.frame(max(frames) + 1) is None


def test_jax_fabricated_tree_reads_alike(jax_tree):
    root, ratio = jax_tree
    cfg, jcfg = _cfgs(root, ratio)
    src = DiskSequence(cfg, device=CPU)
    assert src.num_views == 2 and (src.cameras.width, src.cameras.height) == (48, 32)
    _assert_loaders_agree(src, JDiskSequence(jcfg), frames=[1])


def test_port_tree_reads_alike(port_tree):
    tree = port_tree
    cfg, jcfg = _cfgs(tree.input_dir, 2, tree.dense_input_dir, tree.seq)
    src = DiskSequence(cfg, device=CPU)
    assert src.view_names == tree.view_names == ["K98707288", "K98707293", "view02"]
    _assert_loaders_agree(src, JDiskSequence(jcfg), frames=[1, 2])
    # the rig and the targets the tree was written from (the rig through
    # the XML's inverses, so within float32 rounding of entries <= 4096)
    _assert_cameras_equal(src.cameras, tree.cameras, atol=1e-6)
    _assert_cameras_equal(src.cameras_full, tree.cameras_full, atol=1e-6)
    np.testing.assert_array_equal(src.trans_g, COMPONENT)
    for (t, full), want in tree.images.items():
        fd = src.frame(t, full_res=full)
        assert fd.images.turns == fd.masks.turns == tree.turns == [1, -1, 0]
        for v, k in enumerate(tree.turns):  # the pixels as the files hold them
            np.testing.assert_array_equal(fd.images.pixels[v], np.rot90(want[v].transpose(1, 2, 0), -k))
            np.testing.assert_array_equal(fd.masks.pixels[v], np.rot90(tree.masks[(t, full)][v].transpose(1, 2, 0), -k))
        np.testing.assert_array_equal(_unit(fd.images), want.astype(np.float32) / 255.0)
        np.testing.assert_array_equal(_unit(fd.masks), tree.masks[(t, full)].astype(np.float32) / 255.0)


def test_size_mismatch_error(port_tree):
    tree = port_tree
    cfg, jcfg = _cfgs(tree.input_dir, 2, dense_root=tree.input_dir, seq=tree.seq)  # working files at full res
    with pytest.raises(ValueError) as got:
        DiskSequence(cfg, device=CPU).frame(1, full_res=True)
    with pytest.raises(ValueError) as want:
        JDiskSequence(jcfg).frame(1, full_res=True)
    assert str(got.value) == str(want.value) and "dense_input_dir" in str(got.value)


def _copy_tree(tree, dst):
    root = str(dst)
    shutil.copytree(tree.input_dir, root)
    return root


def test_missing_mask_dir_warns_once(port_tree, tmp_path, capsys):
    root = _copy_tree(port_tree, tmp_path / "nomask")
    shutil.rmtree(os.path.join(root, port_tree.seq, "mask"))
    cfg, jcfg = _cfgs(root, 2, dense_root=root, seq=port_tree.seq)
    src, jsrc = DiskSequence(cfg, device=CPU), JDiskSequence(jcfg)
    for t in (1, 2):
        got, want = src.frame(t), jsrc.frame(t)
        assert got.masks is None and want.masks is None
        np.testing.assert_array_equal(_unit(got.images), want.images)
    out = capsys.readouterr().out
    assert out.count("[topo4d_tpu_torch] mask dir") == 1 and out.count("[topo4d] mask dir") == 1


def test_missing_view_mask_turns_the_frame_maskless(port_tree, tmp_path, capsys):
    root = _copy_tree(port_tree, tmp_path / "partial")
    os.remove(os.path.join(root, port_tree.seq, "mask", "000001", "K98707293.png"))
    cfg, jcfg = _cfgs(root, 2, dense_root=root, seq=port_tree.seq)
    src, jsrc = DiskSequence(cfg, device=CPU), JDiskSequence(jcfg)
    assert src.frame(1).masks is None and jsrc.frame(1).masks is None
    np.testing.assert_array_equal(_unit(src.frame(1).images), jsrc.frame(1).images)
    np.testing.assert_array_equal(_unit(src.frame(2).masks), jsrc.frame(2).masks)
    assert capsys.readouterr().out.count("[topo4d_tpu_torch] mask") == 1


def _to_jpeg(root, quality, subsampling):
    """Re-save every PNG view and parsing image under ``root`` (working and
    dense trees) as PIL's JPEG beside it, the PNG removed."""
    for base in (root, root + "_dense"):
        for dirpath, _, files in os.walk(base):
            for f in files:
                if f.endswith(".png") and f != "face_v5.png":
                    path = os.path.join(dirpath, f)
                    with Image.open(path) as im:
                        im.save(path[:-4] + ".jpg", quality=quality, subsampling=subsampling)
                    os.remove(path)


@pytest.mark.parametrize("quality,subsampling", [(75, 2), (95, 0), (90, 1)])
def test_jpeg_tree_reads_alike(port_tree, tmp_path, quality, subsampling):
    """The port's tree as PIL's JPEGs, views and parsing images alike: both
    loaders' frames and masks, working and dense, bit for bit."""
    root = str(tmp_path / "jpg")
    shutil.copytree(port_tree.input_dir, root)
    shutil.copytree(port_tree.dense_input_dir, root + "_dense")
    _to_jpeg(root, quality, subsampling)
    cfg, jcfg = _cfgs(root, 2, seq=port_tree.seq)
    src = DiskSequence(cfg, device=CPU)
    assert src.view_files == ["K98707288.jpg", "K98707293.jpg", "view02.jpg"]
    _assert_loaders_agree(src, JDiskSequence(jcfg), frames=[1, 2])


def test_jpg_view_raises_naming_the_path(port_tree, tmp_path):
    """A ``.jpg`` view among PNGs reads as JAX reads it (listed first, as in
    JAX), a progressive one and an arithmetic-coded one too; a lossless one,
    which PIL fails on as well, raises, naming its path."""
    root = _copy_tree(port_tree, tmp_path / "jpg")
    fdir = os.path.join(root, port_tree.seq, "000001")
    Image.open(os.path.join(fdir, "view02.png")).save(os.path.join(fdir, "view02.jpg"))
    os.remove(os.path.join(fdir, "view02.png"))
    cfg, jcfg = _cfgs(root, 2, dense_root=root, seq=port_tree.seq)
    src = DiskSequence(cfg, device=CPU)
    assert src.view_files == ["view02.jpg", "K98707288.png", "K98707293.png"]  # .jpg first, as in JAX
    got, want = src.frame(1), JDiskSequence(jcfg).frame(1)
    np.testing.assert_array_equal(_unit(got.images), want.images)
    np.testing.assert_array_equal(_unit(got.masks), want.masks)
    view = os.path.join(fdir, "view02.jpg")
    Image.open(view).save(view, progressive=True)
    np.testing.assert_array_equal(_unit(src.frame(1).images), JDiskSequence(jcfg).frame(1).images)
    with open(view, "rb") as fh:
        data = fh.read()
    with open(view, "wb") as fh:
        fh.write(data.replace(b"\xff\xc2", b"\xff\xca", 1))  # the progressive frame header, arithmetic-coded
    np.testing.assert_array_equal(_unit(src.frame(1).images), JDiskSequence(jcfg).frame(1).images)
    with open(view, "wb") as fh:
        fh.write(data.replace(b"\xff\xc2", b"\xff\xc3", 1))  # lossless
    with pytest.raises(OSError):
        JDiskSequence(jcfg).frame(1)
    with pytest.raises(ValueError, match="000001/view02.jpg: lossless JPEG"):
        src.frame(1)


OBJ_WITHOUT_VT = """v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vn 0 0 1
vt 0.1 0.1
vt 0.9 0.1
f 1 2 3
f 1//1 3//1 4//1
f 1/1 2/2 3 4
"""


def test_load_obj_matches_jax(port_tree, tmp_path):
    paths = [os.path.join(port_tree.input_dir, port_tree.seq, "face_v5.obj"), str(tmp_path / "novt.obj")]
    with open(paths[1], "w") as fh:
        fh.write(OBJ_WITHOUT_VT)
    for path in paths:
        got, want = load_obj(path), j_load_obj(path)
        assert got.num_vertices == want.num_vertices
        assert got.faces == want.faces and got.uv_faces == want.uv_faces
        for f in ("vertices", "uvs", "normals"):
            a, b = getattr(got, f), getattr(want, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    assert load_obj(paths[1]).uv_faces == [[0, 1, 2], [0, 2, 3], [0, 1, 2, 3]]


def test_sample_vertex_colors_matches_jax(port_tree):
    seq_dir = os.path.join(port_tree.input_dir, port_tree.seq)
    mesh = load_obj(os.path.join(seq_dir, "face_v5.obj"))
    tex = read_png(os.path.join(seq_dir, "face_v5.png"))
    with Image.open(os.path.join(seq_dir, "face_v5.png")) as im:
        np.testing.assert_array_equal(tex, np.asarray(im))
    rng = np.random.default_rng(0)
    uvs = np.concatenate([mesh.uvs, rng.uniform(-0.5, 1.5, (8, 2)).astype(np.float32), [[0.0, 0.0], [1.0, 1.0]]])
    faces = mesh.faces + [[0, 1, 2]] * 8
    uv_faces = mesh.uv_faces + [[36 + i, 37 + i, 38 + i] for i in range(0, 8)]
    for t in (tex, tex.astype(np.float32) / 255.0):
        got = sample_vertex_colors(t, mesh.num_vertices, faces, uv_faces, uvs)
        want = j_sample_vertex_colors(t, mesh.num_vertices, faces, uv_faces, uvs)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_load_facial_regions_matches_jax(port_tree):
    path = os.path.join(port_tree.input_dir, "assets", "facial_regions.pkl")
    got, want = load_facial_regions(path), j_load_facial_regions(path)
    for f in ("region_masks", "masks", "flat_faces"):
        a, b = getattr(got, f), getattr(want, f)
        assert sorted(a) == sorted(b), f
        for k in b:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
