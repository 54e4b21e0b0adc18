"""The UV texture bakes of the PyTorch port against the JAX package on the
CPU.

- ``process_uv`` equal; the host bake binning (tile map, ranges, corner ids
  integer-equal, geometry rows bit-equal on the port's exact ``E`` / ``M``
  entries, which JAX pads for its kernel) with and without a corner map;
- K6's plain version against JAX's Pallas z-buffer bake in interpret mode
  at the JAX suite's bake tolerance (rtol 2e-4 / atol 2e-5,
  ``tests/test_texture.py:298``); against JAX the colors differ in the last
  bits where XLA orders the interpolation's products and sums otherwise;
- a second, independent bake: the port's banded three-pass scatter bake
  (``texture/bake.py``, ``texture.bake_backend: "xla"``; JAX's
  ``topo4d_tpu/texture/bake.py``), held against JAX's at that tolerance and
  against K6's plain version bit for bit; ``write_texture`` with the "xla"
  bake against JAX's (the decoded pixels within one uint8 level, but for
  JAX's cracks, as ``tests/test_torch_export.py`` allows them) and equal to
  the port's "auto" bake; a window too small raises in both packages;
- K6's plain version against the C++ scanline oracle on a seam-heavy
  layout (fewer than 1e-4 of the pixels differ, ``tests/test_texture.py:394``).

The CUDA kernel runs only on the card: the ``cuda`` test compares it with
the plain version (bit for bit: the same operation order, no fused
multiply-add), through its wrapper and on a canvas pre-filled with NaN,
and skips here. Its per-warp cull runs only there too; its plain mirror
``bake_warp_cull_plain`` is held here to the contract's inside test
(``bake_inside_plain``): no culled (entry, 8 x 8 warp block) pair has an
inside pixel, on the named cases, the dense mesh and hypothesis-drawn
triangles, and a cull one pixel wider is caught. The binning's list of
empty tiles is checked against its occupied tiles and ranges.
"""

import functools

import numpy as np
import pytest
import torch
from PIL import Image
from hypothesis import given, settings
from hypothesis import strategies as st

from topo4d_tpu.config import Config as JConfig
from topo4d_tpu.native import render_colors as native_render
from topo4d_tpu.pipeline.export import write_texture as j_write_texture
from topo4d_tpu.pipeline.scene import build_scene as j_build_scene
from topo4d_tpu.testing import make_grid_mesh as j_grid
from topo4d_tpu.testing import make_synthetic_regions as j_regions
from topo4d_tpu.texture.bake import bake_texture as j_bake_texture
from topo4d_tpu.texture.bake import process_uv as j_process_uv
from topo4d_tpu.texture.bake_pallas import bake_texture_pallas
from topo4d_tpu.texture.bake_pallas import compute_bake_binning as j_compute_bake_binning
from topo4d_tpu.topology.obj_io import MeshObj as JMesh

from topo4d_tpu_torch import convert, kernels
from topo4d_tpu_torch.pipeline.export import write_texture
from topo4d_tpu_torch.testing import make_crowded_bake_tile
from topo4d_tpu_torch.texture.bake import bake_texture
from topo4d_tpu_torch.texture.bake_tiled import (
    LAUNCHES,
    bake_canvas,
    bake_canvas_cuda,
    bake_canvas_plain,
    bake_inside_plain,
    bake_texture_tiled,
    bake_warp_cull_plain,
    compute_bake_binning,
    process_uv,
    reset_launches,
)

CPU = "cpu"
TOL = dict(rtol=2e-4, atol=2e-5)


def random_mesh(h, w, n_tris=40, seed=0, max_size=6.0):
    """Separate random triangles with random depths and vertex colors
    (``tests/test_texture.py:63``)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(5, min(h, w) - 5, (n_tris, 2))
    offsets = rng.uniform(-max_size / 2, max_size / 2, (n_tris, 3, 2))
    verts = (centers[:, None, :] + offsets).reshape(-1, 2)
    z = rng.uniform(-1, 1, (verts.shape[0], 1))
    verts = np.hstack([verts, z]).astype(np.float32)
    tris = np.arange(n_tris * 3).reshape(n_tris, 3).astype(np.int32)
    colors = rng.uniform(0, 1, (verts.shape[0], 3)).astype(np.float32)
    return verts, tris, colors


def tie_mesh():
    """Two coplanar overlapping triangles, red first, off the pixel grid."""
    verts = np.array(
        [[2.3, 2.3, 0], [20.3, 2.3, 0], [2.3, 20.3, 0], [3.3, 3.3, 0], [21.3, 3.3, 0], [3.3, 21.3, 0]], np.float32
    )
    colors = np.array([[1, 0, 0]] * 3 + [[0, 1, 0]] * 3, np.float32)
    return verts, np.array([[0, 1, 2], [3, 4, 5]], np.int32), colors


@functools.lru_cache(maxsize=None)
def dense_scene(density=2):
    """JAX's scene statics of a 10x10 grid head with its UV-densified dense
    mesh."""
    rows = cols = 10
    verts, faces = j_grid(rows, cols, extent=0.5)
    uvs = np.stack(
        np.meshgrid(np.linspace(0.05, 0.95, cols), np.linspace(0.05, 0.95, rows), indexing="xy"), -1
    ).reshape(-1, 2).astype(np.float32)
    cfg = JConfig()
    cfg.texture.gen_tex = True
    cfg.texture.density = density
    _, st = j_build_scene(
        JMesh(vertices=verts, uvs=uvs, faces=faces, uv_faces=[list(f) for f in faces]),
        j_regions(verts.shape[0], faces), cfg, num_views=4,
    )
    return st


def dense_mesh_layout(res, density=2):
    """The dense mesh of ``dense_scene``: (uv_px, tri_uv_faces, uv -> vertex
    map, vertex count)."""
    st = dense_scene(density)
    uv2vert = np.zeros(st.dense.topo.dense_uvs.shape[0], np.int64)
    uv2vert[st.dense.tri_uv_faces.reshape(-1)] = st.dense.tri_faces.reshape(-1)
    uv_px = j_process_uv(st.dense.topo.dense_uvs.copy(), res, res)
    return uv_px, np.asarray(st.dense.tri_uv_faces), uv2vert, st.dense.topo.dense_vertices.shape[0]


def test_process_uv_matches_jax():
    uv = np.random.default_rng(0).uniform(0, 1, (50, 2))
    for h, w in ((256, 256), (93, 64)):
        np.testing.assert_array_equal(process_uv(uv, h, w), j_process_uv(uv, h, w))


def _assert_binning_equal(b, jb, corner_map=None):
    e, m = b.geom.shape[1], b.tile_ids.shape[0]
    pk = np.asarray(jb.packed_geom)
    assert e > 0 and m == jb.m
    # the exact counts: JAX pads past them, with sentinels
    assert np.all(pk[18, e:] == -1.0) and np.all(np.asarray(jb.count)[m:] == 0)
    np.testing.assert_array_equal(b.geom[:9].numpy(), pk[0:9, :e])
    np.testing.assert_array_equal(b.geom[9].numpy(), pk[18, :e])
    np.testing.assert_array_equal(b.tile_ids.numpy(), np.asarray(jb.tmap)[:m])
    np.testing.assert_array_equal(b.start.numpy(), np.asarray(jb.start)[:m])
    np.testing.assert_array_equal(b.count.numpy(), np.asarray(jb.count)[:m])
    np.testing.assert_array_equal(b.corner_idx.numpy(), np.asarray(jb.corner_idx)[:, :e])
    assert (b.tiles_x, b.tiles_y) == (jb.tiles_x, jb.tiles_y)


@pytest.mark.parametrize("corner_map", [False, True])
@pytest.mark.parametrize("seed,h,w,max_size", [(3, 96, 80, 20.0), (7, 64, 64, 12.0), (11, 93, 77, 6.0)])
def test_bake_binning_matches_jax(seed, h, w, max_size, corner_map):
    verts, tris, _ = random_mesh(min(h, w), min(h, w), n_tris=50, seed=seed, max_size=max_size)
    cmap = np.random.default_rng(seed).integers(0, 40, verts.shape[0]) if corner_map else None
    b = compute_bake_binning(verts, tris, h, w, corner_map=cmap, device=CPU)
    _assert_binning_equal(b, j_compute_bake_binning(verts, tris, h, w, corner_map=cmap))


@pytest.mark.parametrize("corner_map", [False, True])
def test_bake_binning_of_the_dense_mesh_matches_jax(corner_map):
    uv_px, tris, uv2vert, _ = dense_mesh_layout(128)
    cmap = uv2vert if corner_map else None
    b = compute_bake_binning(uv_px, tris, 128, 128, corner_map=cmap, device=CPU)
    _assert_binning_equal(b, j_compute_bake_binning(uv_px, tris, 128, 128, corner_map=cmap))


def _case(name):
    """(verts, tris, colors, h, w) of a named bake case."""
    if name == "random_96x80":
        verts, tris, colors = random_mesh(80, 80, n_tris=60, seed=11)
        return verts, tris, colors, 96, 80
    if name == "first_wins_tie":
        return (*tie_mesh(), 24, 24)
    if name == "multi_tile_triangle":
        verts = np.array([[1.2, 1.2, 0.5], [61.7, 2.1, 0.5], [2.4, 60.8, 0.5]], np.float32)
        return verts, np.array([[0, 1, 2]], np.int32), np.tile(np.float32([[0.2, 0.4, 0.8]]), (3, 1)), 64, 64
    if name == "not_a_multiple_of_16":
        verts, tris, colors = random_mesh(70, 70, n_tris=45, seed=2, max_size=14.0)
        return verts, tris, colors, 75, 71
    if name == "crowded_tile":
        verts, tris = make_crowded_bake_tile()
        colors = np.random.default_rng(4).uniform(0, 1, (verts.shape[0], 3)).astype(np.float32)
        return verts, tris, colors, 36, 40
    raise KeyError(name)


PALLAS_CASES = ["random_96x80", "first_wins_tie", "multi_tile_triangle", "not_a_multiple_of_16"]
# float32 rounding decides some of the crowded tile's pixels, and XLA rounds otherwise: it is held to Pallas
# only where rounding does not decide (test_crowded_tile_differs_from_pallas_only_where_rounding_decides)
CASES = PALLAS_CASES + ["crowded_tile"]


@pytest.mark.parametrize("name", PALLAS_CASES)
def test_plain_bake_matches_pallas(name):
    verts, tris, colors, h, w = _case(name)
    want = bake_texture_pallas(verts, tris, colors, h, w, interpret=True)
    reset_launches()
    got = bake_texture_tiled(verts, tris, colors, h, w, device=CPU)
    assert LAUNCHES == {"uv_bake": 0, "uv_bake_plain": 1}
    assert got.shape == (h, w, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if name == "first_wins_tie":
        np.testing.assert_array_equal(got[10, 10].numpy(), [1, 0, 0])  # inside both: the first keeps the tie


def _thin_triangles(verts, tris, rel_area=1e-6):
    """(n,) bool: three distinct corners (in float64) that are collinear
    within ``rel_area``, so the float32 barycentric denominator is
    cancellation noise (0 or not) and so is the triangle's inside test."""
    p = verts.astype(np.float64)[tris][:, :, :2]
    v0, v1, v2 = p[:, 2] - p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 1]
    n0, n1, n2 = (np.hypot(v[:, 0], v[:, 1]) for v in (v0, v1, v2))
    cross = v0[:, 0] * v1[:, 1] - v0[:, 1] * v1[:, 0]
    return (n0 > 0) & (n1 > 0) & (n2 > 0) & (np.abs(cross) <= rel_area * n0 * n1)


def _decided_by_rounding(verts, tris, h, w, margin=1e-5):
    """(h, w) bool: pixels whose winner float32 rounding decides, from exact
    (float64) barycentrics: in the inner bbox of a thin triangle, or inside
    (within ``margin``) two triangles of the same constant depth, a tie that
    the rounding of each depth sum breaks. Triangles with a repeated corner
    have a denominator of exactly 0 and are decided alike everywhere."""
    p = verts.astype(np.float64)[tris]
    thin = _thin_triangles(verts, tris)
    py, px = np.mgrid[0:h, 0:w].astype(np.float64)
    out = np.zeros((h, w), bool)
    inside_at = {}  # constant depth -> count of such triangles covering each pixel
    for k in range(tris.shape[0]):
        (x0, y0, z0), (x1, y1, z1), (x2, y2, z2) = p[k]
        lo, hi = np.ceil(p[k, :, :2].min(0)), np.floor(p[k, :, :2].max(0))
        box = (px >= lo[0]) & (px <= hi[0]) & (py >= lo[1]) & (py <= hi[1])
        if thin[k]:
            out |= box
            continue
        cross = (x2 - x0) * (y1 - y0) - (y2 - y0) * (x1 - x0)
        if cross == 0:
            continue
        u = ((px - x0) * (y1 - y0) - (py - y0) * (x1 - x0)) / cross
        w1 = ((x2 - x0) * (py - y0) - (y2 - y0) * (px - x0)) / cross
        bary = np.stack([u, w1, 1.0 - u - w1])
        covered = box & (bary.min(0) >= -margin)
        if z0 == z1 == z2:
            inside_at[z0] = inside_at.get(z0, 0) + covered
    for count in inside_at.values():
        out |= np.asarray(count) >= 2
    return out


@pytest.mark.parametrize("thin", ["with_thin_triangles", "without_thin_triangles"])
def test_crowded_tile_differs_from_pallas_only_where_rounding_decides(thin):
    """The crowded tile is held to the plain version on the card, not to
    JAX's Pallas bake: XLA rounds some of its pixels' decisions otherwise.
    Every pixel where the two differ is one whose winner rounding decides
    (``_decided_by_rounding``). The thin triangles' bboxes cover most of
    the tile, so without them the rest, the ties and the triangles with a
    repeated corner among it, is held to Pallas at hundreds of pixels."""
    verts, tris, colors, h, w = _case("crowded_tile")
    if thin == "without_thin_triangles":
        tris = tris[~_thin_triangles(verts, tris)]
    want = bake_texture_pallas(verts, tris, colors, h, w, interpret=True)
    got = bake_texture_tiled(verts, tris, colors, h, w, device=CPU).numpy()
    differ = ~np.isclose(got, want, **TOL).all(-1)
    decided = _decided_by_rounding(verts, tris, h, w)
    assert not bool((differ & ~decided).any()), np.argwhere(differ & ~decided)[:8].tolist()
    if thin == "without_thin_triangles":
        assert int(((np.abs(want).sum(-1) > 0) & ~decided).sum()) >= 200


def test_plain_bake_with_cached_corner_map_matches_pallas():
    """Two frames of vertex colors through one binning that composes the
    UV-slot -> vertex map, against JAX's host re-indexing of the colors into
    UV slots and a fresh bake (``tests/test_texture.py:360``)."""
    h = w = 64
    uv_verts, tris, _ = random_mesh(h, w, n_tris=40, seed=7, max_size=12.0)
    rng = np.random.default_rng(1)
    uv2vert = rng.integers(0, 50, uv_verts.shape[0])
    binning = compute_bake_binning(uv_verts, tris, h, w, corner_map=uv2vert, device=CPU)
    for _ in range(2):
        vert_colors = rng.uniform(0, 1, (50, 3)).astype(np.float32)
        uv_colors = np.zeros((uv_verts.shape[0], 3), np.float32)
        uv_colors[tris.reshape(-1)] = vert_colors[uv2vert[tris.reshape(-1)]]
        want = bake_texture_pallas(uv_verts, tris, uv_colors, h, w, interpret=True)
        got = bake_canvas(binning, torch.as_tensor(vert_colors), h, w)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        # the port's own fresh bake of the UV colors: bit for bit
        fresh = bake_texture_tiled(uv_verts, tris, uv_colors, h, w, device=CPU)
        np.testing.assert_array_equal(got.numpy(), fresh.numpy())


# ---------------------------------------------------------------------------
# the banded scatter bake (texture/bake.py, texture.bake_backend "xla"): the
# port's copy of JAX's algorithm, which shares no code with K6's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["random_96x80", "first_wins_tie", "not_a_multiple_of_16"])
def test_scatter_bake_matches_jax(name):
    verts, tris, colors, h, w = _case(name)
    window = 32 if name == "first_wins_tie" else 16
    want = j_bake_texture(verts, tris, colors, h, w, window=window, bands=3)
    got = bake_texture(verts, tris, colors, h, w, window=window, bands=3, device=CPU)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the two torch bakes share no code and agree bit for bit
    np.testing.assert_array_equal(got.numpy(), bake_texture_tiled(verts, tris, colors, h, w, device=CPU).numpy())


def test_scatter_bake_window_overflow_raises():
    verts = np.array([[0, 0, 0], [30, 0, 0], [0, 30, 0]], np.float32)
    tris = np.array([[0, 1, 2]], np.int32)
    with pytest.raises(ValueError, match="window"):
        bake_texture(verts, tris, np.ones((3, 3), np.float32), 32, 32, window=8, device=CPU)
    with pytest.raises(ValueError, match="window"):
        j_bake_texture(verts, tris, np.ones((3, 3), np.float32), 32, 32, window=8)


def test_write_texture_with_the_xla_bake_matches_jax(tmp_path):
    """``write_texture(backend="xla")`` on the CPU against JAX's on the same
    converted dense colors (window 16, 2 bands): the decoded pixels within
    one uint8 level (the bake's rtol 2e-4 before truncation) but for JAX's
    cracks on exact shared edges (0 there, covered here; see
    ``test_plain_bake_of_the_dense_mesh_matches_pallas_and_the_scanline_oracle``),
    and the port's "xla" PNG equal to its "auto" one byte for byte."""
    st = dense_scene()
    nd = st.dense.topo.dense_vertices.shape[0]
    dense = {"dense_rgb_colors": np.random.default_rng(6).uniform(-0.1, 1.1, (nd, 3)).astype(np.float32)}
    statics, colors = convert.statics_from_numpy(st), convert.params_from_numpy(dense, CPU)
    j_write_texture(str(tmp_path / "jax.png"), dense, st, 64, 16, 2, "xla")
    reset_launches()
    write_texture(str(tmp_path / "xla.png"), colors, statics, 64, backend="xla", window=16, bands=2)
    assert LAUNCHES == {"uv_bake": 0, "uv_bake_plain": 0}  # no K6, no binning
    write_texture(str(tmp_path / "auto.png"), colors, statics, 64)
    assert (tmp_path / "xla.png").read_bytes() == (tmp_path / "auto.png").read_bytes()
    with Image.open(tmp_path / "xla.png") as a, Image.open(tmp_path / "jax.png") as b:
        got, want = np.asarray(a).astype(np.int16), np.asarray(b).astype(np.int16)
    crack = (np.abs(got - want) > 1).any(-1)
    assert np.all(want[crack] == 0) and np.all(got[crack].max(-1) > 0) and crack.mean() < 0.01
    assert got.max() > 0 and np.abs(got - want)[~crack].max() <= 1


def test_write_texture_with_a_window_too_small_raises_as_in_jax(tmp_path):
    """The dense triangles span more than 2 pixels at 64^2: both packages
    raise rather than drop them; an unknown backend raises naming the key
    (JAX bakes it as "xla")."""
    st = dense_scene()
    dense = {"dense_rgb_colors": np.zeros((st.dense.topo.dense_vertices.shape[0], 3), np.float32)}
    with pytest.raises(ValueError, match="exceeds window 2"):
        j_write_texture(str(tmp_path / "jax.png"), dense, st, 64, 2, 2, "xla")
    statics, colors = convert.statics_from_numpy(st), convert.params_from_numpy(dense, CPU)
    with pytest.raises(ValueError, match="exceeds window 2"):
        write_texture(str(tmp_path / "port.png"), colors, statics, 64, backend="xla", window=2, bands=2)
    with pytest.raises(ValueError, match="texture.bake_backend"):
        write_texture(str(tmp_path / "port.png"), colors, statics, 64, backend="banded")
    assert not (tmp_path / "port.png").exists()


@pytest.mark.parametrize("res", [64, 96])
def test_plain_bake_of_the_dense_mesh_matches_pallas_and_the_scanline_oracle(res):
    """The dense mesh's regular UV layout puts pixel centres exactly on
    shared edges. On those, the inclusive inside test decides on rounding:
    JAX's CPU evaluation (XLA, the Pallas kernel in interpret mode and the
    scatter bake alike) leaves some such pixels to neither triangle, a crack
    at 0, where the port, the C++ scanline oracle and, per pixel, exact
    arithmetic cover them. So the port equals JAX at the bake tolerance
    except on JAX's cracks (under 1% of the pixels), and matches the
    scanline oracle on all but 1e-3 of them."""
    uv_px, tris, uv2vert, nv = dense_mesh_layout(res)
    colors = np.random.default_rng(4).uniform(0, 1, (nv, 3)).astype(np.float32)
    jb = j_compute_bake_binning(uv_px, tris, res, res, corner_map=uv2vert)
    want = bake_texture_pallas(None, None, colors, res, res, interpret=True, binning=jb)
    b = compute_bake_binning(uv_px, tris, res, res, corner_map=uv2vert, device=CPU)
    got = bake_canvas(b, torch.as_tensor(colors), res, res).numpy()
    differ = ~np.isclose(got, want, **TOL).all(-1)
    assert np.all(want[differ] == 0) and np.all(got[differ].max(-1) > 0)
    assert differ.mean() < 0.01
    native = native_render(uv_px.astype(np.float32), tris, colors[uv2vert], res, res)
    assert (np.abs(got - native).max(-1) > 1e-3).mean() < 1e-3


def test_plain_bake_matches_native_scanline_on_seams():
    """Two 12x12-quad UV islands with jittered interiors (every boundary
    vertex a seam), at 256^2 and more than 2 px off the border, against the
    C++ scanline oracle (``tests/test_texture.py:394``)."""
    res, g = 256, 13
    rng = np.random.default_rng(9)
    verts_l, tris_l, cols_l = [], [], []
    for island, (u0, u1) in enumerate(((0.03, 0.47), (0.53, 0.97))):
        uu, vv = np.meshgrid(np.linspace(u0 * res, u1 * res, g), np.linspace(0.05 * res, 0.9 * res, g), indexing="xy")
        uu[1:-1, 1:-1] += rng.uniform(-0.7, 0.7, uu.shape)[1:-1, 1:-1]
        vv[1:-1, 1:-1] += rng.uniform(-0.7, 0.7, uu.shape)[1:-1, 1:-1]
        verts_l.append(np.stack([uu.reshape(-1), vv.reshape(-1), rng.uniform(0, 1, g * g)], 1).astype(np.float32))
        idx = np.arange(g * g).reshape(g, g) + island * g * g
        a, b, c, d = idx[:-1, :-1].reshape(-1), idx[:-1, 1:].reshape(-1), idx[1:, 1:].reshape(-1), idx[1:, :-1].reshape(-1)
        tris_l.append(np.concatenate([np.stack([a, b, c], 1), np.stack([a, c, d], 1)]))
        cols_l.append(rng.uniform(0, 1, (g * g, 3)).astype(np.float32))
    verts, tris, colors = np.concatenate(verts_l), np.concatenate(tris_l).astype(np.int32), np.concatenate(cols_l)
    got = bake_texture_tiled(verts, tris, colors, res, res, device=CPU).numpy()
    want = native_render(verts, tris, colors, res, res)
    frac = float((np.abs(got - want).max(axis=-1) > 1e-3).mean())
    assert frac < 1e-4, f"{frac:.2e} of pixels differ"


def test_kernel_wrapper_refuses_cpu_tensors():
    b = compute_bake_binning(*_case("first_wins_tie")[:2], 24, 24, device=CPU)
    with pytest.raises(ValueError, match="CUDA"):
        bake_canvas_cuda(b, torch.ones(6, 3), 24, 24)


def test_bake_takes_the_plain_version_only_on_the_cpu():
    """A tensor on any device but the CPU goes to the kernel, which raises
    off the card: it never falls back to the plain version."""
    b = compute_bake_binning(*_case("first_wins_tie")[:2], 24, 24, device=CPU)
    reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        bake_canvas(b, torch.ones(6, 3, device="meta"), 24, 24)
    assert LAUNCHES == {"uv_bake": 0, "uv_bake_plain": 0}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the bake kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_bake_kernel_matches_plain_on_the_card(cuda, name):
    """Bit for bit through the wrapper and, through the C entry point, on a
    canvas pre-filled with NaN: the kernel writes every pixel. The crowded
    tile holds more entries than one staging batch."""
    verts, tris, colors, h, w = _case(name)
    b = compute_bake_binning(verts, tris, h, w, device=cuda)
    c = torch.as_tensor(colors, device=cuda)
    want = bake_canvas_plain(b, c, h, w)
    torch.testing.assert_close(bake_canvas_cuda(b, c, h, w), want, rtol=0, atol=0)
    out = torch.full((h, w, 3), float("nan"), device=cuda)
    status = kernels.kernel("uv_bake")(
        b.geom.data_ptr(), b.corner_idx.data_ptr(), b.geom.shape[1], c.data_ptr(), c.shape[1], b.tile_ids.data_ptr(),
        b.start.data_ptr(), b.count.data_ptr(), b.tile_ids.shape[0], b.empty_ids.data_ptr(), b.empty_ids.shape[0],
        b.tiles_x, w, h, out.data_ptr(), torch.cuda.current_stream(cuda).cuda_stream,
    )
    kernels.check(status, "uv_bake")
    torch.testing.assert_close(out, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K6's per-warp cull (through its plain mirror) and the empty-tile list
# ---------------------------------------------------------------------------

CULL_CASES = CASES + ["dense_64", "dense_96"]


def _binning(name):
    if name.startswith("dense_"):
        res = int(name[len("dense_"):])
        uv_px, tris, uv2vert, _ = dense_mesh_layout(res)
        return compute_bake_binning(uv_px, tris, res, res, corner_map=uv2vert, device=CPU)
    verts, tris, _, h, w = _case(name)
    return compute_bake_binning(verts, tris, h, w, device=CPU)


def _blocks_with_an_inside_pixel(binning):
    """(E, 4) bool: warp block w (columns 8 (w % 2) + 0..7, rows 8 (w // 2)
    + 0..7 of the entry's tile) has a pixel inside the entry's triangle."""
    inside = bake_inside_plain(binning)
    return inside.view(-1, 2, 8, 2, 8).any(4).any(2).reshape(-1, 4)


def _widened_cull(binning, widen):
    """The mirror's cull with the warp block shrunk by ``widen`` pixels on
    each side: ``widen`` 0 is ``bake_warp_cull_plain``."""
    g = binning.geom
    umin = torch.ceil(torch.minimum(torch.minimum(g[0], g[2]), g[4]))[:, None]
    umax = torch.floor(torch.maximum(torch.maximum(g[0], g[2]), g[4]))[:, None]
    vmin = torch.ceil(torch.minimum(torch.minimum(g[1], g[3]), g[5]))[:, None]
    vmax = torch.floor(torch.maximum(torch.maximum(g[1], g[3]), g[5]))[:, None]
    tile = g[9].to(torch.int64)[:, None]
    w = torch.arange(4)
    bx0 = ((tile % binning.tiles_x) * 16 + (w % 2) * 8).to(torch.float32) + widen
    by0 = ((tile // binning.tiles_x) * 16 + (w // 2) * 8).to(torch.float32) + widen
    bx1, by1 = bx0 + 7 - 2 * widen, by0 + 7 - 2 * widen
    return (umax < bx0) | (umin > bx1) | (vmax < by0) | (vmin > by1)


def _check_cull_safe(binning):
    """No culled (entry, warp block) pair has an inside pixel -> (culled, pairs)."""
    culled = bake_warp_cull_plain(binning)
    bad = culled & _blocks_with_an_inside_pixel(binning)
    assert not bool(bad.any()), f"{int(bad.sum())} culled (entry, warp block) pairs have an inside pixel"
    return int(culled.sum()), culled.numel()


def _check_empty_tiles(binning):
    """The empty list and the occupied tiles partition the canvas's tiles;
    the ranges tile the entries in order, each entry in its own tile."""
    ids, empty = binning.tile_ids.long(), binning.empty_ids.long()
    start, count = binning.start.long(), binning.count.long()
    n_tiles = binning.tiles_x * binning.tiles_y
    assert binning.empty_ids.dtype == torch.int32 and binning.empty_ids.is_contiguous()
    assert bool((empty[1:] > empty[:-1]).all()) and bool((ids[1:] > ids[:-1]).all())
    assert torch.equal(torch.sort(torch.cat([ids, empty])).values, torch.arange(n_tiles))
    assert bool((count >= 1).all())
    assert torch.equal(start, torch.cumsum(count, 0) - count) and int(count.sum()) == binning.geom.shape[1]
    assert torch.equal(binning.geom[9].long(), torch.repeat_interleave(ids, count))


@pytest.mark.parametrize("name", CULL_CASES)
def test_bake_cull_mirror_is_conservative(name):
    b = _binning(name)
    assert torch.equal(_widened_cull(b, 0), bake_warp_cull_plain(b))
    _check_cull_safe(b)


def test_bake_cull_removes_a_share_of_the_dense_mesh():
    """The dense mesh's small triangles leave most warp blocks of their
    tiles: the cull removes a real share, so the checks above do not pass
    vacuously."""
    culled, pairs = _check_cull_safe(_binning("dense_96"))
    assert culled > 0.3 * pairs


@pytest.mark.parametrize("name", ["dense_64", "crowded_tile"])
def test_a_cull_one_pixel_wider_is_caught(name):
    """The mirror shrunk by one pixel on each side of the warp block drops
    pairs with an inside pixel: the safety check can fail."""
    b = _binning(name)
    assert bool((_widened_cull(b, 1) & _blocks_with_an_inside_pixel(b)).any())


@pytest.mark.parametrize("name", CULL_CASES)
def test_bake_binning_lists_the_empty_tiles(name):
    _check_empty_tiles(_binning(name))


_edge = st.sampled_from([0.0, 7.0, 7.5, 8.0, 15.0, 15.5, 16.0, 23.0, 24.0, 31.0, 32.0, -0.5, 39.0, 40.5])
_coord = st.one_of(_edge, _edge.map(lambda v: v + 1e-4), _edge.map(lambda v: v - 1e-4), st.floats(-12.0, 52.0))


@st.composite
def _triangle(draw):
    """Corners on tile and warp-block edges or anywhere (some off the 40 x
    36 canvas, some wider than a tile), or degenerate: collinear corners or
    a repeated one."""
    p = [(draw(_coord), draw(_coord)) for _ in range(3)]
    kind = draw(st.sampled_from(["any", "collinear", "repeated"]))
    if kind == "collinear":
        t = draw(st.sampled_from([-1.0, 0.5, 2.0]))
        p[2] = (p[0][0] + t * (p[1][0] - p[0][0]), p[0][1] + t * (p[1][1] - p[0][1]))
    elif kind == "repeated":
        p[1] = p[0]
    z = draw(st.floats(-1.0, 1.0))
    return [(x, y, z) for x, y in p]


@settings(max_examples=120, deadline=None)
@given(st.lists(_triangle(), min_size=1, max_size=8))
def test_bake_cull_is_conservative_on_drawn_triangles(tris):
    verts = np.asarray(tris, np.float32).reshape(-1, 3)
    b = compute_bake_binning(verts, np.arange(verts.shape[0]).reshape(-1, 3), 36, 40, device=CPU)
    _check_cull_safe(b)
    _check_empty_tiles(b)
