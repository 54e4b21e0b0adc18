"""The C++ scanline tier of the port (``csrc/scanline.cpp`` through
``topo4d_tpu_torch.mesh3d.scanline``) and its NumPy tier
(``mesh3d/mesh_numpy.py``) against the JAX package's on the CPU.

- the port's library against ``topo4d_tpu.native`` bit for bit, all four
  functions, ``bilinear`` on and off (the same source, built with
  ``-ffp-contract=off`` here and with ``g++ -O3`` there: x86-64 without
  ``-march`` has no fused multiply-add, so the bits agree);
- the port's ``mesh_numpy`` against JAX's bit for bit;
- the port's ``mesh_numpy`` against the port's library at JAX's own
  tolerances (``tests/test_mesh_numpy.py``): triangle ids equal, colors
  rtol 1e-5 / atol 1e-6, depth rtol 1e-5 / atol 1e-5, barycentrics rtol
  1e-4 / atol 1e-5, normals rtol 1e-4 / atol 1e-5; nearest texture samples
  may differ on half-integer coordinates (C's ``lround`` against NumPy's
  ``rint``), on under 1% of the pixels;
- the same ``ValueError`` on bad indices; the host library builder: a
  library named by its source and flags, a failed build raising with the
  compiler's output.
"""

import numpy as np
import pytest

from topo4d_tpu import native as j_native
from topo4d_tpu.mesh3d import mesh_numpy as j_mnp

from topo4d_tpu_torch import native
from topo4d_tpu_torch.mesh3d import mesh_numpy as mnp
from topo4d_tpu_torch.mesh3d import scanline

H, W = 48, 64


def _random_mesh(seed, n_tris=40, h=H, w=W):
    """Random triangles over (and past) the canvas (``tests/test_mesh_numpy.py:20``)."""
    rng = np.random.default_rng(seed)
    nv = n_tris + 2
    verts = np.empty((nv, 3), np.float32)
    verts[:, 0] = rng.uniform(-5, w + 5, nv)
    verts[:, 1] = rng.uniform(-5, h + 5, nv)
    verts[:, 2] = rng.uniform(-1, 1, nv)
    tris = rng.integers(0, nv, (n_tris, 3)).astype(np.int32)
    return verts, tris


def _texture_case(seed=7):
    verts, tris = _random_mesh(seed)
    rng = np.random.default_rng(seed)
    tex = rng.uniform(0, 1, (32, 40, 3)).astype(np.float32)
    tc = np.empty((verts.shape[0] + 3, 2), np.float32)
    tc[:, 0] = rng.uniform(0, 39, tc.shape[0])
    tc[:, 1] = rng.uniform(0, 31, tc.shape[0])
    ttris = rng.integers(0, tc.shape[0], tris.shape).astype(np.int32)
    return verts, tris, tex, tc, ttris


def _tie_mesh():
    """Two coplanar overlapping triangles at equal depth, red first."""
    verts = np.array([[4, 4, 0.5], [30, 4, 0.5], [4, 30, 0.5], [6, 6, 0.5], [32, 6, 0.5], [6, 32, 0.5]], np.float32)
    tris = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    cols = np.array([[1, 0, 0]] * 3 + [[0, 1, 0]] * 3, np.float32)
    return verts, tris, cols


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_render_colors_matches_jax(seed):
    verts, tris = _random_mesh(seed)
    cols = np.random.default_rng(100 + seed).uniform(0, 1, (verts.shape[0], 3)).astype(np.float32)
    got = scanline.render_colors(verts, tris, cols, H, W)
    np.testing.assert_array_equal(got, j_native.render_colors(verts, tris, cols, H, W))
    np.testing.assert_array_equal(mnp.render_colors(verts, tris, cols, H, W),
                                  j_mnp.render_colors(verts, tris, cols, H, W))
    np.testing.assert_allclose(mnp.render_colors(verts, tris, cols, H, W), got, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 3])
def test_rasterize_triangles_matches_jax(seed):
    verts, tris = _random_mesh(seed)
    got = scanline.rasterize_triangles(verts, tris, H, W)
    for a, b in zip(got, j_native.rasterize_triangles(verts, tris, H, W)):
        np.testing.assert_array_equal(a, b)
    oracle = mnp.rasterize_triangles(verts, tris, H, W)
    for a, b in zip(oracle, j_mnp.rasterize_triangles(verts, tris, H, W)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(oracle[1], got[1])
    np.testing.assert_allclose(oracle[0], got[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(oracle[2], got[2], rtol=1e-4, atol=1e-5)
    assert (got[1] >= 0).mean() > 0.3  # the triangles cover a good part of the canvas


@pytest.mark.parametrize("bilinear", [True, False])
def test_render_texture_matches_jax(bilinear):
    verts, tris, tex, tc, ttris = _texture_case()
    got = scanline.render_texture(verts, tris, tex, tc, ttris, H, W, bilinear)
    np.testing.assert_array_equal(got, j_native.render_texture(verts, tris, tex, tc, ttris, H, W, bilinear))
    oracle = mnp.render_texture(verts, tris, tex, tc, ttris, H, W, bilinear)
    np.testing.assert_array_equal(oracle, j_mnp.render_texture(verts, tris, tex, tc, ttris, H, W, bilinear))
    if not bilinear:  # lround against rint on a half-integer texel coordinate
        knife = np.abs(oracle - got).max(-1) > 1e-5
        assert knife.mean() < 0.01, knife.mean()
        oracle, got = np.where(knife[..., None], 0, oracle), np.where(knife[..., None], 0, got)
    np.testing.assert_allclose(oracle, got, rtol=1e-5, atol=1e-6)


def test_vertex_normals_match_jax():
    verts, tris = _random_mesh(5)
    got = scanline.vertex_normals(verts, tris)
    np.testing.assert_array_equal(got, j_native.vertex_normals(verts, tris))
    np.testing.assert_array_equal(mnp.vertex_normals(verts, tris), j_mnp.vertex_normals(verts, tris))
    np.testing.assert_allclose(mnp.vertex_normals(verts, tris), got, rtol=1e-4, atol=1e-5)


def test_ties_go_to_the_first_triangle():
    verts, tris, cols = _tie_mesh()
    for render in (scanline.render_colors, mnp.render_colors):
        out = render(verts, tris, cols, 40, 40)
        np.testing.assert_array_equal(out[10, 10], [1, 0, 0])  # both cover it at equal depth
        np.testing.assert_array_equal(out[31, 7], [0, 1, 0])  # the second alone
    ids = scanline.rasterize_triangles(verts, tris, 40, 40)[1]
    assert ids[10, 10] == 0 and ids[31, 7] == 1 and ids[0, 0] == -1


def test_bad_indices_raise_as_in_jax():
    verts, tris, tex, tc, ttris = _texture_case()
    cols = np.zeros((verts.shape[0] - 1, 3), np.float32)  # one row short of the vertices
    bad_tris = tris.copy()
    bad_tris[0, 0] = verts.shape[0] - 1
    for module in (scanline, mnp, j_native, j_mnp):
        with pytest.raises(ValueError, match="triangle index exceeds"):
            module.render_colors(verts, bad_tris, cols, H, W)
        with pytest.raises(ValueError, match="must match triangles"):
            module.render_texture(verts, tris, tex, tc, ttris[:-1], H, W)
        bad = ttris.copy()
        bad[3, 1] = tc.shape[0]
        with pytest.raises(ValueError, match="tex_triangles index exceeds"):
            module.render_texture(verts, tris, tex, tc, bad, H, W)


def test_host_library_builds_by_source_and_flags(tmp_path, monkeypatch):
    """The scanline library's name hashes its source and flags; a broken
    source raises with the compiler's message and leaves no library."""
    assert native.lib_path("scanline").name.startswith("scanline-")
    assert native.lib_path("scanline") != native.lib_path("imgdec")
    assert "-ffp-contract=off" in native.LIBRARIES["scanline"].flags
    monkeypatch.setattr(native, "CSRC", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "scanline.cpp").write_text('extern "C" void render_colors() { this is not C++; }\n')
    name = native.lib_path("scanline").name
    with pytest.raises(RuntimeError, match="host library build failed") as err:
        native.build("scanline")
    assert "error" in str(err.value)
    assert not native.lib_path("scanline").exists()
    (tmp_path / "scanline.cpp").write_text('extern "C" int one() { return 1; }\n')
    assert native.lib_path("scanline").name != name  # another source, another library
    assert native.build("scanline").exists()
