"""The dense texture mesh of the PyTorch port against the JAX package.

The UV densifier is host NumPy in both packages (the port keeps its own
copy): integer tables must be equal and float tables allclose to 1e-6. The
fixture is a quad grid whose UV map splits into two islands at its middle
column (the ``uv_seam`` layout of ``scripts/fabricate_dataset.py``), so the
shared-edge and the per-face seam allocations both run. Dense attributes
and init params: rtol 1e-5. The kNN init scales: the port's exact KD-tree
distances against JAX's float32 expanded-form block kNN, within that form's
cancellation error.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topo4d_tpu.config import Config as JConfig
from topo4d_tpu.opt.constraints import apply_constraints as j_apply
from topo4d_tpu.pipeline.scene import build_dense_pre_constraints as j_pre
from topo4d_tpu.pipeline.scene import build_scene as j_build_scene
from topo4d_tpu.pipeline.scene import init_dense_params as j_init_dense
from topo4d_tpu.testing import make_grid_mesh as j_grid
from topo4d_tpu.testing import make_synthetic_regions as j_regions
from topo4d_tpu.topology.adjacency import split_faces_by_mask as j_split
from topo4d_tpu.topology.densify_uv import build_dense_topology as j_build_dense
from topo4d_tpu.topology.densify_uv import densify_quads as j_densify
from topo4d_tpu.topology.interpolate import interpolate_dense_attribute as j_interp
from topo4d_tpu.topology.knn import knn_sq_dists as j_knn
from topo4d_tpu.topology.obj_io import MeshObj as JMesh
from topo4d_tpu.topology.obj_io import vertex_uv_multiplicity as j_mult

from topo4d_tpu_torch.config import Config
from topo4d_tpu_torch.opt.constraints import apply_constraints
from topo4d_tpu_torch.pipeline.scene import build_dense_pre_constraints, build_scene, init_dense_params
from topo4d_tpu_torch.testing import make_synthetic_regions
from topo4d_tpu_torch.topology.adjacency import split_faces_by_mask
from topo4d_tpu_torch.topology.densify_uv import build_dense_topology, densify_quads
from topo4d_tpu_torch.topology.interpolate import interpolate_dense_attribute
from topo4d_tpu_torch.topology.knn import knn_sq_dists
from topo4d_tpu_torch.topology.obj_io import MeshObj, vertex_uv_multiplicity

CPU = "cpu"


def seam_mesh(rows=6, cols=7):
    """Grid quads with two UV islands split at column cols // 2."""
    verts, faces = j_grid(rows, cols, extent=0.5)
    cm = cols // 2
    u_left = np.linspace(0.05, 0.46, cm + 1)
    u_right = np.linspace(0.54, 0.95, cols - cm)
    v_grid = np.linspace(0.05, 0.95, rows)
    left = np.full((rows, cols), -1, np.int64)
    right = np.full((rows, cols), -1, np.int64)
    uv_list = []
    for r in range(rows):
        for c in range(cm + 1):
            left[r, c] = len(uv_list)
            uv_list.append((u_left[c], v_grid[r]))
    for r in range(rows):
        for c in range(cm, cols):
            right[r, c] = len(uv_list)
            uv_list.append((u_right[c - cm], v_grid[r]))
    uv_faces = []
    for f in faces:
        ids = left if min(int(v) % cols for v in f) < cm else right
        uv_faces.append([int(ids[int(v) // cols, int(v) % cols]) for v in f])
    return verts, faces, np.asarray(uv_list, np.float32), uv_faces


def _front_mask(n):
    return np.random.default_rng(4).choice(n, n // 3, replace=False)


def test_vertex_uv_multiplicity_matches_jax():
    verts, faces, uvs, uv_faces = seam_mesh()
    a = vertex_uv_multiplicity(verts.shape[0], faces, uv_faces, uvs)
    b = j_mult(verts.shape[0], faces, uv_faces, uvs)
    assert a == b
    assert max(len(m) for m in a) == 2  # the seam column


def test_split_faces_by_mask_matches_jax():
    verts, faces, _, _ = seam_mesh()
    quads = np.asarray(faces)
    idx = np.arange(len(faces))
    mask = _front_mask(verts.shape[0])
    for x, y in zip(split_faces_by_mask(quads, idx, mask), j_split(quads, idx, mask)):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype


@pytest.mark.parametrize("density", [1, 3])
def test_densify_quads_matches_jax(density):
    verts, faces, uvs, uv_faces = seam_mesh()
    mult = [len(m) for m in j_mult(verts.shape[0], faces, uv_faces, uvs)]
    quads = np.asarray(faces)
    uvq = np.asarray(uv_faces)
    a = densify_quads(verts, uvs, quads, uvq, density, mult)
    b = j_densify(verts, uvs, quads, uvq, density, mult)
    assert b.num_seam_edge_instances > 0 and b.num_shared_edges > 0
    for name in ("dense_quad_faces", "dense_uv_quad_faces", "father_face", "quad_faces"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    for name in ("num_base_vertices", "num_base_uvs", "num_shared_edges", "num_seam_edge_instances"):
        assert getattr(a, name) == getattr(b, name), name
    for name in ("dense_vertices", "dense_uvs", "weights"):
        np.testing.assert_allclose(getattr(a, name), getattr(b, name), rtol=1e-6, atol=1e-6, err_msg=name)


def test_build_dense_topology_matches_jax():
    verts, faces, uvs, uv_faces = seam_mesh()
    # a mixed-arity mesh: split two quads into triangles
    faces = [list(f) for f in faces]
    uv_faces = [list(f) for f in uv_faces]
    for i in (0, 5):
        q, u = faces[i], uv_faces[i]
        faces[i], uv_faces[i] = q[:3], u[:3]
        faces.append([q[0], q[2], q[3]])
        uv_faces.append([u[0], u[2], u[3]])
    mult = [len(m) for m in j_mult(verts.shape[0], faces, uv_faces, uvs)]
    mask = _front_mask(verts.shape[0])
    a = build_dense_topology(verts, uvs, faces, uv_faces, mask, 2, mult)
    b = j_build_dense(verts, uvs, faces, uv_faces, mask, 2, mult)
    np.testing.assert_array_equal(a.tri_faces, b.tri_faces)
    np.testing.assert_array_equal(a.tri_uv_faces, b.tri_uv_faces)
    np.testing.assert_allclose(a.topo.dense_vertices, b.topo.dense_vertices, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def dense_scenes():
    verts, faces, uvs, uv_faces = seam_mesh(8, 9)
    n = verts.shape[0]
    jcfg, tcfg = JConfig(), Config()
    for c in (jcfg, tcfg):
        c.texture.gen_tex = True
        c.texture.density = 2
    jp, js = j_build_scene(
        JMesh(vertices=verts, uvs=uvs, faces=faces, uv_faces=uv_faces), j_regions(n, faces), jcfg, num_views=2
    )
    tp, ts = build_scene(
        MeshObj(vertices=verts, uvs=uvs, faces=faces, uv_faces=uv_faces),
        make_synthetic_regions(n, faces), tcfg, num_views=2,
    )
    rng = np.random.default_rng(5)
    colors = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    jp["rgb_colors"] = colors
    tp["rgb_colors"] = colors.copy()
    return jp, js, tp, ts


def test_scene_dense_mesh_matches_jax(dense_scenes):
    _, js, _, ts = dense_scenes
    np.testing.assert_array_equal(ts.dense.tri_faces, js.dense.tri_faces)
    np.testing.assert_array_equal(ts.dense.topo.father_face, js.dense.topo.father_face)
    np.testing.assert_allclose(ts.dense.topo.dense_vertices, js.dense.topo.dense_vertices, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ts.uvs, js.uvs)
    assert ts.uv_faces == js.uv_faces


def test_interpolate_dense_attribute_matches_jax(dense_scenes):
    _, js, _, _ = dense_scenes
    topo = js.dense.topo
    attr = np.random.default_rng(6).normal(size=(topo.num_base_vertices, 3)).astype(np.float32)
    a = interpolate_dense_attribute(
        torch.as_tensor(attr), torch.as_tensor(topo.quad_faces),
        torch.as_tensor(topo.father_face), torch.as_tensor(topo.weights),
    ).numpy()
    b = np.asarray(j_interp(jnp.asarray(attr), jnp.asarray(topo.quad_faces),
                            jnp.asarray(topo.father_face), jnp.asarray(topo.weights)))
    assert a.shape == (topo.dense_vertices.shape[0], 3)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_init_dense_params_matches_jax(dense_scenes):
    jp, js, tp, ts = dense_scenes
    a = init_dense_params(tp, ts, 2)
    b = j_init_dense(jp, js, 2)
    assert set(a) == set(b)
    for k in b:
        assert a[k].dtype == np.float32 and a[k].shape == np.asarray(b[k]).shape, k
        np.testing.assert_allclose(a[k], np.asarray(b[k]), rtol=1e-5, atol=1e-7, err_msg=k)


def test_dense_pre_constraints_match_jax(dense_scenes):
    jp, js, tp, ts = dense_scenes
    dense = init_dense_params(tp, ts, 2)
    x = np.random.default_rng(7).uniform(0.1, 0.9, dense["dense_rgb_colors"].shape).astype(np.float32)
    a = apply_constraints({"dense_rgb_colors": torch.as_tensor(x)}, build_dense_pre_constraints(dense, ts.regions, CPU))
    b = j_apply({"dense_rgb_colors": jnp.asarray(x)}, j_pre(dense, js.regions))
    np.testing.assert_array_equal(a["dense_rgb_colors"].numpy(), np.asarray(b["dense_rgb_colors"]))
    assert (a["dense_rgb_colors"].numpy() == 0).any()


@pytest.mark.parametrize("k", [1, 4])
def test_knn_matches_jax(dense_scenes, k):
    _, js, _, _ = dense_scenes
    pts = js.dense.topo.dense_vertices.copy()
    pts[7] = pts[3]  # a coincident duplicate: another point, distance 0
    a = knn_sq_dists(pts, k)
    b = j_knn(pts, k)
    assert a.shape == b.shape == (pts.shape[0], k)
    # JAX's |q|^2 - 2 q.p + |p|^2 in float32 cancels to ~eps * |p|^2
    atol = 8 * np.finfo(np.float32).eps * float(np.max(np.sum(pts.astype(np.float64) ** 2, -1)))
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=atol)
    assert a[7, 0] == 0.0 and a[3, 0] == 0.0
