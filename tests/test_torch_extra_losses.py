"""``losses/extra.py`` of the port against the JAX package's, each case of
``tests/test_extra_losses.py`` on the same inputs: the tables equal, the
losses at rtol 1e-6 (the reference formulas as there), and their gradients
in the port."""

import jax.numpy as jnp
import numpy as np
import torch

from topo4d_tpu.losses import extra as J
from topo4d_tpu.testing import make_grid_mesh
from topo4d_tpu.topology.adjacency import triangulate_faces

from topo4d_tpu_torch.losses import extra as P


def _tri_mesh(seed=0):
    verts, faces = make_grid_mesh(5, 5, extent=0.5, seed=seed)
    tris = np.asarray(triangulate_faces([list(f) for f in faces]), np.int64)
    return verts.astype(np.float32), tris


def _close(got, want, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(float(got), float(want), rtol=rtol, atol=atol)


def _same_tables(lap_p, lap_j):
    for f in ("neighbor_indices", "neighbor_weight", "delta_rest"):
        np.testing.assert_array_equal(getattr(lap_p, f), getattr(lap_j, f))


def test_edge_loss_matches_reference_formula():
    verts, tris = _tri_mesh()
    es = P.build_edge_set(tris)
    np.testing.assert_array_equal(es.edges, J.build_edge_set(tris).edges)
    ref_edges = set()
    for t in tris:
        ref_edges |= {tuple(sorted((t[0], t[1]))), tuple(sorted((t[1], t[2]))), tuple(sorted((t[0], t[2])))}
    assert {tuple(sorted(e)) for e in es.edges.tolist()} == ref_edges
    d = np.linalg.norm(verts[es.edges[:, 0]] - verts[es.edges[:, 1]], axis=-1)
    got = P.edge_loss(torch.as_tensor(verts), es)
    np.testing.assert_allclose(float(got), d.std(ddof=1), rtol=1e-5)  # torch.std is Bessel-corrected
    _close(got, J.edge_loss(jnp.asarray(verts), J.build_edge_set(tris)))
    _close(P.edge_loss(torch.as_tensor(verts), es, 2.5), J.edge_loss(jnp.asarray(verts), es, 2.5))


def test_norm_loss_matches_cosine_formula():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, 3)).astype(np.float32)
    n = rng.normal(size=(40, 3)).astype(np.float32)
    cos = np.sum(x * n, 1) / (np.linalg.norm(x, axis=1) * np.linalg.norm(n, axis=1))
    got = P.norm_loss(torch.as_tensor(x), torch.as_tensor(n))
    np.testing.assert_allclose(float(got), np.mean(1 - np.abs(cos)), rtol=1e-5)
    _close(got, J.norm_loss(jnp.asarray(x), jnp.asarray(n)))
    assert float(P.norm_loss(torch.as_tensor(n * 3.0), torch.as_tensor(n))) < 1e-6


def test_laplacian_loss_zero_at_rest_and_positive_after_noise():
    verts, tris = _tri_mesh()
    lap = P.build_uniform_laplacian(verts, tris)
    _same_tables(lap, J.build_uniform_laplacian(verts, tris))
    v = torch.as_tensor(verts)
    assert float(P.laplacian_loss(v, lap)) < 1e-10
    noisy = verts + np.random.default_rng(1).normal(0, 0.01, verts.shape).astype(np.float32)
    full = P.laplacian_loss(torch.as_tensor(noisy), lap)
    sub = P.laplacian_loss(torch.as_tensor(noisy), lap, mask=[0, 1, 2])
    assert float(full) > 1e-6 and 0 <= float(sub) <= float(full)
    _close(full, J.laplacian_loss(jnp.asarray(noisy), lap), rtol=1e-5)
    _close(sub, J.laplacian_loss(jnp.asarray(noisy), lap, mask=[0, 1, 2]), rtol=1e-5)


def test_laplacian_loss_matches_dense_uniform_laplacian():
    verts, tris = _tri_mesh()
    lap = P.build_uniform_laplacian(verts, tris)
    nv = verts.shape[0]
    dense = np.zeros((nv, nv), np.float64)
    for i, (row_i, row_w) in enumerate(zip(lap.neighbor_indices, lap.neighbor_weight)):
        for j, w in zip(row_i, row_w):
            dense[i, j] += w
        dense[i, i] -= 1.0
    vp = verts + np.random.default_rng(2).normal(0, 0.01, verts.shape).astype(np.float32)
    got = P.laplacian_loss(torch.as_tensor(vp), lap)
    np.testing.assert_allclose(float(got), np.sum((dense @ vp - dense @ verts) ** 2), rtol=1e-4)
    _close(got, J.laplacian_loss(jnp.asarray(vp), lap), rtol=1e-5)


def test_arap_loss_zero_for_rigid_motion():
    verts, tris = _tri_mesh()
    lap = P.build_uniform_laplacian(verts, tris)
    x = torch.as_tensor(verts)
    th = 0.3
    rot = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]], np.float32)
    moved = verts @ rot.T + np.array([0.1, -0.2, 0.05], np.float32)
    rigid = P.arap_loss(x, torch.as_tensor(moved - verts), lap)
    assert float(rigid) < 1e-6
    _close(rigid, J.arap_loss(jnp.asarray(verts), jnp.asarray(moved - verts), lap), atol=1e-7)
    stretch = verts * np.array([1.3, 1.0, 1.0], np.float32) - verts
    got = P.arap_loss(x, torch.as_tensor(stretch), lap)
    assert float(got) > 1e-5
    _close(got, J.arap_loss(jnp.asarray(verts), jnp.asarray(stretch), lap))


def test_losses_carry_gradients():
    """Every loss is differentiable in its vertex argument in the port (the
    regularizers exist to be optimized)."""
    verts, tris = _tri_mesh(seed=1)
    lap = P.build_uniform_laplacian(verts, tris)
    x = torch.as_tensor(verts + 0.01, dtype=torch.float32).requires_grad_(True)
    total = (P.edge_loss(x, P.build_edge_set(tris)) + P.laplacian_loss(x, lap)
             + P.arap_loss(torch.as_tensor(verts), x - torch.as_tensor(verts) * 1.1, lap)
             + P.norm_loss(x, torch.as_tensor(verts) + 1.0))
    (g,) = torch.autograd.grad(total, x)
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0
