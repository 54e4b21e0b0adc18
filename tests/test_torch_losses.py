"""The loss stack of the PyTorch port against the JAX package on the CPU:
photometric loss (L1 + SSIM), PSNR, the temporal losses, the fused
flatten and umbrella losses, and ``build_topo_losses`` in both phases.

Tolerances: values rtol 1e-5; gradients rtol 1e-4 / atol 1e-7, divided by
their largest magnitude first, as the JAX suite compares gradients
(tests/test_rasterizer_pallas.py:89-94): an atol below float32 resolution
of a leaf's scale would test rounding, not the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topo4d_tpu.losses.flatten import build_dihedral_quadruples as j_quads
from topo4d_tpu.losses.flatten import build_fused_flatten as j_fused
from topo4d_tpu.losses.flatten import build_fused_umbrella as j_fused_umb
from topo4d_tpu.losses.flatten import build_umbrella_flatten as j_umb
from topo4d_tpu.losses.flatten import dihedral_cos as j_dcos
from topo4d_tpu.losses.flatten import fused_flatten_loss as j_flat_loss
from topo4d_tpu.losses.flatten import fused_umbrella_loss as j_umb_loss
from topo4d_tpu.losses.image import _shift_pass as j_shift_pass
from topo4d_tpu.losses.image import l1_loss as j_l1
from topo4d_tpu.losses.image import l1_loss_sum_last as j_l1_sum_last
from topo4d_tpu.losses.image import photometric_loss as j_photo
from topo4d_tpu.losses.image import psnr as j_psnr
from topo4d_tpu.losses.image import ssim as j_ssim
from topo4d_tpu.losses.neighbors import build_inverse_incidence as j_inv
from topo4d_tpu.losses.temporal import make_temporal_priors as j_temporal
from topo4d_tpu.losses.temporal import rigid_rot_iso_losses as j_rri
from topo4d_tpu.core.gaussian import activate_params as j_activate
from topo4d_tpu.opt.step import GeometryPriors as JPriors
from topo4d_tpu.opt.step import build_topo_losses as j_topo
from topo4d_tpu.testing import make_grid_mesh
from topo4d_tpu.topology.adjacency import build_one_ring as j_one_ring
from topo4d_tpu.topology.adjacency import triangulate_faces as j_tri

from topo4d_tpu_torch.core.gaussian import activate_params
from topo4d_tpu_torch.losses.flatten import (
    build_dihedral_quadruples,
    build_fused_flatten,
    build_fused_umbrella,
    build_umbrella_flatten,
    dihedral_cos,
    fused_flatten_loss,
    fused_umbrella_loss,
    to_device,
)
from topo4d_tpu_torch.losses.image import _shift_pass, l1_abs, l1_loss, l1_loss_sum_last, photometric_loss, psnr, ssim
from topo4d_tpu_torch.losses.neighbors import build_inverse_incidence, gather_rows_inv
from topo4d_tpu_torch.losses.temporal import make_temporal_priors, rigid_rot_iso_losses
from topo4d_tpu_torch.opt.step import HARD_FLATTEN_KEYS, SOFT_FLATTEN_KEYS, UMBRELLA_KEYS, GeometryPriors, build_topo_losses
from topo4d_tpu_torch.topology.adjacency import build_one_ring

CPU = "cpu"
WEIGHTS = {
    "rigid": 3.5, "rot": 20.0, "iso": 20.0,
    "flat": 2e-4, "flat_lip_bottom": 2e-4, "flat_lid_top": 2e-4,
    "flat_lid_bottom": 1e-2, "flat_lip": 1e-4, "flat_mouth": 1e-3,
    "flat_eye": 1e4, "flat_face_bottom": 1e3, "flat_lip_socket": 1e3,
    "scale": 10.0, "scale_max": 10.0,
}


def _grads_close(a, b, err_msg=""):
    scale = max(np.abs(b).max(), 1e-30)
    np.testing.assert_allclose(a / scale, b / scale, rtol=1e-4, atol=1e-7, err_msg=err_msg)


def _images(seed, c=3, h=40, w=52):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (c, h, w)).astype(np.float32), rng.uniform(0, 1, (c, h, w)).astype(np.float32)


# ---------------------------------------------------------------------------
# photometric
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axis", [1, 2])
def test_shift_pass_matches_jax(axis):
    a, _ = _images(0)
    np.testing.assert_allclose(
        _shift_pass(torch.as_tensor(a), axis, 11, 1.5).numpy(), np.asarray(j_shift_pass(jnp.asarray(a), axis, 11, 1.5)),
        rtol=1e-5, atol=1e-7,
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_ssim_and_psnr_match_jax(seed):
    a, b = _images(seed)
    np.testing.assert_allclose(float(ssim(torch.as_tensor(a), torch.as_tensor(b))), float(j_ssim(a, b)), rtol=1e-5)
    np.testing.assert_allclose(
        ssim(torch.as_tensor(a), torch.as_tensor(b), size_average=False).numpy(),
        np.asarray(j_ssim(a, b, size_average=False)), rtol=1e-5,
    )
    np.testing.assert_allclose(psnr(torch.as_tensor(a), torch.as_tensor(b)).numpy(), np.asarray(j_psnr(a, b)), rtol=1e-5)


@pytest.mark.parametrize("seed,shape", [(0, (3, 40, 52)), (1, (3, 64, 48)), (2, (1, 17, 23))])
def test_photometric_loss_and_gradient_match_jax(seed, shape):
    a, b = _images(seed, *shape)
    vj, gj = jax.value_and_grad(j_photo)(jnp.asarray(a), jnp.asarray(b))
    x = torch.as_tensor(a).requires_grad_(True)
    v = photometric_loss(x, torch.as_tensor(b))
    v.backward()
    np.testing.assert_allclose(float(v.detach()), float(vj), rtol=1e-5)
    _grads_close(x.grad.numpy(), np.asarray(gj))


def test_l1_gradient_at_zero_residual():
    """Where prediction equals target exactly, JAX's |x| has gradient +1
    (``jax.grad(jnp.abs)(0.0) == 1``), and so has the port's (``l1_abs``),
    though ``torch.abs``'s is 0: the soft-color anchor sits there on a
    frame's first dense step. Both L1 forms, and ``l1_abs`` at -0.0, NaN and
    the infinities, against JAX."""
    a = np.zeros((3, 4, 5), np.float32)
    gj = np.asarray(jax.grad(j_l1)(jnp.asarray(a), jnp.asarray(a)))
    x = torch.as_tensor(a).requires_grad_(True)
    l1_loss(x, torch.as_tensor(a)).backward()
    np.testing.assert_array_equal(gj, np.full_like(a, 1.0 / a.size))
    np.testing.assert_array_equal(x.grad.numpy(), gj)
    gj = np.asarray(jax.grad(j_l1_sum_last)(jnp.asarray(a), jnp.asarray(a)))
    x = torch.as_tensor(a).requires_grad_(True)
    l1_loss_sum_last(x, torch.as_tensor(a)).backward()
    np.testing.assert_array_equal(x.grad.numpy(), gj)
    edge = np.array([-1.0, -0.0, 0.0, 1.0, np.nan, -np.inf, np.inf], np.float32)
    x = torch.as_tensor(edge).requires_grad_(True)
    torch.sum(l1_abs(x)).backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jax.vmap(jax.grad(jnp.abs))(jnp.asarray(edge))))


# ---------------------------------------------------------------------------
# one-ring, temporal, flatten, umbrella
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh():
    verts, faces = make_grid_mesh(7, 6)
    verts = verts * 0.05
    n = verts.shape[0]
    rng = np.random.default_rng(4)
    ring_j = j_one_ring(verts, faces)
    ring_t = build_one_ring(verts, faces)
    # a bent patch: dihedral cosines away from -1, where sqrt(1 - cos^2)
    # cancels and float32 gradients of the flatten losses are ill-conditioned
    verts = verts + rng.normal(0, 4e-3, verts.shape).astype(np.float32)
    tris = np.asarray(j_tri(faces))
    prev = verts + rng.normal(0, 2e-3, verts.shape).astype(np.float32)
    rots = rng.normal(size=(n, 4)).astype(np.float32)
    prev_rots = rots + rng.normal(0, 0.05, rots.shape).astype(np.float32)
    return verts, faces, tris, ring_j, ring_t, prev, rots, prev_rots


def test_inverse_incidence_matches_jax(mesh):
    _, _, _, ring_j, _, _, _, _ = mesh
    idx = ring_j.indices.T.reshape(-1)
    np.testing.assert_array_equal(build_inverse_incidence(idx, ring_j.indices.shape[0]), j_inv(idx, ring_j.indices.shape[0]))


def test_gather_rows_inv_backward_is_the_scatter_sum(mesh):
    verts, _, _, ring_j, _, _, _, _ = mesh
    n = verts.shape[0]
    idx = ring_j.indices.T.reshape(-1)
    inv = torch.as_tensor(build_inverse_incidence(idx, n))
    table = torch.as_tensor(verts).requires_grad_(True)
    g = torch.as_tensor(np.random.default_rng(0).normal(size=(idx.shape[0], 3)).astype(np.float32))
    (gather_rows_inv(table, torch.as_tensor(idx).long(), inv) * g).sum().backward()
    ref = torch.zeros(n, 3).index_add_(0, torch.as_tensor(idx).long(), g)
    torch.testing.assert_close(table.grad, ref, rtol=1e-5, atol=1e-6)


def test_temporal_priors_match_jax(mesh):
    verts, _, _, ring_j, _, prev, _, prev_rots = mesh
    q = prev_rots / np.linalg.norm(prev_rots, axis=1, keepdims=True)
    pj = j_temporal(jnp.asarray(prev), jnp.asarray(q), jnp.asarray(ring_j.indices.T))
    pt = make_temporal_priors(torch.as_tensor(prev), torch.as_tensor(q), torch.as_tensor(ring_j.indices.T.copy()).long())
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("with_inv", [False, True], ids=["gather", "inverse_incidence"])
def test_rigid_rot_iso_losses_match_jax(mesh, with_inv):
    verts, _, _, ring_j, _, prev, rots, prev_rots = mesh
    n = verts.shape[0]
    idx = ring_j.indices.T.copy()
    qn = lambda q: q / np.linalg.norm(q, axis=1, keepdims=True)
    w = ring_j.weight.T
    dist = ring_j.dist.T * 1.1  # rest distances off the current ones (no kink)
    inv_np = j_inv(idx.reshape(-1), n) if with_inv else None

    def lj(m, r):
        pri = j_temporal(jnp.asarray(prev), jnp.asarray(qn(prev_rots)), jnp.asarray(idx))
        out = j_rri(m, r / jnp.linalg.norm(r, axis=1, keepdims=True), pri, jnp.asarray(idx), jnp.asarray(dist),
                    jnp.asarray(w), jnp.asarray(w * 2), jnp.asarray(w * 3), ring_inv=inv_np)
        return out["rigid"] + 2 * out["rot"] + 3 * out["iso"], out

    (vj, oj), gj = jax.jit(jax.value_and_grad(lj, argnums=(0, 1), has_aux=True))(jnp.asarray(verts), jnp.asarray(rots))
    m = torch.as_tensor(verts).requires_grad_(True)
    r = torch.as_tensor(rots).requires_grad_(True)
    it = torch.as_tensor(idx).long()
    pri = make_temporal_priors(torch.as_tensor(prev), torch.as_tensor(qn(prev_rots)), it)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    out = rigid_rot_iso_losses(
        m, r / torch.linalg.vector_norm(r, dim=1, keepdim=True), pri, it, t(dist), t(w), t(w * 2), t(w * 3),
        ring_inv=t(inv_np) if with_inv else None,
    )
    (out["rigid"] + 2 * out["rot"] + 3 * out["iso"]).backward()
    for k in ("rigid", "rot", "iso"):
        np.testing.assert_allclose(float(out[k].detach()), float(oj[k]), rtol=1e-5, err_msg=k)
    _grads_close(m.grad.numpy(), np.asarray(gj[0]), "means")
    _grads_close(r.grad.numpy(), np.asarray(gj[1]), "rotations")


def test_dihedral_quadruples_and_cos_match_jax(mesh):
    verts, _, tris, _, _, _, _, _ = mesh
    qj = j_quads(tris)
    qt = build_dihedral_quadruples(tris)
    for a, b in zip(qt, qj):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(
        dihedral_cos(torch.as_tensor(verts), qt).numpy(), np.asarray(j_dcos(jnp.asarray(verts), qj)), rtol=1e-5, atol=1e-6
    )


def _quad_sets(tris):
    rng = np.random.default_rng(9)
    sets = {}
    for i, k in enumerate(HARD_FLATTEN_KEYS + SOFT_FLATTEN_KEYS):
        sub = tris[np.sort(rng.choice(tris.shape[0], tris.shape[0] // 2 + i, replace=False))]
        sets[k] = sub
    return sets


@pytest.mark.parametrize("soft_init", [False, True], ids=["frame0", "tracked"])
def test_fused_flatten_loss_matches_jax(mesh, soft_init):
    verts, _, tris, _, _, prev, _, _ = mesh
    sets = _quad_sets(tris)
    fj = j_fused({k: j_quads(v) for k, v in sets.items()}, HARD_FLATTEN_KEYS, SOFT_FLATTEN_KEYS)
    ft = build_fused_flatten({k: build_dihedral_quadruples(v) for k, v in sets.items()}, HARD_FLATTEN_KEYS, SOFT_FLATTEN_KEYS)
    cos0 = np.asarray(j_dcos(jnp.asarray(prev), fj.quads))[fj.num_hard:] if soft_init else None
    wj = {k: jnp.asarray(v, jnp.float32) for k, v in WEIGHTS.items()}
    (vj, cj), gj = jax.jit(jax.value_and_grad(
        lambda x: j_flat_loss(x, fj, wj, None if cos0 is None else jnp.asarray(cos0)), has_aux=True
    ))(jnp.asarray(verts))
    x = torch.as_tensor(verts).requires_grad_(True)
    vt, ct = fused_flatten_loss(x, ft, WEIGHTS, None if cos0 is None else torch.as_tensor(cos0.copy()))
    vt.backward()
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-5)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5, atol=1e-6)
    _grads_close(x.grad.numpy(), np.asarray(gj))


def test_fused_umbrella_loss_matches_jax(mesh):
    verts, _, _, ring_j, ring_t, _, _, _ = mesh
    n = verts.shape[0]
    rng = np.random.default_rng(2)
    regions = {k: np.sort(rng.choice(n, n // 3, replace=False)) for k in UMBRELLA_KEYS}
    uj = j_fused_umb({k: j_umb(ring_j.ragged, n, region=r) for k, r in regions.items()}, UMBRELLA_KEYS)
    ut = build_fused_umbrella({k: build_umbrella_flatten(ring_t.ragged, n, region=r) for k, r in regions.items()}, UMBRELLA_KEYS)
    wj = {k: jnp.asarray(v, jnp.float32) for k, v in WEIGHTS.items()}
    vj, gj = jax.jit(jax.value_and_grad(lambda x: j_umb_loss(x, uj, wj)))(jnp.asarray(verts * 1.3 + 0.01))
    x = torch.as_tensor(verts * 1.3 + 0.01).requires_grad_(True)
    vt = fused_umbrella_loss(x, to_device(ut, CPU), WEIGHTS)
    vt.backward()
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-5)
    _grads_close(x.grad.numpy(), np.asarray(gj))


# ---------------------------------------------------------------------------
# build_topo_losses, both phases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("phase", ["init", "track"])
@pytest.mark.parametrize("share_ring", [True, False], ids=["shared_ring", "own_gather"])
def test_build_topo_losses_matches_jax(mesh, phase, share_ring):
    verts, faces, tris, ring_j, ring_t, prev, rots, prev_rots = mesh
    n = verts.shape[0]
    rng = np.random.default_rng(3)
    sets = _quad_sets(tris)
    regions = {k: np.sort(rng.choice(n, n // 3, replace=False)) for k in UMBRELLA_KEYS}
    params = {
        "means3D": verts,
        "rgb_colors": rng.uniform(size=(n, 3)).astype(np.float32),
        "unnorm_rotations": rots,
        "logit_opacities": np.zeros((n, 1), np.float32),
        "log_scales": np.log(0.02 * rng.uniform(0.5, 2.0, (n, 3))).astype(np.float32),
    }
    qn = lambda q: q / np.linalg.norm(q, axis=1, keepdims=True)
    ring_idx = ring_j.indices if share_ring else None

    topo_j = j_topo(
        {k: j_quads(v) for k, v in sets.items()},
        {k: j_umb(ring_j.ragged, n, region=r) for k, r in regions.items()}, ring_idx,
    )
    fj = j_fused({k: j_quads(v) for k, v in sets.items()}, HARD_FLATTEN_KEYS, SOFT_FLATTEN_KEYS)
    cos0 = np.asarray(j_dcos(jnp.asarray(prev), fj.quads))[fj.num_hard:]
    pj = JPriors(
        neighbor_indices=jnp.asarray(ring_j.indices.T), neighbor_dist=jnp.asarray(ring_j.dist.T * 1.1),
        iso_w=jnp.asarray(ring_j.weight.T), rig_w=jnp.asarray(ring_j.weight.T * 2), rot_w=jnp.asarray(ring_j.weight.T * 3),
        init_scale=jnp.full((n,), 0.015),
        temporal=j_temporal(jnp.asarray(prev), jnp.asarray(qn(prev_rots)), jnp.asarray(ring_j.indices.T)),
        cos_init=jnp.asarray(cos0),
    )
    wj = {k: jnp.asarray(v, jnp.float32) for k, v in WEIGHTS.items()}

    def lj(p):
        losses, new_cos, pre = topo_j(j_activate(p), pj, wj, phase)
        return sum(wj[k] * v for k, v in losses.items()) + pre, (losses, new_cos)

    (vj, (losses_j, cos_j)), gj = jax.jit(jax.value_and_grad(lj, has_aux=True))({k: jnp.asarray(v) for k, v in params.items()})

    topo_t = build_topo_losses(
        {k: build_dihedral_quadruples(v) for k, v in sets.items()},
        {k: build_umbrella_flatten(ring_t.ragged, n, region=r) for k, r in regions.items()}, n, ring_idx, CPU,
    )
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    it = t(ring_t.indices.T).long()
    pt = GeometryPriors(
        neighbor_indices=it, neighbor_dist=t(ring_t.dist.T * 1.1), iso_w=t(ring_t.weight.T),
        rig_w=t(ring_t.weight.T * 2), rot_w=t(ring_t.weight.T * 3), init_scale=torch.full((n,), 0.015),
        temporal=make_temporal_priors(t(prev), t(qn(prev_rots)), it), cos_init=t(cos0),
    )
    tp = {k: t(v).requires_grad_(True) for k, v in params.items()}
    losses_t, cos_t, pre_t = topo_t(activate_params(tp), pt, WEIGHTS, phase)
    vt = sum(WEIGHTS[k] * v for k, v in losses_t.items()) + pre_t
    vt.backward()
    assert set(losses_t) == set(losses_j)
    for k in losses_j:
        np.testing.assert_allclose(float(losses_t[k].detach()), float(losses_j[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-5)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), rtol=1e-5, atol=1e-6)
    for k in ("means3D", "unnorm_rotations", "log_scales"):
        g = tp[k].grad
        # a leaf the phase does not use has no gradient in torch, zeros in JAX
        _grads_close(np.zeros_like(params[k]) if g is None else g.numpy(), np.asarray(gj[k]), k)
