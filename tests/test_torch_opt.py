"""The optimizer and the region constraints of the PyTorch port against the
JAX package on the CPU: Adam (eps 1e-15, learning rates given per step),
the moment reset, dense constraint compilation and application, and the
per-phase scene constraints. Tolerance 1e-6; constraint writes exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topo4d_tpu.opt.adam import adam_init as j_adam_init
from topo4d_tpu.opt.adam import adam_update as j_adam_update
from topo4d_tpu.opt.adam import reset_moments as j_reset
from topo4d_tpu.opt.constraints import ScatterConstraint as JScatter
from topo4d_tpu.opt.constraints import apply_constraints as j_apply
from topo4d_tpu.opt.constraints import compile_dense_constraints as j_compile
from topo4d_tpu.opt.constraints import inverse_sigmoid as j_inverse_sigmoid
from topo4d_tpu.pipeline.scene import build_constraints as j_build_constraints
from topo4d_tpu.pipeline.scene import cache_first_frame_attrs as j_ffa
from topo4d_tpu.testing import make_grid_mesh
from topo4d_tpu.testing import make_synthetic_regions as j_regions

from topo4d_tpu_torch import convert
from topo4d_tpu_torch.opt.adam import adam_init, adam_update, reset_moments
from topo4d_tpu_torch.opt.constraints import (
    ScatterConstraint,
    apply_constraints,
    compile_dense_constraints,
    inverse_sigmoid,
)
from topo4d_tpu_torch.pipeline.scene import build_constraints, cache_first_frame_attrs
from topo4d_tpu_torch.testing import make_synthetic_regions

CPU = "cpu"


def _params(seed, n=50):
    rng = np.random.default_rng(seed)
    return {
        "means3D": rng.normal(size=(n, 3)).astype(np.float32),
        "unnorm_rotations": rng.normal(size=(n, 4)).astype(np.float32),
        "logit_opacities": rng.normal(size=(n, 1)).astype(np.float32),
        "cam_m": rng.normal(size=(4, 3)).astype(np.float32),
    }


LRS = {"means3D": 1.6e-5, "unnorm_rotations": 1e-3, "logit_opacities": 0.0, "cam_m": 1e-4}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adam_matches_jax_over_steps(seed):
    p = _params(seed)
    rng = np.random.default_rng(100 + seed)
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    sj = j_adam_init(pj)
    pt = convert.params_from_numpy(p, CPU)
    st = adam_init(pt)
    for step in range(6):
        g = {k: rng.normal(scale=10.0 ** rng.integers(-6, 1), size=v.shape).astype(np.float32) for k, v in p.items()}
        lr = {k: v * (1 + step) for k, v in LRS.items()}  # a new learning rate every step
        pj, sj = j_adam_update(pj, {k: jnp.asarray(v) for k, v in g.items()}, sj, {k: jnp.asarray(v, jnp.float32) for k, v in lr.items()})
        pt, st = adam_update(pt, {k: torch.as_tensor(v) for k, v in g.items()}, st, lr)
    for k in p:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=0, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(st.mu[k].numpy(), np.asarray(sj.mu[k]), rtol=1e-6, atol=1e-12, err_msg=k)
        np.testing.assert_allclose(st.nu[k].numpy(), np.asarray(sj.nu[k]), rtol=1e-6, atol=1e-18, err_msg=k)
        assert st.step[k] == int(sj.step[k])


def test_reset_moments_matches_jax():
    p = _params(3)
    g = {k: np.ones_like(v) for k, v in p.items()}
    pj, sj = j_adam_update({k: jnp.asarray(v) for k, v in p.items()}, {k: jnp.asarray(v) for k, v in g.items()},
                           j_adam_init({k: jnp.asarray(v) for k, v in p.items()}), {k: jnp.asarray(1e-3) for k in p})
    sj = j_reset(sj, ["means3D", "unnorm_rotations"])
    pt, st = adam_update(convert.params_from_numpy(p, CPU), {k: torch.as_tensor(v) for k, v in g.items()},
                         adam_init(convert.params_from_numpy(p, CPU)), {k: 1e-3 for k in p})
    st = reset_moments(st, ["means3D", "unnorm_rotations"])
    for k in p:
        np.testing.assert_array_equal(st.mu[k].numpy(), np.asarray(sj.mu[k]))
        np.testing.assert_allclose(st.nu[k].numpy(), np.asarray(sj.nu[k]), rtol=1e-6)
        assert st.step[k] == int(sj.step[k]) == 1


def test_adam_state_converts_from_jax():
    p = _params(4)
    _, sj = j_adam_update({k: jnp.asarray(v) for k, v in p.items()}, {k: jnp.asarray(v) for k, v in p.items()},
                          j_adam_init({k: jnp.asarray(v) for k, v in p.items()}), {k: jnp.asarray(1e-3) for k in p})
    st = convert.adam_state_from_numpy(sj, CPU)
    assert st.step == {k: 1 for k in p}
    for k in p:
        np.testing.assert_array_equal(st.mu[k].numpy(), np.asarray(sj.mu[k]))


def _constraint_sets(p):
    rng = np.random.default_rng(7)
    return [
        ("means3D", np.array([1, 3, 5]), rng.normal(size=(3, 3)).astype(np.float32)),
        ("logit_opacities", np.array([2, 4]), np.full((2, 1), -3.0, np.float32)),
        ("means3D", np.array([3, 7]), rng.normal(size=(2, 3)).astype(np.float32)),  # later write wins
        ("unnorm_rotations", np.arange(10, 20), np.tile(np.array([1.0, 0, 0, 0], np.float32), (10, 1))),
    ]


def test_compile_dense_constraints_matches_jax():
    p = _params(5)
    sets = _constraint_sets(p)
    dj = j_compile({k: jnp.asarray(v) for k, v in p.items()}, [JScatter(idx=i, value=jnp.asarray(v), param=k) for k, i, v in sets])
    dt = compile_dense_constraints(p, [ScatterConstraint(idx=i, value=v, param=k) for k, i, v in sets], CPU)
    assert [c.param for c in dt] == [c.param for c in dj]
    for a, b in zip(dt, dj):
        np.testing.assert_array_equal(a.mask.numpy(), np.asarray(b.mask))
        np.testing.assert_array_equal(a.value.numpy(), np.asarray(b.value))


@pytest.mark.parametrize("dense_jax", [True, False], ids=["dense", "scatter"])
def test_apply_constraints_matches_jax(dense_jax):
    p = _params(6)
    sets = _constraint_sets(p)
    cons_j = [JScatter(idx=i, value=jnp.asarray(v), param=k) for k, i, v in sets]
    if dense_jax:
        cons_j = j_compile({k: jnp.asarray(v) for k, v in p.items()}, cons_j)
    out_j = j_apply({k: jnp.asarray(v) for k, v in p.items()}, cons_j)
    cons_t = compile_dense_constraints(p, [ScatterConstraint(idx=i, value=v, param=k) for k, i, v in sets], CPU)
    out_t = apply_constraints(convert.params_from_numpy(p, CPU), cons_t)
    for k in p:
        np.testing.assert_array_equal(out_t[k].numpy(), np.asarray(out_j[k]), err_msg=k)


def test_inverse_sigmoid_matches_jax():
    for x in (1e-6, 0.5, 0.99999):
        assert inverse_sigmoid(x) == j_inverse_sigmoid(x)


@pytest.fixture(scope="module")
def scene_like():
    verts, faces = make_grid_mesh(6, 7)
    n = verts.shape[0]
    rng = np.random.default_rng(8)
    p0 = {
        "means3D": verts,
        "rgb_colors": rng.uniform(size=(n, 3)).astype(np.float32),
        "logit_opacities": rng.normal(size=(n, 1)).astype(np.float32),
        "log_scales": rng.normal(size=(n, 3)).astype(np.float32),
    }
    return p0, j_regions(n, faces), make_synthetic_regions(n, faces)


@pytest.mark.parametrize("phase", ["init_early", "init", "track"])
def test_scene_constraints_match_jax(scene_like, phase):
    p0, rj, rt = scene_like
    ffa_j = j_ffa({k: jnp.asarray(v) for k, v in p0.items()}, rj) if phase == "track" else None
    ffa_t = cache_first_frame_attrs(p0, rt) if phase == "track" else None
    cj = j_build_constraints(phase, {k: jnp.asarray(v) for k, v in p0.items()}, rj, ffa_j)
    ct = build_constraints(phase, p0, rt, ffa_t, CPU)
    assert [c.param for c in ct] == [c.param for c in cj]
    for a, b in zip(ct, cj):
        np.testing.assert_array_equal(a.mask.numpy(), np.asarray(b.mask), err_msg=a.param)
        np.testing.assert_array_equal(a.value.numpy(), np.asarray(b.value), err_msg=a.param)
