"""``core/sh.py`` and ``opt/densify.py`` of the port against the JAX
package's, each case of ``tests/test_densify_sh.py`` on the same seeded
inputs: values at rtol 1e-6; masks, slots, counts and ``overflow`` exact.
The split children take JAX's own normal draws through ``noise``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topo4d_tpu.core import sh as J
from topo4d_tpu.opt import densify as JD
from topo4d_tpu.opt.adam import adam_init as j_adam_init

from topo4d_tpu_torch import convert
from topo4d_tpu_torch.core import sh as P
from topo4d_tpu_torch.opt import densify as PD
from topo4d_tpu_torch.opt.adam import adam_init

CPU = "cpu"
# one compiled program per case instead of hundreds of eager dispatches
j_densify_step = jax.jit(JD.densify_step, static_argnames=("scene_radius",))


def _close(got, want, rtol=1e-6, atol=1e-7):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


# ---------------------------------------------------------------- SH


def test_sh_deg0_is_constant():
    sh = np.ones((5, 3, 1), np.float32)
    dirs = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    got = P.eval_sh(0, torch.as_tensor(sh), torch.as_tensor(dirs))
    _close(got, J.eval_sh(0, jnp.asarray(sh), jnp.asarray(dirs)))
    np.testing.assert_allclose(got.numpy(), P.C0, atol=1e-6)


def test_sh_roundtrip_rgb():
    rgb = np.random.default_rng(1).uniform(0, 1, (10, 3)).astype(np.float32)
    sh = P.rgb_to_sh(torch.as_tensor(rgb))
    _close(sh, J.rgb_to_sh(jnp.asarray(rgb)))
    np.testing.assert_allclose(P.sh_to_rgb(sh).numpy(), rgb, atol=1e-6)
    _close(P.sh_to_rgb(sh), J.sh_to_rgb(jnp.asarray(sh.numpy())))


def test_sh_matches_reference_formula_deg2():
    # the same independent transcription of helpers.py:884-900 as the JAX test
    rng = np.random.default_rng(2)
    sh = rng.normal(size=(4, 1, 9))
    dirs = rng.normal(size=(4, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    c1 = 0.4886025119029199
    c2 = [1.0925484305920792, -1.0925484305920792, 0.31539156525252005, -1.0925484305920792, 0.5462742152960396]
    expected = (
        P.C0 * sh[..., 0]
        - c1 * y * sh[..., 1] + c1 * z * sh[..., 2] - c1 * x * sh[..., 3]
        + c2[0] * x * y * sh[..., 4] + c2[1] * y * z * sh[..., 5]
        + c2[2] * (2 * z * z - x * x - y * y) * sh[..., 6]
        + c2[3] * x * z * sh[..., 7] + c2[4] * (x * x - y * y) * sh[..., 8]
    )
    got = P.eval_sh(2, torch.as_tensor(sh, dtype=torch.float32), torch.as_tensor(dirs, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-5)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_matches_jax(deg):
    rng = np.random.default_rng(10 + deg)
    sh = rng.normal(size=(6, 3, (deg + 1) ** 2)).astype(np.float32)
    dirs = rng.normal(size=(6, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    _close(P.eval_sh(deg, torch.as_tensor(sh), torch.as_tensor(dirs)), J.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs)),
           atol=1e-6)
    with pytest.raises(ValueError, match="degree"):
        P.eval_sh(5, torch.as_tensor(sh), torch.as_tensor(dirs))


# ---------------------------------------------------------------- densify


def small_params(n):
    rng = np.random.default_rng(3)
    return {
        "means3D": rng.normal(0, 1, (n, 3)).astype(np.float32),
        "rgb_colors": rng.uniform(0, 1, (n, 3)).astype(np.float32),
        "unnorm_rotations": np.tile([1.0, 0, 0, 0], (n, 1)).astype(np.float32),
        "logit_opacities": np.full((n, 1), 2.0, np.float32),
        "log_scales": np.full((n, 3), np.log(0.05), np.float32),
    }


def _jax_noise(key, shape, split_n=2):
    """The standard normals JAX's densify_step draws for its split children."""
    out = []
    for _ in range(split_n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape)))
    return torch.as_tensor(np.stack(out))


def _both(n, cap, edit, grads, seed, scene_radius=100.0, with_opt=False, poison=None, radii=None):
    """The same densify pass through both packages -> (port, JAX) results:
    (params, [opt,] state, stats) each, and the accumulated states."""
    params = JD.pad_params({k: jnp.asarray(v) for k, v in small_params(n).items()}, cap)
    params = edit(params)
    pp = convert.params_from_numpy({k: np.asarray(v) for k, v in params.items()}, CPU)
    seen = np.arange(cap) < n
    sj = JD.accumulate_stats(JD.densify_init(n, cap), jnp.asarray(grads), jnp.asarray(seen),
                             None if radii is None else jnp.asarray(radii))
    sp = PD.accumulate_stats(PD.densify_init(n, cap, device=CPU), torch.as_tensor(grads), torch.as_tensor(seen),
                             None if radii is None else torch.as_tensor(radii))
    key = jax.random.PRNGKey(seed)
    kw_j, kw_p = {}, {"noise": _jax_noise(key, (cap, 3))}
    if with_opt:
        oj = j_adam_init(dict(params))
        op = adam_init(pp)
        if poison is not None:
            oj = oj._replace(mu={k: v.at[poison].set(99.0) for k, v in oj.mu.items()},
                             nu={k: v.at[poison].set(99.0) for k, v in oj.nu.items()})
            op = convert.adam_state_from_numpy(oj, CPU)
        kw_j["opt"], kw_p["opt"] = oj, op
    rj = j_densify_step(params, sj, key, scene_radius=scene_radius, **kw_j)
    rp = PD.densify_step(pp, sp, None, scene_radius=scene_radius, **kw_p)
    return rp, rj, sp, sj


def _assert_same(rp, rj):
    """Parameters (and moments) at rtol 1e-6; the alive mask, the state and
    every count exact."""
    *trees_p, state_p, stats_p = rp
    *trees_j, state_j, stats_j = rj
    params_p, params_j = trees_p[0], trees_j[0]
    for k in params_j:
        _close(params_p[k], params_j[k])
    if len(trees_p) == 2:
        for m in ("mu", "nu"):
            for k, v in getattr(trees_j[1], m).items():
                np.testing.assert_array_equal(getattr(trees_p[1], m)[k].numpy(), np.asarray(v))
    np.testing.assert_array_equal(state_p.alive.numpy(), np.asarray(state_j.alive))
    for f in ("grad_accum", "denom", "max_radius"):
        np.testing.assert_array_equal(getattr(state_p, f).numpy(), np.asarray(getattr(state_j, f)))
    assert {k: int(v) for k, v in stats_p.items()} == {k: int(v) for k, v in stats_j.items()}


def test_densify_clone_and_prune():
    n, cap = 8, 32
    grads = np.zeros((cap, 2), np.float32)
    grads[1] = 1.0
    rp, rj, _, _ = _both(n, cap, lambda p: {**p, "logit_opacities": p["logit_opacities"].at[0].set(-10.0)}, grads, 0)
    _assert_same(rp, rj)
    new_params, new_state, stats = rp
    assert int(stats["prunes"]) == 1 and int(stats["clones"]) == 1 and int(stats["overflow"]) == 0
    assert int(stats["alive"]) == 8
    alive = new_state.alive.numpy()
    assert alive[0] and not alive[n:].any()  # the clone took the just-pruned slot 0
    np.testing.assert_allclose(new_params["means3D"][0].numpy(), small_params(n)["means3D"][1], atol=1e-6)


def test_densify_split_replaces_parent():
    n, cap = 4, 32
    grads = np.zeros((cap, 2), np.float32)
    grads[2] = 1.0
    rp, rj, _, _ = _both(n, cap, lambda p: {**p, "log_scales": p["log_scales"].at[2].set(np.log(5.0))}, grads, 1)
    _assert_same(rp, rj)
    new_params, new_state, stats = rp
    assert int(stats["splits"]) == 1 and int(stats["alive"]) == 5
    scales = new_params["log_scales"].numpy()
    children = np.nonzero(new_state.alive.numpy() & np.isclose(scales[:, 0], np.log(5.0) + np.log(1 / 1.6), atol=1e-5))[0]
    assert children.size == 2
    # the children moved off the parent by JAX's draws
    assert np.all(np.abs(new_params["means3D"][children].numpy() - small_params(n)["means3D"][2]).max(axis=1) > 0)


def test_densify_split_draws_from_a_generator():
    """Without ``noise`` the children's offsets come from the generator: the
    same seed gives the same children, another seed others."""
    n, cap = 4, 16
    params = PD.pad_params(convert.params_from_numpy(small_params(n), CPU), cap)
    params["log_scales"][2] = float(np.log(5.0))
    grads = torch.zeros((cap, 2))
    grads[2] = 1.0
    state = PD.accumulate_stats(PD.densify_init(n, cap, device=CPU), grads, torch.arange(cap) < n)
    runs = [PD.densify_step(params, state, torch.Generator().manual_seed(s), scene_radius=100.0)[0]["means3D"]
            for s in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


def test_densify_overflow_counted():
    n, cap = 8, 9  # one free slot
    rp, rj, _, _ = _both(n, cap, lambda p: p, np.ones((cap, 2), np.float32), 2)
    _assert_same(rp, rj)
    assert int(rp[2]["overflow"]) > 0


def test_reset_opacity():
    params = small_params(4)
    out = PD.reset_opacity(convert.params_from_numpy(params, CPU), 0.01)
    want = JD.reset_opacity({k: jnp.asarray(v) for k, v in params.items()}, 0.01)
    _close(out["logit_opacities"], want["logit_opacities"])
    assert (torch.sigmoid(out["logit_opacities"]).numpy() <= 0.0101).all()


def test_densify_overflow_count_exact():
    n, cap = 8, 9  # one free slot, 8 clone requests: 7 dropped
    rp, rj, _, _ = _both(n, cap, lambda p: p, np.ones((cap, 2), np.float32), 0)
    _assert_same(rp, rj)
    stats = rp[2]
    assert int(stats["clones"]) == 8 and int(stats["overflow"]) == 7 and int(stats["alive"]) == 9


def test_densify_reused_slot_gets_zero_moments():
    n, cap = 4, 4  # full: the clone must reuse the pruned slot
    grads = np.zeros((cap, 2), np.float32)
    grads[1] = 1.0
    rp, rj, _, _ = _both(n, cap, lambda p: {**p, "logit_opacities": p["logit_opacities"].at[0].set(-10.0)}, grads, 0,
                         with_opt=True, poison=0)
    _assert_same(rp, rj)
    _, new_opt, new_state, stats = rp
    assert int(stats["clones"]) == 1 and int(stats["prunes"]) == 1 and bool(new_state.alive[0])
    for k in ("means3D", "rgb_colors"):
        assert float(new_opt.mu[k][0].abs().max()) == 0.0 and float(new_opt.nu[k][0].abs().max()) == 0.0
        assert float(new_opt.mu[k][2].abs().max()) == 0.0


def test_accumulate_stats_tracks_max_radius():
    n, cap = 4, 8
    radii = np.arange(cap, dtype=np.int32) * 3
    _, _, sp, sj = _both(n, cap, lambda p: p, np.zeros((cap, 2), np.float32), 0, radii=radii)
    np.testing.assert_array_equal(sp.max_radius.numpy(), np.asarray(sj.max_radius))
    np.testing.assert_allclose(sp.max_radius.numpy()[:4], [0, 3, 6, 9])
    np.testing.assert_allclose(sp.max_radius.numpy()[4:], 0.0)
    back = convert.densify_state_from_numpy(sj, CPU)
    for f in DensifyStateFields:
        np.testing.assert_array_equal(getattr(back, f).numpy(), np.asarray(getattr(sj, f)))


DensifyStateFields = PD.DensifyState._fields
