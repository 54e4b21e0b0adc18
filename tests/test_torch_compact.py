"""Frozen binnings, the split pack and compact-tile mode of the PyTorch port
against the JAX package on the CPU.

The scene leaves part of the canvas empty, so compact mode blends fewer
rows than the canvas has. Integer tables (the compact tile list, its
overflow count) must be equal to JAX's; the split pack's learned rows and
tile row equal the full pack's, its static rows agree to an ulp; compact
renders equal full renders; the port's frozen compact render matches JAX's
``render_gaussians_pallas(interpret=True, binning=binning_for(...,
with_static=True, tile_capacity=cap))`` at the JAX suite's tolerances:
pixels rtol 1e-4 / atol 1e-5, gradients scaled by their largest element
rtol 2e-3 / atol 2e-5. The kernels' compact mode runs only on the card: the
``cuda`` test compares it with the plain version and skips here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topo4d_tpu.core.gaussian import activate_params as j_activate
from topo4d_tpu.core.gaussian import project_gaussians as j_project
from topo4d_tpu.rasterizer.pallas import binning_for as j_binning_for
from topo4d_tpu.rasterizer.pallas import render_gaussians_pallas
from topo4d_tpu.rasterizer.tiles import compact_nonempty_tiles as j_compact
from topo4d_tpu.rasterizer.tiles import compute_binning as j_compute_binning
from topo4d_tpu.rasterizer.tiles import pack_static_rows as j_static_rows
from topo4d_tpu.testing import make_synthetic_camera as j_cam
from topo4d_tpu.testing import make_synthetic_scene

from topo4d_tpu_torch import convert
from topo4d_tpu_torch.core.gaussian import activate_params, project_gaussians
from topo4d_tpu_torch.rasterizer.blend import tile_blend_bwd_cuda, tile_blend_fwd_cuda, tile_blend_plain
from topo4d_tpu_torch.rasterizer.render import attach_compact, binning_for, render_gaussians
from topo4d_tpu_torch.rasterizer.tiles import (
    compact_nonempty_tiles,
    compute_binning,
    pack_with_binning,
)
from topo4d_tpu_torch.testing import make_synthetic_camera

CPU = "cpu"
W, H, SPAN = 128, 96, 8
BG = (0.3, 0.1, 0.2)


@pytest.fixture(scope="module")
def scene():
    params = make_synthetic_scene(n=160, seed=7, spread=0.2)
    cam_j = j_cam(W, H)
    counts = np.asarray(
        j_compute_binning(j_project(j_activate({k: jnp.asarray(v) for k, v in params.items()}), cam_j), W, H, SPAN)
        .tile_count
    )
    occ = int(np.sum(counts > 0))
    assert 2 < occ < counts.shape[0] - 8  # part of the canvas stays empty
    return params, cam_j, make_synthetic_camera(W, H, device=CPU), occ


def _tp(params):
    return {k: v.clone().requires_grad_(True) for k, v in convert.params_from_numpy(params, CPU).items()}


def _loss_t(out, target):
    return (out.image - target).abs().mean() + 0.05 * out.alpha.mean() + 0.02 * out.depth.mean()


def _scaled_close(a, b, err_msg=""):
    scale = max(np.abs(b).max(), 1e-8)
    np.testing.assert_allclose(a / scale, b / scale, rtol=2e-3, atol=2e-5, err_msg=err_msg)


@pytest.mark.parametrize("extra", [5, 0, -3])
def test_compact_nonempty_tiles_matches_jax(scene, extra):
    params, cam_j, _, occ = scene
    rv = j_activate({k: jnp.asarray(v) for k, v in params.items()})
    b = j_compute_binning(j_project(rv, cam_j), W, H, SPAN)
    cap = occ + extra
    ids, start, count, overflow = (np.asarray(x) for x in j_compact(b.tile_start, b.tile_count, cap))
    c = compact_nonempty_tiles(torch.as_tensor(np.array(b.tile_start)), torch.as_tensor(np.array(b.tile_count)), cap)
    for a, e in zip(c, (ids, start, count, overflow)):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), e)
    assert int(c.overflow) == max(0, -extra)


def test_split_pack_matches_full_pack(scene):
    """Learned rows and the tile row equal the full pack's; the static rows
    agree with the full pack's and with JAX's; learned-parameter gradients
    through both packs agree."""
    params, cam_j, cam, occ = scene
    p = _tp(params)
    rv = activate_params(p)
    full = binning_for(rv, cam, SPAN)
    split = binning_for(rv, cam, SPAN, with_static=True)
    assert full.static_rows is None and split.static_rows is not None
    proj = project_gaussians(rv, cam)
    pf = pack_with_binning(proj, rv.colors, rv.opacities, full).packed
    ps = pack_with_binning(proj, rv.colors, rv.opacities, split).packed
    assert pf.shape == ps.shape
    for r in (2, 3, 4, 6, 7, 8, 9, 10, 12, 13, 14, 15):
        np.testing.assert_array_equal(ps[r].detach().numpy(), pf[r].detach().numpy(), err_msg=f"row {r}")
    for r in (0, 1, 5, 11):
        np.testing.assert_allclose(ps[r].detach().numpy(), pf[r].detach().numpy(), rtol=1e-6, atol=1e-6)
    rvj = j_activate({k: jnp.asarray(v) for k, v in params.items()})
    projj = j_project(rvj, cam_j)
    sj = np.asarray(j_static_rows(projj, rvj.opacities, j_compute_binning(projj, W, H, SPAN)))
    np.testing.assert_allclose(split.static_rows.numpy(), sj, rtol=1e-5, atol=1e-4)

    target = torch.as_tensor(np.random.default_rng(1).uniform(0, 1, (3, H, W)).astype(np.float32))
    grads = []
    for b in (full, split):
        q = _tp(params)
        loss = _loss_t(render_gaussians(activate_params(q), cam, bg=torch.tensor(BG), max_span=SPAN, binning=b), target)
        grads.append(torch.autograd.grad(loss, [q["rgb_colors"], q["unnorm_rotations"]]))
    for a, e in zip(*grads):
        np.testing.assert_allclose(a.numpy(), e.numpy(), rtol=1e-6, atol=1e-8)


def test_compact_render_matches_full(scene):
    """tests/test_rasterizer_pallas.py:340 on the port: pixels and
    gradients equal, overflow 0 at enough capacity and counted below it."""
    params, _, cam, occ = scene
    target = torch.as_tensor(np.random.default_rng(5).uniform(0, 1, (3, H, W)).astype(np.float32))
    bg = torch.tensor(BG)
    outs, grads = [], []
    for cap in (None, occ):
        q = _tp(params)
        out = render_gaussians(activate_params(q), cam, bg=bg, max_span=SPAN, tile_capacity=cap)
        outs.append(out)
        grads.append(torch.autograd.grad(_loss_t(out, target), list(q.values())))
    full, compact = outs
    for name in ("image", "depth", "alpha"):
        np.testing.assert_allclose(
            getattr(compact, name).detach().numpy(), getattr(full, name).detach().numpy(), rtol=1e-6, atol=1e-7
        )
    assert int(compact.num_overflow) == 0 and int(full.num_overflow) == 0
    for k, a, e in zip(params, grads[1], grads[0]):
        scale = max(float(e.abs().max()), 1e-8)
        np.testing.assert_allclose(a.numpy() / scale, e.numpy() / scale, rtol=1e-5, atol=1e-7, err_msg=k)
    with torch.no_grad():
        tiny = render_gaussians(activate_params(_tp(params)), cam, bg=bg, max_span=SPAN, tile_capacity=occ - 2)
    assert int(tiny.num_overflow) == 2


def test_attach_compact_keeps_the_canvas_at_full_capacity(scene):
    params, _, cam, occ = scene
    with torch.no_grad():
        b = binning_for(activate_params(_tp(params)), cam, SPAN)
    t = b.tile_count.shape[0]
    assert attach_compact(b, t).compact is None
    assert attach_compact(b, occ).compact.ids.shape == (occ,)


@pytest.mark.parametrize("extra", [3, -2], ids=["padded", "overflow"])
def test_frozen_compact_render_matches_jax(scene, extra):
    params, cam_j, cam, occ = scene
    cap = occ + extra
    bg = np.asarray(BG, np.float32)
    target = np.random.default_rng(2).uniform(0, 1, (3, H, W)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    bj = j_binning_for(j_activate(jp), cam_j, max_span=SPAN, with_static=True, tile_capacity=cap)

    def lj(p):
        out = render_gaussians_pallas(
            j_activate(p), cam_j, bg=jnp.asarray(bg), max_span=SPAN, interpret=True, binning=bj
        )
        loss = jnp.mean(jnp.abs(out.image - target)) + 0.05 * jnp.mean(out.alpha) + 0.02 * jnp.mean(out.depth)
        return loss, out

    (vj, oj), gj = jax.value_and_grad(lj, has_aux=True)(jp)
    q = _tp(params)
    with torch.no_grad():
        bt = binning_for(activate_params(q), cam, SPAN, with_static=True, tile_capacity=cap)
    ot = render_gaussians(activate_params(q), cam, bg=torch.as_tensor(bg), max_span=SPAN, binning=bt)
    vt = _loss_t(ot, torch.as_tensor(target))
    # the split pack takes the opacities from the static rows: no gradient
    gt = torch.autograd.grad(vt, list(q.values()), allow_unused=True)
    gt = [torch.zeros_like(v) if g is None else g for g, v in zip(gt, q.values())]
    np.testing.assert_array_equal(bt.compact.ids.numpy(), np.asarray(bj.compact.ids))
    assert int(ot.num_overflow) == int(oj.num_overflow) == max(0, -extra)
    np.testing.assert_allclose(ot.image.detach().numpy(), np.asarray(oj.image), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ot.alpha.detach().numpy(), np.asarray(oj.alpha), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-4)
    for k, a in zip(params, gt):
        _scaled_close(a.numpy(), np.asarray(gj[k]), err_msg=k)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_compact_kernels_match_plain_on_the_card(cuda, scene):
    params, _, _, occ = scene
    with torch.no_grad():
        rv = activate_params(convert.params_from_numpy(params, cuda))
        proj = project_gaussians(rv, make_synthetic_camera(W, H, device=cuda))
        b = attach_compact(compute_binning(proj, W, H, SPAN), occ + 3)
        bins = pack_with_binning(proj, rv.colors, rv.opacities, b)
    c = b.compact
    tx, ty = -(-W // 16), -(-H // 16)
    ok = tile_blend_fwd_cuda(bins.packed, c.start, c.count, tx, ty, c.ids)
    pp = bins.packed.clone().requires_grad_(True)
    op = tile_blend_plain(pp, c.start, c.count, tx, ty, c.ids)
    torch.testing.assert_close(ok[:, :5], op[:, :5].detach(), rtol=1e-4, atol=1e-5)
    g = torch.randn(ok.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(3))
    g[:, 5:] = 0.0
    dk = tile_blend_bwd_cuda(bins.packed, c.start, c.count, ok, g, tx, ty, c.ids)
    (dp,) = torch.autograd.grad(op, pp, g)
    scale = float(dp.abs().max())
    torch.testing.assert_close(dk / scale, dp / scale, rtol=2e-3, atol=2e-5)


def _assert_ranges_in_order(start, count, ids=None, num_tiles=None):
    """The rows' ranges [start, start + count) are ascending and contiguous
    (K4b walks its rows' ranges one after another and so reads each entry
    once, as the TPU kernel's union walk did, csrc/blend_v3_bwd.cu); with a
    tile map, the used rows list ascending tile ids and the padding rows come
    last with count 0."""
    start, count = start.long(), count.long()
    if ids is None:
        assert int(start[0]) == 0
        np.testing.assert_array_equal(start[1:].numpy(), (start[:-1] + count[:-1]).numpy())
        return
    used = ids < num_tiles
    n = int(used.sum())
    assert bool(used[:n].all()) and not bool(used[n:].any())  # padding last
    assert bool((count[n:] == 0).all())
    assert bool((ids[1:n] > ids[: n - 1]).all())
    np.testing.assert_array_equal(start[1:n].numpy(), (start[: n - 1] + count[: n - 1]).numpy())


@pytest.mark.parametrize("mode", ["full canvas", "padded", "overflow", "frozen padded", "frozen overflow"])
def test_tile_ranges_are_ascending_and_contiguous(scene, mode):
    params, _, cam, occ = scene
    with torch.no_grad():
        rv = activate_params(_tp(params))
        if mode.startswith("frozen"):  # test_frozen_compact_render_matches_jax's setup
            cap = occ + (3 if mode.endswith("padded") else -2)
            c = binning_for(rv, cam, SPAN, with_static=True, tile_capacity=cap).compact
            assert int(c.overflow) == max(0, occ - cap)
            _assert_ranges_in_order(c.start, c.count, c.ids, -(-W // 16) * -(-H // 16))
            return
        b = compute_binning(project_gaussians(rv, cam), W, H, SPAN)
        t = b.tile_count.shape[0]
        _assert_ranges_in_order(b.tile_start, b.tile_count)
        if mode != "full canvas":
            cap = occ + (3 if mode == "padded" else -2)
            c = compact_nonempty_tiles(b.tile_start, b.tile_count, cap)
            assert int(c.overflow) == max(0, occ - cap)
            _assert_ranges_in_order(c.start, c.count, c.ids, t)
