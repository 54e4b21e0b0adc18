"""The tile blend of the PyTorch port against the JAX package on the CPU.

The port's plain blend (what ``tile_blend`` runs on CPU tensors) against
the Pallas blend in interpret mode on the same packed input; the renderer
front end against ``render_gaussians_pallas``; the saturated-window case;
the ``blend_weights`` VJP cases. Tolerances are the JAX suite's own:
forward rows 0-4 rtol 1e-4 / atol 1e-5, gradients scaled by their largest
element rtol 2e-3 / atol 2e-5.

The CUDA kernels K1/K2 run only on the card: the ``cuda`` tests compare
them with the plain version (and K4f/K4b with them, bit for bit) and skip
here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topo4d_tpu.core.gaussian import activate_params as j_activate
from topo4d_tpu.core.gaussian import project_gaussians as j_project
from topo4d_tpu.rasterizer.pallas import render_gaussians_pallas
from topo4d_tpu.rasterizer.pallas_blend import pallas_blend
from topo4d_tpu.rasterizer.reference import blend_weights as j_blend_weights
from topo4d_tpu.rasterizer.reference import render_gaussians as j_oracle
from topo4d_tpu.rasterizer.tiles import compute_binning as j_compute_binning
from topo4d_tpu.rasterizer.tiles import pack_with_binning as j_pack
from topo4d_tpu.testing import make_synthetic_camera as j_cam
from topo4d_tpu.testing import make_synthetic_scene

from topo4d_tpu_torch.core.gaussian import activate_params, project_gaussians
from topo4d_tpu_torch.rasterizer.blend import (
    LAUNCHES,
    blend_weights,
    reset_launches,
    tile_blend,
    tile_blend_bwd_cuda,
    tile_blend_fwd_cuda,
    tile_blend_plain,
    tile_blend_v3_bwd_cuda,
    tile_blend_v3_fwd_cuda,
)
from topo4d_tpu_torch.rasterizer.render import render_gaussians
from topo4d_tpu_torch.rasterizer.tiles import (
    FIELD_ROWS,
    compact_nonempty_tiles,
    compute_binning,
    fold_entry_grads,
    pack_with_binning,
)
from topo4d_tpu_torch.testing import make_synthetic_camera

CPU = "cpu"


def _scaled_close(a, b, err_msg=""):
    scale = max(np.abs(b).max(), 1e-8)
    np.testing.assert_allclose(a / scale, b / scale, rtol=2e-3, atol=2e-5, err_msg=err_msg)


def _jax_packed(n, seed, w, h, span):
    p = make_synthetic_scene(n=n, seed=seed)
    rv = j_activate({k: jnp.asarray(v) for k, v in p.items()})
    proj = j_project(rv, j_cam(w, h))
    bins = j_pack(proj, rv.colors, rv.opacities, j_compute_binning(proj, w, h, span))
    return bins, -(-w // 16), -(-h // 16)


def _torch_args(bins):
    return [torch.as_tensor(np.array(a)) for a in (bins.packed, bins.tile_start, bins.tile_count)]


BLEND_CASES = [(160, 7, 64, 48, 8), (160, 7, 64, 48, 4), (300, 3, 48, 40, 2)]


@pytest.mark.parametrize("n,seed,w,h,span", BLEND_CASES)
def test_plain_blend_forward_matches_pallas(n, seed, w, h, span):
    bins, tx, ty = _jax_packed(n, seed, w, h, span)
    oj = np.asarray(pallas_blend(bins.packed, bins.tile_start, bins.tile_count, tx, ty, 128, True))
    ot = tile_blend_plain(*_torch_args(bins), tx, ty).numpy()
    assert ot.shape == oj.shape
    np.testing.assert_allclose(ot[:, :5], oj[:, :5], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,seed,w,h,span", BLEND_CASES)
def test_plain_blend_gradient_matches_pallas(n, seed, w, h, span):
    bins, tx, ty = _jax_packed(n, seed, w, h, span)
    t = tx * ty
    g = np.random.default_rng(seed).normal(size=(t, 8, 256)).astype(np.float32)
    g[:, 5:] = 0.0  # residual rows carry no gradient
    start, count = bins.tile_start, bins.tile_count
    gj = jax.grad(
        lambda pk: jnp.sum(pallas_blend(pk, start, count, tx, ty, 128, True) * g)
    )(bins.packed)
    pk, ts, tc = _torch_args(bins)
    pk.requires_grad_(True)
    out = tile_blend_plain(pk, ts, tc, tx, ty)
    (out * torch.as_tensor(g)).sum().backward()
    # entries inside a tile range (the rest have no gradient in either)
    gj = np.asarray(gj)[list(FIELD_ROWS)]
    gt = pk.grad.numpy()[list(FIELD_ROWS)]
    e = int(np.asarray(start)[-1] + np.asarray(count)[-1])
    _scaled_close(gt[:, :e], gj[:, :e])


def test_tile_blend_dispatches_cpu_tensors_to_the_plain_version():
    bins, tx, ty = _jax_packed(160, 7, 64, 48, 8)
    args = _torch_args(bins)
    reset_launches()
    out = tile_blend(*args, tx, ty)
    assert LAUNCHES == {
        "tile_blend_fwd": 0, "tile_blend_bwd": 0, "tile_blend_v3_fwd": 0, "tile_blend_v3_bwd": 0,
        "tile_blend_plain": 1,
    }
    torch.testing.assert_close(out, tile_blend_plain(*args, tx, ty))


def test_kernel_wrappers_reject_cpu_tensors():
    """A kernel wrapper never runs the plain version: a CPU tensor is an error."""
    bins, tx, ty = _jax_packed(160, 7, 64, 48, 8)
    args = _torch_args(bins)
    with pytest.raises(ValueError, match="CUDA"):
        tile_blend_fwd_cuda(*args, tx, ty)
    out = torch.zeros((tx * ty, 8, 256))
    with pytest.raises(ValueError, match="CUDA"):
        tile_blend_bwd_cuda(*args, out, out, tx, ty)


# ---------------------------------------------------------------------------
# renderer front end vs render_gaussians_pallas (tests/test_rasterizer_pallas.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scene():
    return make_synthetic_scene(n=160, seed=7)


def test_render_forward_matches_pallas(scene):
    bg = [0.3, 0.2, 0.1]
    rj = render_gaussians_pallas(
        j_activate({k: jnp.asarray(v) for k, v in scene.items()}), j_cam(64, 48),
        bg=jnp.asarray(bg), max_span=8, interpret=True,
    )
    rt = render_gaussians(
        activate_params({k: torch.as_tensor(v) for k, v in scene.items()}),
        make_synthetic_camera(64, 48, device=CPU), bg=torch.tensor(bg), max_span=8,
    )
    np.testing.assert_allclose(rt.image.numpy(), np.asarray(rj.image), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(rt.depth.numpy(), np.asarray(rj.depth), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(rt.alpha.numpy(), np.asarray(rj.alpha), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(rt.radii.numpy(), np.asarray(rj.radii))
    assert int(rt.num_cropped) == int(rj.num_cropped)


def _render_losses(params_np, w, h, span, bg, target):
    def loss_j(params):
        out = render_gaussians_pallas(j_activate(params), j_cam(w, h), bg=jnp.asarray(bg), max_span=span, interpret=True)
        return jnp.mean(jnp.abs(out.image - target)) + 0.05 * jnp.mean(out.alpha) + 0.02 * jnp.mean(out.depth)

    vj, gj = jax.value_and_grad(loss_j)({k: jnp.asarray(v) for k, v in params_np.items()})
    tp = {k: torch.as_tensor(v).requires_grad_(True) for k, v in params_np.items()}
    out = render_gaussians(activate_params(tp), make_synthetic_camera(w, h, device=CPU), bg=torch.tensor(bg), max_span=span)
    t = torch.as_tensor(target)
    vt = (out.image - t).abs().mean() + 0.05 * out.alpha.mean() + 0.02 * out.depth.mean()
    vt.backward()
    return float(vj), gj, float(vt.detach()), {k: v.grad.numpy() for k, v in tp.items()}


def test_render_gradients_match_pallas(scene):
    target = np.random.default_rng(0).uniform(0, 1, (3, 48, 64)).astype(np.float32)
    vj, gj, vt, gt = _render_losses(scene, 64, 48, 8, [0.1, 0.5, 0.2], target)
    np.testing.assert_allclose(vt, vj, rtol=1e-5)
    for k in scene:
        _scaled_close(gt[k], np.asarray(gj[k]), err_msg=k)


def test_gradients_in_saturated_windows_match_oracle():
    """>80 nats of opacity in one tile (tests/test_rasterizer_pallas.py:160):
    the port's backward stays exact where a division-based rebuild of the
    transmittance over whole windows broke down on the TPU."""
    n = 64
    rng = np.random.default_rng(5)
    params = {
        "means3D": rng.normal(0, 0.003, (n, 3)).astype(np.float32),
        "rgb_colors": rng.uniform(0.2, 0.8, (n, 3)).astype(np.float32),
        "unnorm_rotations": np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
        "logit_opacities": np.full((n, 1), 8.0, np.float32),
        "log_scales": np.full((n, 3), np.log(0.05), np.float32),
    }
    target = np.random.default_rng(6).uniform(0, 1, (3, 32, 32)).astype(np.float32)

    def loss_j(p):
        out = j_oracle(j_activate(p), j_cam(32, 32))
        return jnp.mean(jnp.abs(out.image - target)) + 0.05 * jnp.mean(out.alpha)

    g_ref = jax.grad(loss_j)({k: jnp.asarray(v) for k, v in params.items()})
    tp = {k: torch.as_tensor(v).requires_grad_(True) for k, v in params.items()}
    out = render_gaussians(activate_params(tp), make_synthetic_camera(32, 32, device=CPU), max_span=8)
    ((out.image - torch.as_tensor(target)).abs().mean() + 0.05 * out.alpha.mean()).backward()
    for k in params:
        g = tp[k].grad.numpy()
        assert np.isfinite(g).all(), k
        _scaled_close(g, np.asarray(g_ref[k]), err_msg=k)


# ---------------------------------------------------------------------------
# blend_weights' hand-derived VJP (tests/test_blend_weights_vjp.py)
# ---------------------------------------------------------------------------


def _alpha_fixture(seed=0, p=48, m=200):
    rng = np.random.default_rng(seed)
    alpha = np.zeros((p, m), np.float32)
    mask = rng.uniform(size=(p, m)) < 0.3
    alpha[mask] = rng.uniform(0.003, 0.99, mask.sum())
    alpha[:8, :40] = rng.uniform(0.9, 0.99, (8, 40))  # rows that terminate early
    return alpha


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_blend_weights_forward_matches_jax(seed):
    a = _alpha_fixture(seed)
    wj, tj = j_blend_weights(jnp.asarray(a))
    wt, tt = blend_weights(torch.as_tensor(a))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_blend_weights_vjp_matches_jax(seed):
    a = _alpha_fixture(seed)
    rng = np.random.default_rng(11 + seed)
    gw = rng.normal(size=a.shape).astype(np.float32)
    gtf = rng.normal(size=a.shape[:1]).astype(np.float32)

    def f(x):
        w, tf = j_blend_weights(x)
        return jnp.sum(w * gw) + jnp.sum(tf * gtf)

    gj = np.asarray(jax.jit(jax.grad(f))(jnp.asarray(a)))
    x = torch.as_tensor(a).requires_grad_(True)
    w, tf = blend_weights(x)
    ((w * torch.as_tensor(gw)).sum() + (tf * torch.as_tensor(gtf)).sum()).backward()
    scale = np.abs(gj).max()
    np.testing.assert_allclose(x.grad.numpy() / scale, gj / scale, rtol=1e-4, atol=1e-6)


def test_blend_weights_finite_differences():
    a = torch.as_tensor(_alpha_fixture(2, p=8, m=60)).double()
    rng = np.random.default_rng(5)
    gw = torch.as_tensor(rng.normal(size=tuple(a.shape)))
    gtf = torch.as_tensor(rng.normal(size=tuple(a.shape[:1])))

    def f(x):
        w, tf = blend_weights(x)
        return (w * gw).sum() + (tf * gtf).sum()

    x = a.clone().requires_grad_(True)
    f(x).backward()
    for i, j in [(0, 3), (0, 25), (3, 10), (7, 59), (5, 0)]:
        eps = 2e-3
        ap, am = a.clone(), a.clone()
        ap[i, j] += eps
        am[i, j] -= eps
        fd = (float(f(ap)) - float(f(am))) / (2 * eps)
        np.testing.assert_allclose(float(x.grad[i, j]), fd, rtol=5e-2, atol=5e-3)


def test_blend_weights_terminated_rows_zero_grad_past_cut():
    a = np.zeros((1, 16), np.float32)
    a[0, :6] = 0.95  # T after 4 entries = 0.05^4 < 1e-4
    a[0, 10] = 0.5  # past termination
    x = torch.as_tensor(a).requires_grad_(True)
    w, _ = blend_weights(x)
    assert float(w[0, 10]) == 0.0
    (w * torch.arange(16, dtype=torch.float32)).sum().backward()
    assert float(x.grad[0, 10]) == 0.0
    assert abs(float(x.grad[0, 0])) > 0.0


# ---------------------------------------------------------------------------
# on the card: K1/K2 against the plain version (chip_smoke.py runs the same
# comparison at head scale)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,seed,w,h,span", BLEND_CASES)
def test_kernels_match_plain_on_the_card(cuda, n, seed, w, h, span):
    p = make_synthetic_scene(n=n, seed=seed)
    with torch.no_grad():
        rv = activate_params({k: torch.as_tensor(v, device=cuda) for k, v in p.items()})
        proj = project_gaussians(rv, make_synthetic_camera(w, h, device=cuda))
        binning = compute_binning(proj, w, h, span)
        bins = pack_with_binning(proj, rv.colors, rv.opacities, binning)
    tx, ty = -(-w // 16), -(-h // 16)
    packed, start, count = bins.packed, bins.tile_start, bins.tile_count
    ok = tile_blend_fwd_cuda(packed, start, count, tx, ty)
    pp = packed.clone().requires_grad_(True)
    op = tile_blend_plain(pp, start, count, tx, ty)
    torch.testing.assert_close(ok[:, :5], op[:, :5].detach(), rtol=1e-4, atol=1e-5)
    g = torch.randn(ok.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(seed))
    g[:, 5:] = 0.0
    dk = tile_blend_bwd_cuda(packed, start, count, ok, g, tx, ty)
    for tps in (4, 8):  # K4f keeps K1's per-pixel loop, K4b runs K2's per-tile body
        assert torch.equal(tile_blend_v3_fwd_cuda(packed, start, count, tx, ty, None, tps)[:, :6], ok[:, :6])
        assert torch.equal(tile_blend_v3_bwd_cuda(packed, start, count, ok, g, tx, ty, None, tps), dk)
    (dp,) = torch.autograd.grad(op, pp, g)
    e = binning.sorted_gid.shape[0]
    rows = list(FIELD_ROWS)
    gk = fold_entry_grads(dk[rows, :e], binning.entry_valid, binning.inv_positions).cpu().numpy()
    gp = fold_entry_grads(dp[rows, :e], binning.entry_valid, binning.inv_positions).cpu().numpy()
    _scaled_close(gk, gp)


@pytest.mark.cuda
@pytest.mark.parametrize("n,seed,w,h,span", BLEND_CASES)
def test_blend_backward_kernel_is_deterministic_and_compact_equals_full_canvas(cuda, n, seed, w, h, span):
    """K2 sums each entry's gradient within its tile's block in a fixed
    order, with no atomics: two launches on the same input give the same
    bits, and the compact rows (padded past the occupied tiles) give the
    full canvas's dpacked bit for bit."""
    p = make_synthetic_scene(n=n, seed=seed)
    with torch.no_grad():
        rv = activate_params({k: torch.as_tensor(v, device=cuda) for k, v in p.items()})
        proj = project_gaussians(rv, make_synthetic_camera(w, h, device=cuda))
        bins = pack_with_binning(proj, rv.colors, rv.opacities, compute_binning(proj, w, h, span))
    tx, ty = -(-w // 16), -(-h // 16)
    packed, start, count = bins.packed, bins.tile_start, bins.tile_count
    full = tile_blend_fwd_cuda(packed, start, count, tx, ty)
    g = torch.randn(full.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(seed))
    g[:, 5:] = 0.0
    dk = tile_blend_bwd_cuda(packed, start, count, full, g, tx, ty)
    assert torch.equal(tile_blend_bwd_cuda(packed, start, count, full, g, tx, ty), dk)

    occupied = int((count > 0).sum())
    compact = compact_nonempty_tiles(start, count, min(occupied + 3, tx * ty))
    assert int(compact.overflow) == 0
    out_c = tile_blend_fwd_cuda(packed, compact.start, compact.count, tx, ty, compact.ids)
    valid = compact.ids < tx * ty
    g_c = torch.zeros_like(out_c)
    g_c[valid] = g[compact.ids[valid].long()]
    dk_c = tile_blend_bwd_cuda(packed, compact.start, compact.count, out_c, g_c, tx, ty, compact.ids)
    assert torch.equal(dk_c, dk)
