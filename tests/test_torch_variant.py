"""The renderer's ``variant`` argument of the PyTorch port against the JAX
package on the CPU.

``render_gaussians(..., variant=v)`` of the port (the plain blend on CPU
tensors, whatever the variant) against ``render_gaussians_pallas(...,
interpret=True, variant=v)`` on a head fixture (``testing.make_head_fixture``,
anisotropic scales and turned rotations so that every rotation and scale
gradient is a real one): "v3" (the window-span kernels K4) at max_span 8,
several of its 128-entry windows per step, on the full canvas and in compact
mode (a tile capacity below the canvas, JAX's v3 over the compact tile map);
"stream" (K1/K2) and "resident" (K3, at an E_pad within 65,536). Tolerances
are the JAX suite's: forward rtol 1e-4 / atol 1e-5, gradients of every
parameter scaled by their largest element rtol 2e-3 / atol 2e-5. The loss
is a fixed random projection of image, depth and alpha, with no |x| kink.

On the card, K4f against K1 bit for bit and K4b against the plain version
(``cuda`` tests, skipped here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topo4d_tpu.core.gaussian import activate_params as j_activate
from topo4d_tpu.rasterizer.pallas import render_gaussians_pallas
from topo4d_tpu.testing import make_head_fixture as j_head

from topo4d_tpu_torch.convert import camera_from_numpy
from topo4d_tpu_torch.core.gaussian import activate_params, project_gaussians
from topo4d_tpu_torch.rasterizer.blend import (
    LAUNCHES,
    reset_launches,
    tile_blend,
    tile_blend_bwd_cuda,
    tile_blend_fwd_cuda,
    tile_blend_plain,
    tile_blend_v3_bwd_cuda,
    tile_blend_v3_fwd_cuda,
    tiles_per_step,
)
from topo4d_tpu_torch.rasterizer.render import render_gaussians
from topo4d_tpu_torch.rasterizer.tiles import FIELD_ROWS, compact_nonempty_tiles, compute_binning, fold_entry_grads
from topo4d_tpu_torch.rasterizer.tiles import pack_with_binning

CPU = "cpu"
W, H = 96, 64  # 6 x 4 tiles
BG = [0.15, 0.25, 0.35]
PARAM_KEYS = ("means3D", "rgb_colors", "unnorm_rotations", "logit_opacities", "log_scales")


def _scaled_close(a, b, err_msg=""):
    scale = max(np.abs(b).max(), 1e-8)
    np.testing.assert_allclose(a / scale, b / scale, rtol=2e-3, atol=2e-5, err_msg=err_msg)


@pytest.fixture(scope="module")
def head():
    params, cams, _ = j_head(rows=12, cols=12, num_views=1, width=W, height=H)
    n = params["means3D"].shape[0]
    rng = np.random.default_rng(4)
    params = {k: params[k] for k in PARAM_KEYS}
    params["log_scales"] = (params["log_scales"] + rng.uniform(-0.4, 0.4, (n, 3))).astype(np.float32)
    params["unnorm_rotations"] = (params["unnorm_rotations"] + rng.normal(0, 0.3, (n, 4))).astype(np.float32)
    cam = jax.tree_util.tree_map(lambda x: x[0], cams)
    proj = (rng.normal(size=(3, H, W)), rng.normal(size=(1, H, W)), rng.normal(size=(1, H, W)))
    return params, cam, [p.astype(np.float32) for p in proj]


def _jax_render(params, cam, proj, span, variant, capacity):
    def loss(p):
        out = render_gaussians_pallas(
            j_activate(p), cam, bg=jnp.asarray(BG), max_span=span, interpret=True, variant=variant,
            tile_capacity=capacity,
        )
        val = jnp.sum(out.image * proj[0]) + jnp.sum(out.depth * proj[1]) + jnp.sum(out.alpha * proj[2])
        return val, out

    (_, out), grads = jax.value_and_grad(loss, has_aux=True)({k: jnp.asarray(v) for k, v in params.items()})
    return out, {k: np.asarray(v) for k, v in grads.items()}


def _port_render(params, cam, proj, span, variant, capacity):
    tp = {k: torch.as_tensor(v).requires_grad_(True) for k, v in params.items()}
    out = render_gaussians(
        activate_params(tp), camera_from_numpy(cam, CPU), bg=torch.tensor(BG), max_span=span, variant=variant,
        tile_capacity=capacity,
    )
    t = [torch.as_tensor(p) for p in proj]
    (torch.sum(out.image * t[0]) + torch.sum(out.depth * t[1]) + torch.sum(out.alpha * t[2])).backward()
    return out, {k: v.grad.numpy() for k, v in tp.items()}


# (variant, max_span, compact): v3 over several windows, v3 on the compact
# tile map, and the two K1/K2 names
CASES = [("v3", 8, False), ("v3", 4, True), ("stream", 4, False), ("resident", 4, False)]


@pytest.mark.parametrize("variant,span,compact", CASES, ids=["v3-span8", "v3-compact", "stream", "resident"])
def test_render_variant_matches_jax(head, variant, span, compact):
    params, cam, proj = head
    capacity = None
    if compact:
        # a capacity below the canvas that keeps every non-empty tile
        with torch.no_grad():
            tp = activate_params({k: torch.as_tensor(v) for k, v in params.items()})
            b = compute_binning(project_gaussians(tp, camera_from_numpy(cam, CPU)), W, H, span)
        occ, total = int((b.tile_count > 0).sum()), b.tile_count.shape[0]
        capacity = occ + 1
        assert capacity < total, (occ, total)
    if variant == "resident":
        # K3's route in JAX: the entries fit its VMEM budget
        assert params["means3D"].shape[0] * span * span <= 65_536
    oj, gj = _jax_render(params, cam, proj, span, variant, capacity)
    reset_launches()
    ot, gt = _port_render(params, cam, proj, span, variant, capacity)
    assert LAUNCHES["tile_blend_plain"] == 1 and LAUNCHES["tile_blend_v3_fwd"] == LAUNCHES["tile_blend_fwd"] == 0
    np.testing.assert_allclose(ot.image.detach().numpy(), np.asarray(oj.image), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ot.depth.detach().numpy(), np.asarray(oj.depth), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ot.alpha.detach().numpy(), np.asarray(oj.alpha), rtol=1e-4, atol=1e-5)
    assert int(ot.num_overflow) == int(oj.num_overflow) == 0
    for k in PARAM_KEYS:
        assert np.abs(gj[k]).max() > 0, k
        _scaled_close(gt[k], gj[k], err_msg=k)


def test_unknown_variant_raises(head):
    params, cam, _ = head
    rv = activate_params({k: torch.as_tensor(v) for k, v in params.items()})
    with pytest.raises(ValueError, match="variant"):
        render_gaussians(rv, camera_from_numpy(cam, CPU), variant="v2")
    x = torch.zeros((16, 128))
    r = torch.zeros(24, dtype=torch.int32)
    with pytest.raises(ValueError, match="variant"):
        tile_blend(x, r, r, 6, 4, variant="fused")


def test_tiles_per_step_follows_jax():
    """K4's default rows per block: JAX's ``_tiles_per_step``."""
    from topo4d_tpu.rasterizer.pallas_blend import _tiles_per_step

    for rows in (1, 2, 3, 4, 5, 768, 18_432):
        assert tiles_per_step(rows) == _tiles_per_step(rows), rows


def test_v3_wrappers_reject_cpu_tensors():
    """A kernel wrapper never runs the plain version: a CPU tensor is an error."""
    x = torch.zeros((16, 128))
    r = torch.zeros(24, dtype=torch.int32)
    out = torch.zeros((24, 8, 256))
    with pytest.raises(ValueError, match="CUDA"):
        tile_blend_v3_fwd_cuda(x, r, r, 6, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tile_blend_v3_bwd_cuda(x, r, r, out, out, 6, 4)


# ---------------------------------------------------------------------------
# on the card: K4f against K1 bit for bit, K4b against the plain version
# (chip_smoke.py runs the same comparison at head scale and at 4K)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tps", [1, 3, 4, 8])
@pytest.mark.parametrize("span,compact", [(8, False), (4, True)], ids=["span8", "compact"])
def test_v3_kernels_match_k1_and_plain_on_the_card(cuda, head, tps, span, compact):
    params, cam, _ = head
    with torch.no_grad():
        rv = activate_params({k: torch.as_tensor(v, device=cuda) for k, v in params.items()})
        proj = project_gaussians(rv, camera_from_numpy(cam, cuda))
        binning = compute_binning(proj, W, H, span)
        bins = pack_with_binning(proj, rv.colors, rv.opacities, binning)
    tx, ty = -(-W // 16), -(-H // 16)
    packed, start, count, ids = bins.packed, bins.tile_start, bins.tile_count, None
    if compact:
        c = compact_nonempty_tiles(start, count, int((count > 0).sum()) + 3)
        start, count, ids = c.start, c.count, c.ids
    k1 = tile_blend_fwd_cuda(packed, start, count, tx, ty, ids)
    k4 = tile_blend_v3_fwd_cuda(packed, start, count, tx, ty, ids, tps)
    assert torch.equal(k4[:, :6], k1[:, :6])
    g = torch.randn(k1.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(tps))
    g[:, 5:] = 0.0
    pp = packed.clone().requires_grad_(True)
    (dp,) = torch.autograd.grad(tile_blend_plain(pp, start, count, tx, ty, ids), pp, g)
    dk = tile_blend_v3_bwd_cuda(packed, start, count, k4, g, tx, ty, ids, tps)
    assert torch.equal(dk, tile_blend_bwd_cuda(packed, start, count, k1, g, tx, ty, ids))
    e = binning.sorted_gid.shape[0]
    rows = list(FIELD_ROWS)
    gk = fold_entry_grads(dk[rows, :e], binning.entry_valid, binning.inv_positions).cpu().numpy()
    gp = fold_entry_grads(dp[rows, :e], binning.entry_valid, binning.inv_positions).cpu().numpy()
    _scaled_close(gk, gp)
