"""Tile binning and entry packing of the PyTorch port against the JAX
package on the CPU.

``compute_binning``: sorted_tile, tile_start, tile_count, num_cropped
integer-equal; sorted_gid equal on valid entries. ``pack_with_binning``:
packed rows 0-11 equal on valid entries, padding -1; its inverse-gather
backward equals JAX's gradient through the pack.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topo4d_tpu.core.gaussian import activate_params as j_activate
from topo4d_tpu.core.gaussian import project_gaussians as j_project
from topo4d_tpu.rasterizer.tiles import compute_binning as j_compute_binning
from topo4d_tpu.rasterizer.tiles import depth_sorted_order as j_order
from topo4d_tpu.rasterizer.tiles import pack_with_binning as j_pack
from topo4d_tpu.testing import make_synthetic_camera as j_cam
from topo4d_tpu.testing import make_synthetic_scene

from topo4d_tpu_torch.core.gaussian import activate_params, project_gaussians
from topo4d_tpu_torch.rasterizer.tiles import (
    compute_binning,
    depth_sorted_order,
    fold_entry_grads,
    pack_with_binning,
)
from topo4d_tpu_torch.testing import make_synthetic_camera

CPU = "cpu"
# (n, seed, width, height, max_span, scale): scale 0.08 makes Gaussians that
# span more tiles than max_span 2 allows, so the crop path runs
CASES = [
    (160, 7, 64, 48, 8, 0.03),
    (160, 7, 64, 48, 4, 0.03),
    (200, 2, 64, 48, 2, 0.08),
    (120, 5, 50, 37, 4, 0.05),
]


def _both(n, seed, w, h, scale):
    p = make_synthetic_scene(n=n, seed=seed, scale=scale)
    rvj = j_activate({k: jnp.asarray(v) for k, v in p.items()})
    rvt = activate_params({k: torch.as_tensor(v) for k, v in p.items()})
    return p, rvj, rvt, j_project(rvj, j_cam(w, h)), project_gaussians(rvt, make_synthetic_camera(w, h, device=CPU))


@pytest.mark.parametrize("n,seed,w,h,span,scale", CASES)
def test_depth_order_matches_jax(n, seed, w, h, span, scale):
    _, _, _, pj, pt = _both(n, seed, w, h, scale)
    np.testing.assert_array_equal(depth_sorted_order(pt).numpy(), np.asarray(j_order(pj)))


@pytest.mark.parametrize("n,seed,w,h,span,scale", CASES)
def test_compute_binning_matches_jax(n, seed, w, h, span, scale):
    _, _, _, pj, pt = _both(n, seed, w, h, scale)
    bj = j_compute_binning(pj, w, h, span)
    bt = compute_binning(pt, w, h, span)
    np.testing.assert_array_equal(bt.sorted_tile.numpy(), np.asarray(bj.sorted_tile))
    np.testing.assert_array_equal(bt.tile_start.numpy(), np.asarray(bj.tile_start))
    np.testing.assert_array_equal(bt.tile_count.numpy(), np.asarray(bj.tile_count))
    assert int(bt.num_cropped) == int(bj.num_cropped)
    valid = np.asarray(bj.entry_valid)
    np.testing.assert_array_equal(bt.entry_valid.numpy(), valid)
    np.testing.assert_array_equal(bt.sorted_gid.numpy()[valid], np.asarray(bj.sorted_gid)[valid])
    np.testing.assert_array_equal(bt.inv_positions.numpy(), np.asarray(bj.inv_positions))


def test_crop_is_counted():
    _, _, _, pj, pt = _both(200, 2, 64, 48, 0.08)
    assert int(compute_binning(pt, 64, 48, 2).num_cropped) > 0


@pytest.mark.parametrize("n,seed,w,h,span,scale", CASES)
def test_pack_with_binning_matches_jax(n, seed, w, h, span, scale):
    _, rvj, rvt, pj, pt = _both(n, seed, w, h, scale)
    bj = j_compute_binning(pj, w, h, span)
    bt = compute_binning(pt, w, h, span)
    kj = np.asarray(j_pack(pj, rvj.colors, rvj.opacities, bj).packed)
    kt = pack_with_binning(pt, rvt.colors, rvt.opacities, bt).packed.detach().numpy()
    assert kt.shape == kj.shape
    e = bt.sorted_gid.shape[0]
    valid = np.asarray(bj.entry_valid)
    np.testing.assert_allclose(kt[:12, :e][:, valid], kj[:12, :e][:, valid], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(kt[:, e:], -1.0)
    np.testing.assert_array_equal(kt[6, :e], kj[6, :e])  # tile ids, sentinel included


@pytest.mark.parametrize("n,seed,w,h,span,scale", CASES[:2])
def test_pack_gradient_matches_jax(n, seed, w, h, span, scale):
    """The dense inverse-gather backward folds entry gradients to Gaussians
    as JAX's custom VJP does."""
    p, _, _, pj, _ = _both(n, seed, w, h, scale)
    cj = j_cam(w, h)
    bj = j_compute_binning(pj, w, h, span)
    e = n * span * span
    e_pad = e + (-e) % 128 + 128
    wgt = np.random.default_rng(seed).normal(size=(16, e_pad)).astype(np.float32)

    def loss_j(params):
        rv = j_activate(params)
        return jnp.sum(j_pack(j_project(rv, cj), rv.colors, rv.opacities, bj).packed * wgt)

    gj = jax.jit(jax.grad(loss_j))({k: jnp.asarray(v) for k, v in p.items()})
    tp = {k: torch.as_tensor(v).requires_grad_(True) for k, v in p.items()}
    rv = activate_params(tp)
    pr = project_gaussians(rv, make_synthetic_camera(w, h, device=CPU))
    bt = compute_binning(pr.detach(), w, h, span)
    (pack_with_binning(pr, rv.colors, rv.opacities, bt).packed * torch.as_tensor(wgt)).sum().backward()
    for k in p:
        a, b = tp[k].grad.numpy(), np.asarray(gj[k])
        scale_ = max(np.abs(b).max(), 1e-8)
        np.testing.assert_allclose(a / scale_, b / scale_, rtol=1e-4, atol=1e-6, err_msg=k)


def test_fold_entry_grads_is_the_scatter_sum():
    """The dense gather-sum equals index_add over the valid entries."""
    _, _, _, _, pt = _both(160, 7, 64, 48, 0.03)
    bt = compute_binning(pt, 64, 48, 4)
    e = bt.sorted_gid.shape[0]
    g = torch.as_tensor(np.random.default_rng(0).normal(size=(10, e)).astype(np.float32))
    ref = torch.zeros(10, 160).index_add_(1, bt.sorted_gid[bt.entry_valid], g[:, bt.entry_valid])
    torch.testing.assert_close(fold_entry_grads(g, bt.entry_valid, bt.inv_positions), ref, rtol=1e-6, atol=1e-6)
