"""The fused multi-view render of the PyTorch port (``schedule.fuse_views``)
against the JAX package on the CPU. Mirrors ``tests/test_multiview.py``.

``render_gaussians_multiview`` stands every view on one tall canvas and
blends them in one ``tile_blend`` call (on the card: one K1 and one K2
launch); the port runs its plain blend here, JAX its Pallas blend in
interpret mode. Forward and gradients against
``render_gaussians_pallas_multiview`` on the full canvas and in compact
mode, at the blend tolerances of ``tests/test_torch_blend.py`` (forward
rtol 1e-4 / atol 1e-5, depth atol 1e-4; gradients scaled by their largest
element rtol 2e-3 / atol 2e-5). Then the fused render against the port's
own per-view renders, the fused batched step against JAX's, and a short
``Trainer.run`` with ``fuse_views`` against the JAX trainer.

The tall canvas offsets each view's packed y by v * tiles_y * 16 pixels in
float32, which rounds the means (the ulp at 128 px is 2^-17 px): JAX rounds
alike, so the fused renders agree with JAX's at the blend tolerances, and
with the port's per-view renders within 2e-5 absolute on image and alpha.
Measured on this scene: view 0 (offset 0) equal, views 1 and 2 at most
1.3e-6 apart on the image, 1.7e-6 on alpha and 2.3e-6 on depth.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_batched import (
    ALL_LR,
    WEIGHTS,
    _configure,
    _j_lr,
    _j_render,
    _j_state,
    _j_weights,
    _Offset,
    _port_fns,
    _single_device,
    _t_state,
    assert_params_close,
    fx,  # noqa: F401 (the batched tests' fixture, shared)
)

from topo4d_tpu.config import Config as JConfig
from topo4d_tpu.core.gaussian import activate_params as j_activate
from topo4d_tpu.parallel.batched import make_batched_geometry_step as j_batched_step
from topo4d_tpu.pipeline.checkpoint import load_params as j_load_params
from topo4d_tpu.pipeline.data import SyntheticSequence as JSequence
from topo4d_tpu.pipeline.scene import build_scene as j_build_scene
from topo4d_tpu.pipeline.trainer import Trainer as JTrainer
from topo4d_tpu.rasterizer.pallas import render_gaussians_pallas_multiview
from topo4d_tpu.testing import make_camera_ring as j_ring
from topo4d_tpu.testing import make_grid_mesh as j_grid
from topo4d_tpu.testing import make_synthetic_regions as j_regions
from topo4d_tpu.topology.obj_io import MeshObj as JMesh

from topo4d_tpu_torch import convert
from topo4d_tpu_torch.config import Config, check_schedule
from topo4d_tpu_torch.core.gaussian import activate_params
from topo4d_tpu_torch.parallel.batched import make_batched_geometry_step
from topo4d_tpu_torch.pipeline.checkpoint import load_params
from topo4d_tpu_torch.pipeline.data import SyntheticSequence
from topo4d_tpu_torch.pipeline.trainer import Trainer
from topo4d_tpu_torch.rasterizer.blend import LAUNCHES, reset_launches
from topo4d_tpu_torch.rasterizer.render import render_gaussians, render_gaussians_multiview
from topo4d_tpu_torch.testing import make_camera_ring

CPU = "cpu"
V, H, W = 3, 64, 72
SPAN = 2


def _scaled_close(a, b, err_msg=""):
    scale = max(np.abs(b).max(), 1e-8)
    np.testing.assert_allclose(a / scale, b / scale, rtol=2e-3, atol=2e-5, err_msg=err_msg)


@pytest.fixture(scope="module")
def scene():
    """``tests/test_multiview.py``'s scene: 220 Gaussians, a 3-view ring."""
    rng = np.random.default_rng(0)
    n = 220
    params = {
        "means3D": rng.normal(0, 0.3, (n, 3)).astype(np.float32),
        "rgb_colors": rng.uniform(0, 1, (n, 3)).astype(np.float32),
        "unnorm_rotations": rng.normal(0, 1, (n, 4)).astype(np.float32),
        "logit_opacities": rng.normal(1, 1, (n, 1)).astype(np.float32),
        "log_scales": rng.normal(-3.0, 0.3, (n, 3)).astype(np.float32),
    }
    cams_j = j_ring(V, width=W, height=H, distance=1.5)
    gt = np.random.default_rng(1).uniform(0, 1, (V, 3, H, W)).astype(np.float32)
    return params, cams_j, convert.camera_from_numpy(cams_j, CPU), gt


def _j_multi(p, cams, cap=None):
    return render_gaussians_pallas_multiview(
        j_activate(p), cams, max_span=SPAN, chunk=128, interpret=True, tile_capacity=cap
    )


def _t_params(params):
    return {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}


def _t_multi(p, cams, cap=None):
    return render_gaussians_multiview(activate_params(p), cams, max_span=SPAN, tile_capacity=cap)


def _cap():
    return V * (-(-H // 16)) * (-(-W // 16)) - 1  # all non-empty tiles fit


@pytest.fixture(scope="module", params=[False, True], ids=["full", "compact"])
def jax_fused(scene, request):
    """JAX's fused render on the full canvas or in compact mode, and the
    gradient of sum((image - gt)^2), from one interpret-mode run ->
    (capacity, outputs, loss, gradients)."""
    params, cams_j, _, gt = scene
    cap = _cap() if request.param else None
    image, vjp, out = jax.vjp(
        lambda p: (lambda o: (o.image, o))(_j_multi(p, cams_j, cap)),
        {k: jnp.asarray(v) for k, v in params.items()}, has_aux=True,
    )
    (grads,) = vjp(2.0 * (image - gt))
    return cap, out, float(jnp.sum((image - gt) ** 2)), grads


def test_fused_forward_matches_jax(scene, jax_fused):
    params, _, cams_t, _ = scene
    cap, oj, _, _ = jax_fused
    ot = _t_multi(_t_params(params), cams_t, cap)
    assert ot.image.shape == (V, 3, H, W) and ot.radii.shape == (V, len(params["means3D"]))
    np.testing.assert_allclose(ot.image.detach().numpy(), np.asarray(oj.image), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ot.depth.detach().numpy(), np.asarray(oj.depth), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ot.alpha.detach().numpy(), np.asarray(oj.alpha), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(ot.radii.numpy(), np.asarray(oj.radii))
    assert int(ot.num_cropped) == int(oj.num_cropped)
    assert int(ot.num_overflow) == int(oj.num_overflow) == 0


def test_fused_gradients_match_jax(scene, jax_fused):
    params, _, cams_t, gt = scene
    cap, _, lj, gj = jax_fused
    pt = _t_params(params)
    lt = torch.sum((_t_multi(pt, cams_t, cap).image - torch.as_tensor(gt)) ** 2)
    lt.backward()
    np.testing.assert_allclose(lt.item(), lj, rtol=1e-5)
    for k in params:
        _scaled_close(pt[k].grad.numpy(), np.asarray(gj[k]), err_msg=k)


def test_fused_matches_per_view_renders_in_one_blend_call(scene):
    """One plain blend call for all views; each view within the stated
    tolerance of its own render, radii equal, and the gradients of a loss
    over all views alike (scaled as against JAX)."""
    params, _, cams_t, gt = scene
    pf, ps = _t_params(params), _t_params(params)
    reset_launches()
    of = _t_multi(pf, cams_t)
    assert LAUNCHES["tile_blend_plain"] == 1
    rvs = activate_params(ps)
    singles = [render_gaussians(rvs, cams_t[i], max_span=SPAN) for i in range(V)]
    for i, o in enumerate(singles):
        np.testing.assert_allclose(of.image[i].detach().numpy(), o.image.detach().numpy(), rtol=0, atol=2e-5)
        np.testing.assert_allclose(of.alpha[i].detach().numpy(), o.alpha.detach().numpy(), rtol=0, atol=2e-5)
        np.testing.assert_array_equal(of.radii[i].numpy(), o.radii.numpy())
    g = torch.as_tensor(gt)
    torch.sum((of.image - g) ** 2).backward()
    sum(torch.sum((o.image - g[i]) ** 2) for i, o in enumerate(singles)).backward()
    for k in params:
        _scaled_close(pf[k].grad.numpy(), ps[k].grad.numpy(), err_msg=k)


def test_fused_batched_step_matches_jax(fx):  # noqa: F811
    """Two fused batched steps ("init", then "track") against JAX's fused
    step: loss_total, loss_im and the mean PSNR, every parameter and the
    max radii."""
    def j_multi(rv, cams):
        return render_gaussians_pallas_multiview(rv, cams, max_span=4, interpret=True)

    def t_multi(rv, cams):
        return render_gaussians_multiview(rv, cams, max_span=4)

    step_j = j_batched_step(fx.quadruples, fx.umbrellas, _j_render, sequential_views=True,
                            ring_indices=fx.ring_indices, multiview_render_fn=j_multi)
    step_t = make_batched_geometry_step(fx.quadruples_t, fx.umbrellas_t, _port_fns()[0], fx.n,
                                        ring_indices=fx.ring_indices, device=CPU, multiview_render_fn=t_multi)
    sj, pj, st, pt = _j_state(fx), fx.priors_j, _t_state(fx), fx.priors_t
    images_t = torch.as_tensor(fx.images)
    for phase in ("init", "track"):
        reset_launches()
        sj, pj, mj = step_j(sj, jnp.asarray(fx.images), fx.cams_j, pj, (), _j_lr(ALL_LR), _j_weights(), phase)
        st, pt, mt = step_t(st, images_t, fx.cams_t, pt, (), ALL_LR, WEIGHTS, phase)
        assert LAUNCHES["tile_blend_plain"] == 1, phase  # every view in one blend
        assert set(mt) == set(mj), phase
        for k in ("loss_total", "loss_im", "psnr"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-4, err_msg=f"{phase} {k}")
    assert_params_close(st.params, sj.params, ALL_LR, 2)
    np.testing.assert_array_equal(st.max_2d_radius.numpy(), np.asarray(sj.max_2d_radius))


def test_fuse_views_config_round_trips_and_is_accepted():
    cfg = Config()
    cfg.schedule.views_per_step = 0
    cfg.schedule.fuse_views = True
    check_schedule(cfg)
    assert Config.from_json(cfg.to_json()).schedule.fuse_views is True
    jcfg = JConfig()
    jcfg.schedule.fuse_views = True
    assert Config.from_json(jcfg.to_json()).schedule.fuse_views is True


@pytest.fixture(scope="module")
def fused_runs(tmp_path_factory):
    """``tests/test_torch_batched.py``'s short batched run with
    ``fuse_views``: 2 frames, 4 views, 6 + 4 fused batched steps."""
    verts, faces = j_grid(10, 10, extent=0.5)
    mesh = JMesh(vertices=verts, uvs=np.zeros((verts.shape[0], 2), np.float32), faces=faces, uv_faces=faces)
    params, js = j_build_scene(mesh, j_regions(verts.shape[0], faces), JConfig(), num_views=4)
    n = verts.shape[0]
    rng = np.random.default_rng(11)
    params = dict(params, log_scales=(params["log_scales"] + rng.uniform(-0.3, 0.3, (n, 3))).astype(np.float32))
    truth = dict(params, rgb_colors=rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32))

    cfg = _configure(Config(), tmp_path_factory.mktemp("port"))
    cfg.schedule.fuse_views = True
    source = _Offset(SyntheticSequence(params=truth, cameras=make_camera_ring(4, 48, 32, 2.0, device=CPU),
                                       num_frames=2))
    port = Trainer(cfg, source, params, convert.statics_from_numpy(js), device=CPU)
    assert port.batched_multi_step is None
    for t in (1, 2):  # the targets, rendered (and cached) before the count starts
        source.frame(t)
    reset_launches()
    port.run(resume=False)
    plain_calls = LAUNCHES["tile_blend_plain"]

    jcfg = _configure(JConfig(), tmp_path_factory.mktemp("jax"))
    jcfg.schedule.fuse_views = True
    jcfg.raster.backend = "pallas"
    jcfg.raster.interpret = True
    jcfg.data.log_views = []
    with pytest.MonkeyPatch.context() as m:
        _single_device(m)
        jt = JTrainer(jcfg, _Offset(JSequence(params=truth, cameras=j_ring(4, 48, 32, 2.0), num_frames=2)),
                      params, js)
        assert jt.batched_multi_step is None
        jt.run(resume=False)
    out = lambda c: os.path.join(c.data.output_dir, c.data.exp, c.data.seq)  # noqa: E731
    return port, out(cfg), jt, out(jcfg), plain_calls


def test_fused_run_matches_jax(fused_runs):
    """Both trainers' fused runs: one blend per batched step and no
    segments (every step bins afresh), params.npz (rtol 1e-5 / atol 1e-6,
    tracked rotations within two packages' Adam steps, as the sequential
    batched run) and every metric row at rtol 1e-4."""
    port, out, jt, jout, plain_calls = fused_runs
    # one blend per batched step (the log view is not in the synthetic rig: no progress render)
    assert port.geo_segments == [] and plain_calls == 6 + 4
    got, want = load_params(os.path.join(out, "params.npz")), j_load_params(os.path.join(jout, "params.npz"))
    assert sorted(got) == sorted(want)
    lrs = port.cfg.lrs
    for k in want:
        if k == "unnorm_rotations":
            np.testing.assert_allclose(got[k][0], want[k][0], rtol=1e-5, atol=1e-6, err_msg=k)
            d = np.abs(got[k][1:] - want[k][1:])
            assert d.max() <= 2 * 4 * max(lrs.track[k], lrs.polish[k]), d.max()
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    rows_t = [r for r in port.metrics_log if not r.get("summary")]
    rows_j = [r for r in jt.metrics_log if not r.get("summary")]
    assert [(r["frame"], r["iter"]) for r in rows_t] == [(r["frame"], r["iter"]) for r in rows_j] == [
        (0, 0), (0, 5), (1, 0), (1, 3)
    ]
    for rt, rj in zip(rows_t, rows_j):
        shared = (set(rt) & set(rj)) - {"frame", "iter"}
        assert {"loss_total", "loss_im", "psnr"} <= shared
        for k in shared:
            np.testing.assert_allclose(rt[k], rj[k], rtol=1e-4, atol=1e-7, err_msg=(rt["frame"], rt["iter"], k))
