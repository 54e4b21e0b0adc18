"""The batched all-views geometry mode and the segmented multi-steps of the
PyTorch port against the JAX package on the CPU.

The JAX side renders with the Pallas kernels in interpret mode; the port
runs its plain blend (``device="cpu"``). Mirrors ``tests/test_geo_rebin.py``
(:140 the batched multi-step equals the step loop, :169 frozen binnings
exact at zero geometry LR, :197 frozen tracks fresh at the reference track
LRs, :227 the parity multi-step with frozen binnings, :270 auto is exact in
parity mode): the port is held against itself where the JAX test does so,
and against JAX once per test. Then the batched step itself, the schedule
contraction and segment boundaries of the trainer (with the steps replaced
by recorders in both packages), and a short batched ``Trainer.run``.

Tolerances (``tests/test_torch_step.py``'s): per-step ``loss_total`` and
PSNR rtol 1e-4; every parameter element within 2 * lr * steps of JAX (an
Adam sign flip at a near-zero gradient moves a leaf by at most that) and
99.9% of them within 1e-6. Port against port: the JAX tests' own bounds.

The fixtures keep every Adam-normalized gradient a real one: anisotropic
scales and turned rotations, a previous pose displaced from the current
one with stretched rest distances (the rigid and iso losses off their
kinks), and targets that carry a constant offset, so no pixel's residual is
exactly zero (JAX's |x| has gradient 1 there, torch's 0).

``tests/test_batched_parity.py:55`` (slow in JAX) stays unmirrored.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topo4d_tpu.config import Config as JConfig
from topo4d_tpu.config import effective_track_rebin_freq as j_effective_rebin
from topo4d_tpu.core.gaussian import activate_params as j_activate
from topo4d_tpu.core.quaternion import quat_normalize as j_qnorm
from topo4d_tpu.losses.flatten import build_dihedral_quadruples as j_quads
from topo4d_tpu.losses.flatten import build_fused_flatten as j_fused
from topo4d_tpu.losses.flatten import build_umbrella_flatten as j_umb
from topo4d_tpu.losses.flatten import dihedral_cos as j_dcos
from topo4d_tpu.losses.temporal import make_temporal_priors as j_temporal
from topo4d_tpu.opt.adam import adam_init as j_adam_init
from topo4d_tpu.opt.step import GeometryPriors as JPriors
from topo4d_tpu.opt.step import TrainState as JState
from topo4d_tpu.opt.step import make_geometry_multi_step as j_multi_step
from topo4d_tpu.parallel.batched import make_batched_geometry_multi_step as j_batched_multi
from topo4d_tpu.parallel.batched import make_batched_geometry_step as j_batched_step
from topo4d_tpu.pipeline.checkpoint import load_params as j_load_params
from topo4d_tpu.pipeline.data import SyntheticSequence as JSequence
from topo4d_tpu.pipeline.scene import build_scene as j_build_scene
from topo4d_tpu.pipeline.trainer import Trainer as JTrainer
from topo4d_tpu.rasterizer.pallas import binning_for as j_binning_for
from topo4d_tpu.rasterizer.pallas import render_gaussians_pallas
from topo4d_tpu.testing import make_camera_ring as j_ring
from topo4d_tpu.testing import make_grid_mesh as j_grid
from topo4d_tpu.testing import make_head_fixture as j_head
from topo4d_tpu.testing import make_synthetic_regions as j_regions
from topo4d_tpu.topology.adjacency import build_one_ring as j_one_ring
from topo4d_tpu.topology.adjacency import triangulate_faces as j_tri
from topo4d_tpu.topology.obj_io import MeshObj as JMesh

from topo4d_tpu_torch import convert
from topo4d_tpu_torch.config import Config, check_schedule, effective_track_rebin_freq
from topo4d_tpu_torch.losses.flatten import DihedralQuadruples, UmbrellaFlatten
from topo4d_tpu_torch.opt.adam import adam_init
from topo4d_tpu_torch.opt.step import HARD_FLATTEN_KEYS, SOFT_FLATTEN_KEYS, UMBRELLA_KEYS, TrainState
from topo4d_tpu_torch.opt.step import make_geometry_multi_step
from topo4d_tpu_torch.parallel.batched import make_batched_geometry_multi_step, make_batched_geometry_step
from topo4d_tpu_torch.pipeline.checkpoint import load_params
from topo4d_tpu_torch.pipeline.data import SyntheticSequence
from topo4d_tpu_torch.pipeline.trainer import Trainer, make_geo_binning_fns, make_render_fn
from topo4d_tpu_torch.testing import make_camera_ring

CPU = "cpu"
V, W, H = 3, 40, 32
TARGET_OFFSET = np.float32(0.05)
REST_STRETCH = 1.1
WEIGHTS = {
    "im": 1.0, "rigid": 3.5, "rot": 20.0, "iso": 20.0,
    "flat": 2e-4, "flat_lip_bottom": 2e-4, "flat_lid_top": 2e-4,
    "flat_lid_bottom": 1e-2, "flat_lip": 1e-4, "flat_mouth": 1e-3,
    "flat_eye": 1e4, "flat_face_bottom": 1e3, "flat_lip_socket": 1e3,
    "scale": 10.0, "scale_max": 10.0,
}
# reference track-phase LRs (train.py:606-616)
TRACK_LR = {
    "means3D": 1.6e-5, "rgb_colors": 0.0, "unnorm_rotations": 1e-3,
    "log_scales": 0.0, "logit_opacities": 0.0, "cam_m": 0.0, "cam_c": 0.0,
}
# colors learn, geometry (and thus the binning permutation) frozen
COLOR_LR = {
    "means3D": 0.0, "rgb_colors": 2.5e-3, "unnorm_rotations": 0.0,
    "log_scales": 0.0, "logit_opacities": 0.0, "cam_m": 0.0, "cam_c": 0.0,
}
ALL_LR = {k: 1e-4 for k in TRACK_LR}


def assert_params_close(pt, pj, lr, steps):
    """Every element within 2 * lr * steps of JAX's, 99.9% within 1e-6."""
    for k, vj in pj.items():
        a, b = pt[k].detach().numpy(), np.asarray(vj)
        d = np.abs(a - b)
        bound = 2 * lr[k] * steps
        assert d.max() <= bound + 1e-6, (k, d.max(), bound)
        assert np.mean(d <= 1e-6) >= 0.999, (k, np.mean(d <= 1e-6), d.max())


def assert_port_close(a, b, rtol=1e-6, atol=1e-7):
    for k in b:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=rtol, atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def fx():
    """The shared inputs of both packages (tests/test_geo_rebin.py:_setup,
    with the kinks stepped around: see the module docstring)."""
    params, cams_j, (verts, faces) = j_head(rows=8, cols=8, num_views=V, width=W, height=H)
    n = verts.shape[0]
    rng = np.random.default_rng(5)
    params["log_scales"] = (params["log_scales"] + rng.uniform(-0.3, 0.3, (n, 3))).astype(np.float32)
    params["unnorm_rotations"] = (params["unnorm_rotations"] + rng.normal(0, 0.2, (n, 4))).astype(np.float32)
    ring = j_one_ring(verts, faces)
    quads = j_quads(np.asarray(j_tri(faces)))
    umb = j_umb(ring.ragged, n)
    quadruples = {k: quads for k in HARD_FLATTEN_KEYS + SOFT_FLATTEN_KEYS}
    umbrellas = {k: umb for k in UMBRELLA_KEYS}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    fused = j_fused(quadruples, HARD_FLATTEN_KEYS, SOFT_FLATTEN_KEYS)
    prev_means = params["means3D"] + rng.normal(0, 2e-3, (n, 3)).astype(np.float32)
    prev_rots = params["unnorm_rotations"] + rng.normal(0, 0.05, (n, 4)).astype(np.float32)
    priors = JPriors(
        neighbor_indices=jnp.asarray(ring.indices.T),
        neighbor_dist=jnp.asarray(ring.dist.T * REST_STRETCH),
        iso_w=jnp.asarray(ring.weight.T),
        rig_w=jnp.asarray(ring.weight.T),
        rot_w=jnp.asarray(ring.weight.T),
        init_scale=jnp.full((n,), 0.05),
        temporal=j_temporal(jnp.asarray(prev_means), j_qnorm(jnp.asarray(prev_rots)), jnp.asarray(ring.indices.T)),
        cos_init=j_dcos(jp["means3D"], fused.quads)[fused.num_hard:],
    )
    # targets: perturbed vertices and colors (a tracked frame), offset
    tgt = dict(jp)
    tgt["means3D"] = jp["means3D"] + jnp.asarray(rng.normal(0, 0.005, (n, 3)).astype(np.float32))
    tgt["rgb_colors"] = jnp.asarray(rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32))
    rvt = j_activate(tgt)
    images = np.stack([
        np.asarray(render_gaussians_pallas(rvt, jax.tree_util.tree_map(lambda x: x[i], cams_j), interpret=True).image)
        for i in range(V)
    ]) + TARGET_OFFSET
    return types.SimpleNamespace(
        params=params, n=n, cams_j=cams_j, images=images, quadruples=quadruples, umbrellas=umbrellas,
        ring_indices=np.asarray(ring.indices), priors_j=priors,
        quadruples_t={k: DihedralQuadruples(*(np.asarray(f) for f in q)) for k, q in quadruples.items()},
        umbrellas_t={k: UmbrellaFlatten(*(np.asarray(f) for f in u)) for k, u in umbrellas.items()},
        cams_t=convert.camera_from_numpy(cams_j, CPU),
        priors_t=convert.priors_from_numpy(priors, CPU),
    )


# ---------------------------------------------------------------------------
# the two packages' steps on the fixture
# ---------------------------------------------------------------------------


def _j_render(rv, cam):
    return render_gaussians_pallas(rv, cam, max_span=4, interpret=True)


def _j_binned(rv, cam, binning):
    return render_gaussians_pallas(rv, cam, max_span=4, interpret=True, binning=binning)


def _j_binnings(p, cams):
    rv = j_activate(p)
    v = jax.tree_util.tree_leaves(cams)[0].shape[0]
    return jax.lax.map(lambda vid: j_binning_for(rv, cams[vid], max_span=4), jnp.arange(v, dtype=jnp.int32))


def _j_state(fx):
    jp = {k: jnp.asarray(v) for k, v in fx.params.items()}
    return JState(params=jp, opt=j_adam_init(jp), max_2d_radius=jnp.zeros(fx.n))


def _j_lr(table):
    return {k: jnp.asarray(v, jnp.float32) for k, v in table.items()}


def _j_weights():
    return {k: jnp.asarray(v, jnp.float32) for k, v in WEIGHTS.items()}


def _j_batched_multi(fx, frozen, lr, steps):
    kw = dict(binned_render_fn=_j_binned, binnings_fn=_j_binnings) if frozen else {}
    multi = j_batched_multi(
        fx.quadruples, fx.umbrellas, _j_render, sequential_views=True, ring_indices=fx.ring_indices, **kw
    )
    st, _, losses = multi(
        _j_state(fx), jnp.asarray(fx.images), fx.cams_j, fx.priors_j, (), _j_lr(lr), _j_weights(), "track", steps
    )
    return np.asarray(losses), st.params


def _port_fns(views_per_step=0):
    cfg = Config()
    cfg.schedule.views_per_step = views_per_step
    cfg.raster.track_rebin_freq = 25
    return make_render_fn(cfg, CPU), *make_geo_binning_fns(cfg, CPU)


def _t_state(fx):
    tp = convert.params_from_numpy(fx.params, CPU)
    return TrainState(params=tp, opt=adam_init(tp), max_2d_radius=torch.zeros(fx.n))


def _t_batched_multi(fx, frozen, lr, steps):
    render, binned, binnings = _port_fns()
    kw = dict(binned_render_fn=binned, binnings_fn=binnings) if frozen else {}
    multi = make_batched_geometry_multi_step(
        fx.quadruples_t, fx.umbrellas_t, render, fx.n, ring_indices=fx.ring_indices, device=CPU, **kw
    )
    st, _, losses = multi(_t_state(fx), torch.as_tensor(fx.images), fx.cams_t, fx.priors_t, (), lr, WEIGHTS,
                          "track", steps)
    assert losses.shape == (steps,)
    return losses.numpy(), st.params


# ---------------------------------------------------------------------------
# tests/test_geo_rebin.py, mirrored
# ---------------------------------------------------------------------------


def test_batched_step_matches_jax(fx):
    """Two batched steps ("init", then "track") of the port against JAX's:
    loss_total and the mean PSNR over the views, and every parameter."""
    step_j = j_batched_step(fx.quadruples, fx.umbrellas, _j_render, sequential_views=True,
                            ring_indices=fx.ring_indices)
    step_t = make_batched_geometry_step(fx.quadruples_t, fx.umbrellas_t, _port_fns()[0], fx.n,
                                        ring_indices=fx.ring_indices, device=CPU)
    sj, pj, st, pt = _j_state(fx), fx.priors_j, _t_state(fx), fx.priors_t
    images_t = torch.as_tensor(fx.images)
    for phase in ("init", "track"):
        sj, pj, mj = step_j(sj, jnp.asarray(fx.images), fx.cams_j, pj, (), _j_lr(ALL_LR), _j_weights(), phase)
        st, pt, mt = step_t(st, images_t, fx.cams_t, pt, (), ALL_LR, WEIGHTS, phase)
        assert set(mt) == set(mj), phase
        for k in ("loss_total", "loss_im", "psnr"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-4, err_msg=f"{phase} {k}")
        np.testing.assert_allclose(pt.cos_init.numpy(), np.asarray(pj.cos_init), rtol=1e-5, atol=1e-6)
    assert_params_close(st.params, sj.params, ALL_LR, 2)
    np.testing.assert_array_equal(st.max_2d_radius.numpy(), np.asarray(sj.max_2d_radius))


def test_batched_multi_step_matches_step_loop(fx):
    """:140: S batched multi-steps equal S batched steps (the port), and
    the port's segment against JAX's."""
    render = _port_fns()[0]
    step = make_batched_geometry_step(fx.quadruples_t, fx.umbrellas_t, render, fx.n,
                                      ring_indices=fx.ring_indices, device=CPU)
    steps = 3
    st, pr = _t_state(fx), fx.priors_t
    images = torch.as_tensor(fx.images)
    for _ in range(steps):
        st, pr, _ = step(st, images, fx.cams_t, pr, (), TRACK_LR, WEIGHTS, "track")
    losses, params = _t_batched_multi(fx, False, TRACK_LR, steps)
    assert_port_close(params, st.params)
    lj, pj = _j_batched_multi(fx, False, TRACK_LR, steps)
    np.testing.assert_allclose(losses, lj, rtol=1e-4)
    assert_params_close(params, pj, TRACK_LR, steps)


def test_batched_frozen_binning_exact_when_geometry_frozen(fx):
    """:169: with the geometry's LRs 0, frozen binnings are exact (the
    port), and the frozen segment against JAX's."""
    la, pa = _t_batched_multi(fx, False, COLOR_LR, 3)
    lb, pb = _t_batched_multi(fx, True, COLOR_LR, 3)
    np.testing.assert_allclose(lb, la, rtol=1e-6)
    assert_port_close(pb, pa)
    lj, pj = _j_batched_multi(fx, True, COLOR_LR, 3)
    np.testing.assert_allclose(lb, lj, rtol=1e-4)
    assert_params_close(pb, pj, COLOR_LR, 3)


def test_batched_frozen_binning_tracks_fresh_at_reference_lrs(fx):
    """:197: at the reference track LRs frozen binnings follow fresh ones
    to rtol 1e-3 (losses) and 5e-5 (means), and the frozen segment against
    JAX's."""
    la, pa = _t_batched_multi(fx, False, TRACK_LR, 4)
    lb, pb = _t_batched_multi(fx, True, TRACK_LR, 4)
    np.testing.assert_allclose(lb, la, rtol=1e-3)
    np.testing.assert_allclose(pb["means3D"].numpy(), pa["means3D"].numpy(), atol=5e-5)
    lj, pj = _j_batched_multi(fx, True, TRACK_LR, 4)
    np.testing.assert_allclose(lb, lj, rtol=1e-4)
    assert_params_close(pb, pj, TRACK_LR, 4)


def test_single_view_multi_step_frozen_binning(fx):
    """:227: the parity multi-step with frozen binnings, exact at zero
    geometry LR and within tolerance at the reference track LRs (the port),
    and the frozen segment against JAX's."""
    render, binned, binnings = _port_fns(views_per_step=1)

    def port(frozen, lr):
        kw = dict(binned_render_fn=binned, binnings_fn=binnings) if frozen else {}
        multi = make_geometry_multi_step(fx.quadruples_t, fx.umbrellas_t, render, fx.n,
                                         ring_indices=fx.ring_indices, device=CPU, **kw)
        st, _, losses = multi(_t_state(fx), torch.as_tensor(fx.images), fx.cams_t, vids, fx.priors_t, (), lr,
                              WEIGHTS, "track")
        assert losses.shape == (len(vids),)
        return losses.numpy(), st.params

    vids = [0, 1, 2, 1, 0]
    la, pa = port(False, COLOR_LR)
    lb, pb = port(True, COLOR_LR)
    np.testing.assert_allclose(lb, la, rtol=1e-6)
    assert_port_close(pb, pa)
    la, pa = port(False, TRACK_LR)
    lb, pb = port(True, TRACK_LR)
    np.testing.assert_allclose(lb, la, rtol=1e-3)
    np.testing.assert_allclose(pb["means3D"].numpy(), pa["means3D"].numpy(), atol=5e-5)

    multi_j = j_multi_step(fx.quadruples, fx.umbrellas, _j_render, ring_indices=fx.ring_indices,
                           binned_render_fn=_j_binned, binnings_fn=_j_binnings)
    sj, _, lj = multi_j(_j_state(fx), jnp.asarray(fx.images), fx.cams_j, jnp.asarray(vids, jnp.int32), fx.priors_j,
                        (), _j_lr(TRACK_LR), _j_weights(), "track")
    np.testing.assert_allclose(lb, np.asarray(lj), rtol=1e-4)
    assert_params_close(pb, sj.params, TRACK_LR, len(vids))


@pytest.mark.parametrize("views_per_step,rebin", [(1, -1), (0, -1), (0, 0), (1, 7), (0, 3)])
def test_track_rebin_auto_follows_jax(views_per_step, rebin):
    """:270: auto is 0 (a fresh binning every render) in parity mode and 25
    in the batched mode; explicit values win; the trainer builds the frozen
    machinery exactly when the resolved value is above 0."""
    cfg, jcfg = Config(), JConfig()
    assert cfg.raster.track_rebin_freq == jcfg.raster.track_rebin_freq == -1
    for c in (cfg, jcfg):
        c.schedule.views_per_step = views_per_step
        c.raster.track_rebin_freq = rebin
    got = effective_track_rebin_freq(cfg)
    assert got == j_effective_rebin(jcfg)
    assert got == {(1, -1): 0, (0, -1): 25}.get((views_per_step, rebin), rebin)
    binned, binnings = make_geo_binning_fns(cfg, CPU)
    assert (binned is None and binnings is None) == (got == 0)


def test_schedule_refuses_what_is_not_ported():
    cfg = Config()
    cfg.schedule.views_per_step = 2
    with pytest.raises(ValueError, match="views_per_step"):
        check_schedule(cfg)
    cfg.schedule.views_per_step = 0
    cfg.schedule.fuse_views = True  # ported: the flag is accepted
    check_schedule(cfg)


# ---------------------------------------------------------------------------
# the trainer's schedule contraction and segments, against the JAX trainer
# ---------------------------------------------------------------------------

NUM_VIEWS = 24  # the reference rig: nb = ceil(1,100 / 24) = 46


@pytest.fixture(scope="module")
def small_scene():
    verts, faces = j_grid(5, 5, extent=0.5)
    uvs = np.zeros((verts.shape[0], 2), np.float32)
    mesh = JMesh(vertices=verts, uvs=uvs, faces=faces, uv_faces=faces)
    params, js = j_build_scene(mesh, j_regions(verts.shape[0], faces), JConfig(), num_views=NUM_VIEWS)
    return params, js


def _single_device(m):
    """A one-device host: the JAX trainer builds no view mesh (which would
    route the batched mode around its multi-step), as on one card."""
    one = jax.devices()[:1]
    m.setattr(jax, "devices", lambda *a, **k: one)


def _recorded_calls(trainer, batched: bool):
    """Replace the trainer's steps by recorders of (kind, steps or view
    ids, constraint phase, lr key); constraints and LRs are passed by name."""
    calls = []
    trainer._constraints = lambda phase: phase
    trainer.lrs_for = lambda key: key

    def multi(state, images, cams, *rest):
        if batched:
            priors, con, lr, _, _, n = rest
            calls.append(("multi", int(n), con, lr))
        else:
            vids, priors, con, lr, _, _ = rest
            calls.append(("multi", [int(v) for v in vids], con, lr))
        return state, priors, None

    def step(state, images, cams, *rest, with_metrics=True):
        if batched:
            priors, con, lr, _, _ = rest
            calls.append(("step", 1, con, lr))
        else:
            vid, priors, con, lr, _, _ = rest
            calls.append(("step", int(vid), con, lr))
        return state, priors, {"loss_total": 0.0, "psnr": 0.0}

    if batched:
        trainer.batched_multi_step = multi if trainer.batched_multi_step is not None else None
        trainer.batched_step = step
    else:
        trainer.multi_step = multi if trainer.multi_step is not None else None
        trainer.step = step
    return calls


# (views_per_step, frame, init_opt_num, opt_num, log_freq, track_rebin_freq,
# use_scan, batched_opt_num)
SCHEDULES = [
    (0, 0, 240, 1100, 500, -1, True, 0),  # chip_smoke.py's frame 0
    (0, 1, 240, 1100, 500, -1, True, 0),  # a full tracked frame: 46 steps, capped at 25
    (0, 0, 7000, 1100, 500, -1, True, 0),  # the reference's init: 292 steps, eye freeze at 0.7
    (0, 1, 240, 1100, 100, 0, True, 0),  # fresh binnings: segments run to the next log
    (0, 1, 240, 1100, 500, 4, False, 7),  # no segments; a fixed step count
    (1, 1, 240, 300, 100, 7, True, 0),  # parity segments capped at 7
    (1, 0, 60, 300, 25, -1, True, 0),  # parity, fresh binnings
]


@pytest.mark.parametrize("vps,t,init,opt,log_freq,rebin,use_scan,bopt", SCHEDULES)
def test_segments_match_jax_trainer(small_scene, vps, t, init, opt, log_freq, rebin, use_scan, bopt):
    """The port's trainer calls its (batched) step and multi-step with the
    same step counts or view ids, constraint phases and LRs, in the same
    order, as JAX's: nb, log_every, the phase fractions and the segment
    boundaries (capped by the resolved track_rebin_freq when binnings are
    frozen) all follow."""
    params, js = small_scene
    cfg, jcfg = Config(), JConfig()
    for c in (cfg, jcfg):
        c.data.use_mask = False
        c.schedule.views_per_step = vps
        c.schedule.init_opt_num = init
        c.schedule.opt_num = opt
        c.schedule.log_freq = log_freq
        c.schedule.use_scan = use_scan
        c.schedule.batched_opt_num = bopt
        c.raster.track_rebin_freq = rebin
    jcfg.raster.backend = "pallas"
    jcfg.raster.interpret = True
    jcfg.data.log_views = []
    size = 16
    images = np.zeros((NUM_VIEWS, 3, size, size), np.float32)
    with pytest.MonkeyPatch.context() as m:
        _single_device(m)
        tj = JTrainer(jcfg, JSequence(params=params, cameras=j_ring(NUM_VIEWS, size, size), num_frames=2), params, js)
    tt = Trainer(cfg, SyntheticSequence(params=params, cameras=make_camera_ring(NUM_VIEWS, size, size, device=CPU)),
                 params, convert.statics_from_numpy(js), device=CPU)
    batched = vps == 0
    calls_j, calls_t = _recorded_calls(tj, batched), _recorded_calls(tt, batched)
    frame = types.SimpleNamespace(images=images, masks=None, view_names=[str(v) for v in range(NUM_VIEWS)])
    if t > 0:  # the track constraints restore the frame-0 snapshot
        from topo4d_tpu.pipeline.scene import cache_first_frame_attrs

        tj.first_frame_attrs = cache_first_frame_attrs(tj.state.params, js.regions)
        tt.first_frame_attrs = tj.first_frame_attrs
    tj.fit_frame_geometry(t, frame)
    tt.fit_frame_geometry(t, frame)
    assert calls_t == calls_j
    assert tt._last_geo_renders == tj._last_geo_renders
    segments = [c for c in calls_t if c[0] == "multi"]
    assert len(tt.geo_segments) == len(segments) and (len(segments) > 0) == use_scan
    if batched:
        nb, log_every, _ = tt.batched_schedule(t, NUM_VIEWS)
        assert sum(c[1] for c in calls_t) == nb == tj._last_geo_renders // NUM_VIEWS
        if use_scan:  # only logged steps run alone
            logged = [i for i, c in zip(np.cumsum([0] + [c[1] for c in calls_t])[:-1], calls_t) if c[0] == "step"]
            assert all(i % log_every == 0 or i == nb - 1 for i in logged)
        if use_scan and effective_track_rebin_freq(cfg) > 0:
            assert max(c[1] for c in segments) <= effective_track_rebin_freq(cfg)


# ---------------------------------------------------------------------------
# a short batched Trainer.run, port against JAX
# ---------------------------------------------------------------------------


class _Offset:
    """A sequence whose targets carry ``TARGET_OFFSET``."""

    def __init__(self, source):
        self.source = source

    def __getattr__(self, name):
        return getattr(self.source, name)

    def frame(self, t, full_res=False):
        f = self.source.frame(t, full_res=full_res)
        return None if f is None else f._replace(images=f.images + TARGET_OFFSET)


def _configure(c, out_dir):
    """2 frames, 4 views, batched: frame 0 runs 6 steps (one 4-step segment
    between its logged first and last), frame 1 runs 4 (a 2-step segment);
    the auto track_rebin_freq (25) freezes binnings in each segment."""
    c.data.output_dir = str(out_dir)
    c.data.use_mask = False
    c.schedule.views_per_step = 0
    c.schedule.frame_num = 2
    c.schedule.init_opt_num = 24
    c.schedule.opt_num = 16
    c.schedule.polish_iters = 2
    c.schedule.log_freq = 500
    c.schedule.ckp_freq = 1
    return c


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    verts, faces = j_grid(10, 10, extent=0.5)
    mesh = JMesh(vertices=verts, uvs=np.zeros((verts.shape[0], 2), np.float32), faces=faces, uv_faces=faces)
    params, js = j_build_scene(mesh, j_regions(verts.shape[0], faces), JConfig(), num_views=4)
    n = verts.shape[0]
    rng = np.random.default_rng(11)
    params = dict(params, log_scales=(params["log_scales"] + rng.uniform(-0.3, 0.3, (n, 3))).astype(np.float32))
    truth = dict(params, rgb_colors=rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32))

    cfg = _configure(Config(), tmp_path_factory.mktemp("port"))
    source = _Offset(SyntheticSequence(params=truth, cameras=make_camera_ring(4, 48, 32, 2.0, device=CPU),
                                       num_frames=2))
    port = Trainer(cfg, source, params, convert.statics_from_numpy(js), device=CPU)
    port.run(resume=False)

    jcfg = _configure(JConfig(), tmp_path_factory.mktemp("jax"))
    jcfg.raster.backend = "pallas"
    jcfg.raster.interpret = True
    jcfg.data.log_views = []
    with pytest.MonkeyPatch.context() as m:
        _single_device(m)
        jt = JTrainer(jcfg, _Offset(JSequence(params=truth, cameras=j_ring(4, 48, 32, 2.0), num_frames=2)),
                      params, js)
        jt.run(resume=False)
    out = lambda c: os.path.join(c.data.output_dir, c.data.exp, c.data.seq)
    return port, out(cfg), jt, out(jcfg)


def test_batched_run_matches_jax(runs):
    """Frame 0's 6 and frame 1's 4 batched steps through both trainers:
    params.npz (tracked rotations within two packages' Adam steps, the rest
    at rtol 1e-5 / atol 1e-6: a batched step sums four views' gradients in
    another order than XLA, a rounding of the input to Adam's normalized
    step), and every metric row on its shared keys at rtol 1e-4."""
    port, out, jt, jout = runs
    assert [s[:1] + (s[2] - s[1],) for s in port.geo_segments] == [(0, 4), (1, 2)]
    got, want = load_params(os.path.join(out, "params.npz")), j_load_params(os.path.join(jout, "params.npz"))
    assert sorted(got) == sorted(want)
    lrs = port.cfg.lrs
    for k in want:
        assert got[k].shape == want[k].shape, k
        if k == "unnorm_rotations":
            np.testing.assert_allclose(got[k][0], want[k][0], rtol=1e-5, atol=1e-6, err_msg=k)
            bound = 2 * 4 * max(lrs.track[k], lrs.polish[k])
            d = np.abs(got[k][1:] - want[k][1:])
            assert d.max() <= bound, (d.max(), bound)
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
    summaries = [r for r in port.metrics_log if r.get("summary")]
    assert [r["frame"] for r in summaries] == [0, 1] and all(r["mpix_per_s"] > 0 for r in summaries)
