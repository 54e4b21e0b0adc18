"""The slice as a whole: the PyTorch port's geometry step, scene and trainer
against the JAX package on the CPU.

The JAX side renders with the Pallas kernels in interpret mode; the port
runs its plain blend (``device="cpu"``). Tolerances: per-step
``loss_total`` rtol 1e-4; every parameter element within 2 * lr * steps of
JAX (an Adam sign flip at a near-zero gradient moves a leaf by at most
that) and 99.9% of them within 1e-6; statics: integer tables equal, float
tables rtol 1e-5.

The fixtures start away from the targets and with anisotropic scales, so
every gradient that Adam normalizes is a real one: at an optimum, or for
the rotation of an isotropic Gaussian, the gradient is rounding noise, and
Adam's first step turns noise of either sign into a full +-lr step. The
targets carry a constant offset (TARGET_OFFSET) so no pixel's residual is
exactly zero: there JAX's |x| has gradient 1 and torch's 0 (see
test_torch_losses.py::test_l1_gradient_at_zero_residual).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topo4d_tpu.config import Config as JConfig
from topo4d_tpu.core.gaussian import activate_params as j_activate
from topo4d_tpu.core.quaternion import quat_normalize as j_qnorm
from topo4d_tpu.losses.flatten import build_dihedral_quadruples as j_quads
from topo4d_tpu.losses.flatten import build_fused_flatten as j_fused
from topo4d_tpu.losses.flatten import build_umbrella_flatten as j_umb
from topo4d_tpu.losses.flatten import dihedral_cos as j_dcos
from topo4d_tpu.losses.temporal import make_temporal_priors as j_temporal
from topo4d_tpu.opt.adam import adam_init as j_adam_init
from topo4d_tpu.opt.constraints import ScatterConstraint as JScatter
from topo4d_tpu.opt.step import GeometryPriors as JPriors
from topo4d_tpu.opt.step import TrainState as JState
from topo4d_tpu.opt.step import make_geometry_step as j_make_step
from topo4d_tpu.pipeline.data import SyntheticSequence as JSequence
from topo4d_tpu.pipeline.scene import build_scene as j_build_scene
from topo4d_tpu.pipeline.scene import cache_first_frame_attrs as j_ffa
from topo4d_tpu.pipeline.trainer import Trainer as JTrainer
from topo4d_tpu.rasterizer.pallas import render_gaussians_pallas
from topo4d_tpu.testing import make_camera_ring as j_ring
from topo4d_tpu.testing import make_grid_mesh as j_grid
from topo4d_tpu.testing import make_synthetic_regions as j_regions
from topo4d_tpu.topology.adjacency import build_one_ring as j_one_ring
from topo4d_tpu.topology.adjacency import triangulate_faces as j_tri
from topo4d_tpu.topology.obj_io import MeshObj as JMesh

from topo4d_tpu_torch import convert
from topo4d_tpu_torch.config import Config
from topo4d_tpu_torch.core.quaternion import quat_normalize
from topo4d_tpu_torch.losses.flatten import build_dihedral_quadruples, build_fused_flatten, build_umbrella_flatten, dihedral_cos
from topo4d_tpu_torch.losses.temporal import make_temporal_priors
from topo4d_tpu_torch.opt.adam import adam_init
from topo4d_tpu_torch.opt.constraints import ScatterConstraint, compile_dense_constraints
from topo4d_tpu_torch.opt.step import HARD_FLATTEN_KEYS, SOFT_FLATTEN_KEYS, GeometryPriors, TrainState, make_geometry_step
from topo4d_tpu_torch.pipeline.data import FrameData, SyntheticSequence
from topo4d_tpu_torch.pipeline.scene import build_scene
from topo4d_tpu_torch.pipeline.trainer import Trainer
from topo4d_tpu_torch.rasterizer.render import render_gaussians
from topo4d_tpu_torch.testing import make_camera_ring, make_synthetic_regions
from topo4d_tpu_torch.topology.adjacency import build_one_ring, triangulate_faces
from topo4d_tpu_torch.topology.obj_io import MeshObj

CPU = "cpu"
TARGET_OFFSET = 0.05
WEIGHTS = {
    "im": 1.0, "rigid": 3.5, "rot": 20.0, "iso": 20.0,
    "flat": 2e-4, "flat_lip_bottom": 2e-4, "flat_lid_top": 2e-4,
    "flat_lid_bottom": 1e-2, "flat_lip": 1e-4, "flat_mouth": 1e-3,
    "flat_eye": 1e4, "flat_face_bottom": 1e3, "flat_lip_socket": 1e3,
    "scale": 10.0, "scale_max": 10.0,
}


def assert_params_close(pt, pj, bound):
    """Every element within ``bound[k]`` (2 lr steps), 99.9% within 1e-6."""
    for k, vj in pj.items():
        a = pt[k].detach().numpy()
        b = np.asarray(vj)
        d = np.abs(a - b)
        assert d.max() <= bound[k] + 1e-6, (k, d.max(), bound[k])
        assert np.mean(d <= 1e-6) >= 0.999, (k, np.mean(d <= 1e-6), d.max())


# ---------------------------------------------------------------------------
# the step (tests/test_opt.py:180-252 fixture)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def step_fixture():
    verts, faces = j_grid(6, 6)
    verts = verts * 0.05
    n = verts.shape[0]
    rng = np.random.default_rng(3)
    params = {
        "means3D": verts,
        "rgb_colors": np.full((n, 3), 0.5, np.float32),
        "unnorm_rotations": rng.normal(size=(n, 4)).astype(np.float32),
        "logit_opacities": np.full((n, 1), 3.0, np.float32),
        "log_scales": np.log(0.02 * rng.uniform(0.7, 1.3, (n, 3))).astype(np.float32),
        "cam_m": np.zeros((2, 3), np.float32),
        "cam_c": np.zeros((2, 3), np.float32),
    }
    target = dict(params, rgb_colors=rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32))
    cams_j = j_ring(2, width=40, height=30, distance=1.0)
    gt = np.asarray(
        render_gaussians_pallas(
            j_activate({k: jnp.asarray(v) for k, v in target.items()}), cams_j[0],
            max_span=4, interpret=True,
        ).image
    ) + TARGET_OFFSET
    return params, verts, faces, cams_j, gt


REST_STRETCH = 1.1


def _previous_pose(params):
    """The previous frame's pose: the start state displaced. With it (and
    rest distances stretched by REST_STRETCH) the rigid and iso losses stay
    off the kink of sqrt(d^2 + 1e-20) at d = 0, where the gradient's
    direction is rounding noise. (A tracked frame's first step after the
    warm start sits on the rigid kink; the rest pose sits on the iso one,
    and Adam's +-lr steps keep rigidly moved neighbours there.)"""
    rng = np.random.default_rng(8)
    means = params["means3D"] + rng.normal(0, 2e-3, params["means3D"].shape).astype(np.float32)
    rots = params["unnorm_rotations"] + rng.normal(0, 0.05, params["unnorm_rotations"].shape).astype(np.float32)
    return means, rots


def _run_jax_steps(params, verts, faces, cams_j, gt, phases):
    n = verts.shape[0]
    prev_means, prev_rots = _previous_pose(params)
    ring = j_one_ring(verts, faces)
    quads = j_quads(np.asarray(j_tri(faces)))
    umb = j_umb(ring.ragged, n)
    quadruples = {k: quads for k in HARD_FLATTEN_KEYS + SOFT_FLATTEN_KEYS}
    umbrellas = {"flat_eye": umb, "flat_lip_socket": umb, "flat_face_bottom": umb}
    fused = j_fused(quadruples, HARD_FLATTEN_KEYS, SOFT_FLATTEN_KEYS)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    priors = JPriors(
        neighbor_indices=jnp.asarray(ring.indices.T),
        neighbor_dist=jnp.asarray(ring.dist.T * REST_STRETCH),
        iso_w=jnp.asarray(ring.weight.T),
        rig_w=jnp.asarray(ring.weight.T),
        rot_w=jnp.asarray(ring.weight.T),
        init_scale=jnp.full((n,), 0.02),
        temporal=j_temporal(jnp.asarray(prev_means), j_qnorm(jnp.asarray(prev_rots)), jnp.asarray(ring.indices.T)),
        cos_init=j_dcos(jp["means3D"], fused.quads)[fused.num_hard:],
    )
    step = j_make_step(
        quadruples, umbrellas,
        lambda rv, cam: render_gaussians_pallas(rv, cam, max_span=4, interpret=True),
        ring_indices=ring.indices,
    )
    state = JState(params=jp, opt=j_adam_init(jp), max_2d_radius=jnp.zeros(n))
    con = [JScatter(param="means3D", idx=np.arange(5, dtype=np.int32), value=jp["means3D"][:5])]
    lr = {k: 1e-4 for k in params}
    weights = {k: jnp.asarray(v, jnp.float32) for k, v in WEIGHTS.items()}
    losses = []
    for phase in phases:
        state, priors, m = step(
            state, jnp.asarray(gt), cams_j, jnp.asarray(0, jnp.int32), priors, con, lr, weights, phase
        )
        losses.append(float(m["loss_total"]))
    return losses, state, ring, quadruples, umbrellas, priors


def _run_torch_steps(params, verts, faces, cams_j, gt, phases):
    n = verts.shape[0]
    prev_means, prev_rots = _previous_pose(params)
    ring = build_one_ring(verts, faces)
    quads = build_dihedral_quadruples(np.asarray(triangulate_faces(faces)))
    umb = build_umbrella_flatten(ring.ragged, n)
    quadruples = {k: quads for k in HARD_FLATTEN_KEYS + SOFT_FLATTEN_KEYS}
    umbrellas = {"flat_eye": umb, "flat_lip_socket": umb, "flat_face_bottom": umb}
    fused = build_fused_flatten(quadruples, HARD_FLATTEN_KEYS, SOFT_FLATTEN_KEYS)
    tp = convert.params_from_numpy(params, CPU)
    nbr = torch.as_tensor(ring.indices.T.copy()).long()
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    priors = GeometryPriors(
        neighbor_indices=nbr,
        neighbor_dist=t(ring.dist.T * REST_STRETCH),
        iso_w=t(ring.weight.T),
        rig_w=t(ring.weight.T),
        rot_w=t(ring.weight.T),
        init_scale=torch.full((n,), 0.02),
        temporal=make_temporal_priors(
            torch.as_tensor(prev_means), quat_normalize(torch.as_tensor(prev_rots)), nbr
        ),
        cos_init=dihedral_cos(tp["means3D"], fused.quads)[fused.num_hard:],
    )
    step = make_geometry_step(
        quadruples, umbrellas, lambda rv, cam: render_gaussians(rv, cam, max_span=4), n,
        ring_indices=ring.indices, device=CPU,
    )
    state = TrainState(params=tp, opt=adam_init(tp), max_2d_radius=torch.zeros(n))
    con = compile_dense_constraints(
        params, [ScatterConstraint(param="means3D", idx=np.arange(5), value=params["means3D"][:5])], CPU
    )
    cams = convert.camera_from_numpy(cams_j, CPU)
    losses = []
    for phase in phases:
        state, priors, m = step(state, torch.as_tensor(gt.copy()), cams, 0, priors, con, {k: 1e-4 for k in params}, WEIGHTS, phase)
        losses.append(float(m["loss_total"]))
    return losses, state, priors


def test_priors_convert_from_jax(step_fixture):
    """The port's priors equal the JAX step's, converted (convert.py)."""
    params, verts, faces, cams_j, gt = step_fixture
    _, _, _, _, _, pj = _run_jax_steps(params, verts, faces, cams_j, gt, ())
    _, _, pt = _run_torch_steps(params, verts, faces, cams_j, gt, ())
    pc = convert.priors_from_numpy(pj, CPU)
    for name in GeometryPriors._fields:
        a, b = getattr(pt, name), getattr(pc, name)
        for x, y in zip(a if name == "temporal" else [a], b if name == "temporal" else [b]):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("phases", [("track",) * 3, ("init",) * 2], ids=["track3", "init2"])
def test_geometry_step_matches_jax(step_fixture, phases):
    params, verts, faces, cams_j, gt = step_fixture
    lj, sj, _, _, _, _ = _run_jax_steps(params, verts, faces, cams_j, gt, phases)
    lt, st, _ = _run_torch_steps(params, verts, faces, cams_j, gt, phases)
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    bound = {k: 2 * 1e-4 * len(phases) for k in params}
    assert_params_close(st.params, sj.params, bound)
    # the pinned vertices stay put
    np.testing.assert_array_equal(st.params["means3D"][:5].numpy(), params["means3D"][:5])


# ---------------------------------------------------------------------------
# scene statics
# ---------------------------------------------------------------------------


def _mesh(rows=6, cols=6, extent=0.3):
    verts, faces = j_grid(rows, cols, extent=extent)
    uvs = np.zeros((verts.shape[0], 2), np.float32)
    return verts, faces, uvs


@pytest.fixture(scope="module")
def scenes():
    verts, faces, uvs = _mesh()
    n = verts.shape[0]
    jcfg = JConfig()
    jp, js = j_build_scene(
        JMesh(vertices=verts, uvs=uvs, faces=faces, uv_faces=faces), j_regions(n, faces), jcfg, num_views=2
    )
    tp, ts = build_scene(
        MeshObj(vertices=verts, uvs=uvs, faces=faces, uv_faces=faces),
        make_synthetic_regions(n, faces), Config(), num_views=2,
    )
    return jp, js, tp, ts


def test_build_scene_statics_match_jax(scenes):
    jp, js, tp, ts = scenes
    np.testing.assert_array_equal(ts.ring.indices, js.ring.indices)
    assert ts.ring.ragged == js.ring.ragged
    np.testing.assert_array_equal(ts.tri_faces, js.tri_faces)
    for k, q in js.quadruples.items():
        for a, b in zip(ts.quadruples[k], q):
            np.testing.assert_array_equal(a, b, err_msg=k)
    for k, u in js.umbrellas.items():
        for a, b in zip(ts.umbrellas[k], u):
            np.testing.assert_array_equal(a, b, err_msg=k)
    for name in ("iso_w", "rig_w", "rot_w", "init_scale"):
        np.testing.assert_allclose(getattr(ts, name), getattr(js, name), rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(ts.ring.dist, js.ring.dist, rtol=1e-5)
    np.testing.assert_allclose(ts.ring.weight, js.ring.weight, rtol=1e-5)


def test_build_scene_params_match_jax(scenes):
    jp, _, tp, _ = scenes
    assert set(tp) == set(jp)
    for k in jp:
        np.testing.assert_allclose(tp[k], np.asarray(jp[k]), rtol=1e-5, atol=1e-6, err_msg=k)


def test_regions_fixture_matches_jax():
    verts, faces, _ = _mesh()
    a = make_synthetic_regions(verts.shape[0], faces)
    b = j_regions(verts.shape[0], faces)
    for part in ("region_masks", "masks", "flat_faces"):
        pa, pb = getattr(a, part), getattr(b, part)
        assert pa.keys() == pb.keys()
        for k in pb:
            np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

INIT_ITERS = 6


def test_trainer_fit_frame_geometry_matches_jax(scenes):
    """Frame 0 ("init") through both trainers on the same 2-view frame.

    A tracked frame is held against JAX at the step level above: its first
    step after the warm start sits on the rigid loss's kink (and, with
    frozen init means, on the iso loss's), where the rotation gradient is
    rounding noise in both packages.
    """
    jp, js, _, _ = scenes
    n = jp["means3D"].shape[0]
    rng = np.random.default_rng(11)
    # anisotropic scales: see the module docstring
    params = dict(jp, log_scales=(jp["log_scales"] + rng.uniform(-0.3, 0.3, (n, 3))).astype(np.float32))
    truth = dict(params, rgb_colors=rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32))

    cams_j = j_ring(2, width=48, height=40, distance=1.5)
    cams_t = make_camera_ring(2, width=48, height=40, distance=1.5, device=CPU)
    seq = SyntheticSequence(params=truth, cameras=cams_t, num_frames=1)
    frame = seq.frame(0)._replace(images=seq.frame(0).images + TARGET_OFFSET)

    jcfg = JConfig()
    jcfg.raster.backend = "pallas"
    jcfg.raster.interpret = True
    jcfg.schedule.use_scan = False
    jcfg.data.use_mask = False
    jcfg.data.log_views = []
    tcfg = Config()
    for c in (jcfg, tcfg):
        c.schedule.init_opt_num = INIT_ITERS
        c.schedule.log_freq = 1

    tj = JTrainer(jcfg, JSequence(params=truth, cameras=cams_j, num_frames=1), params, js)
    tt = Trainer(tcfg, seq, params, convert.statics_from_numpy(js), device=CPU)
    tj.fit_frame_geometry(0, frame)
    tt.fit_frame_geometry(0, frame)

    assert len(tt.metrics_log) == len(tj.metrics_log) == INIT_ITERS
    for rt, rj in zip(tt.metrics_log, tj.metrics_log):
        assert (rt["frame"], rt["iter"]) == (rj["frame"], rj["iter"])
        assert set(rt) == set(rj)
        np.testing.assert_allclose(rt["loss_total"], rj["loss_total"], rtol=1e-4)
        np.testing.assert_allclose(rt["psnr"], rj["psnr"], rtol=1e-4)
    bound = {k: 2 * INIT_ITERS * tcfg.lrs.init[k] for k in params}
    assert_params_close(tt.state.params, tj.state.params, bound)
    # the frame-0 snapshot the track constraints restore
    ffa = j_ffa(tj.state.params, js.regions)
    for k, v in tt.first_frame_attrs.items():
        np.testing.assert_allclose(v, np.asarray(ffa[k]), atol=1e-6, err_msg=k)


def test_synthetic_sequence_targets_match_jax():
    """The port's SyntheticSequence renders the JAX one's targets (its
    renderer vs the JAX tiled renderer, the JAX suite's pixel tolerance)."""
    verts, faces, _ = _mesh()
    n = verts.shape[0]
    rng = np.random.default_rng(2)
    truth = {
        "means3D": verts,
        "rgb_colors": rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32),
        "unnorm_rotations": np.tile(np.array([1.0, 0, 0, 0], np.float32), (n, 1)),
        "logit_opacities": np.full((n, 1), 4.0, np.float32),
        "log_scales": np.full((n, 3), np.log(0.05), np.float32),
    }
    a = SyntheticSequence(params=truth, cameras=make_camera_ring(2, 48, 40, 1.5, device=CPU), num_frames=3).frame(2)
    b = JSequence(params=truth, cameras=j_ring(2, 48, 40, 1.5), num_frames=3).frame(2)
    np.testing.assert_allclose(a.images, b.images, rtol=1e-4, atol=1e-5)
    assert isinstance(a, FrameData) and a.view_names == b.view_names
