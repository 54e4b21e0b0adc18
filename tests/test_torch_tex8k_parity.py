"""The tex8k protocol's dense phase in the PyTorch port against the JAX package
on the CPU, at the protocol's configuration (``scripts/run_tex8k_r05.py``):
the 92x90 head grid with its UV seam, ``texture.density`` 30 on the 18x18
seam patch (356,550 dense Gaussians), ``raster.max_span`` 2, the pallas
backend, dense cameras at ratio 8 (3000x4096). To stay small, each render is a
window of view 0's dense camera: the same intrinsics, cut to 192x192 pixels
around the seam at the patch's edge (a camera whose principal point is moved
by whole tiles, so that the binning's tile grid stays the full view's). The stages,
in the order the dense phase runs them:

(a) the targets: the port's fabricator render (``validate/fabricate.py``
    ``render_frame``) against JAX's (``scripts/fabricate_fast.py``:
    ``render_gaussians_tiled(max_span=4, capacity=512)``), within one uint8
    level on at most 0.1% of the values, as ``test_torch_validate.py``
    holds the fabricator: the dense window, and the whole working view 14
    (375x512), which sees the grid edge-on, where up to 764 entries fall in
    a tile and JAX's renderer blends the first 512. The port's renderer
    blended them all, 156 levels away from JAX's on 0.13% of the values;
(b) the dense Gaussian set: the seam-aware topology (356,550 vertices)
    equal, ``init_dense_params``'s colours (the anchor of the first dense
    step) and the interpolated means within rtol 1e-5 / atol 1e-7, as
    ``test_torch_densify.py`` holds them. JAX's brute-force float32 k-NN
    takes minutes at this size on the CPU; the test gives both packages the
    port's (``test_torch_densify.py`` holds the two k-NNs together);
(c) the first render and loss, with the frozen binning, the split pack's
    static rows and a compact tile list (the trainers' auto capacity equal):
    image rtol 1e-4 / atol 1e-5 as the JAX suite holds its Pallas renderer
    to the oracle, the loss rtol 1e-5, ``num_cropped`` equal;
(d) one dense step from the frame-0 state, whose soft-colour anchor equals
    the colours: every colour within 2 lr of JAX's and 99.9% within 1e-6, as
    ``test_torch_dense_step.py`` holds the step. Here the two parted: JAX's
    |x| has derivative +1 at 0, so its first step moves every colour the
    view does not see by -lr, where ``torch.abs`` gave 0 and left them.

JAX renders with its Pallas kernels in interpret mode; the port runs its
plain versions (``device="cpu"``).
"""

import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

import topo4d_tpu.pipeline.scene as j_scene_mod  # noqa: E402
from topo4d_tpu.config import Config as JConfig  # noqa: E402
from topo4d_tpu.core.camera import Camera as JCamera  # noqa: E402
from topo4d_tpu.core.gaussian import activate_params as j_activate  # noqa: E402
from topo4d_tpu.losses.image import photometric_loss as j_photometric  # noqa: E402
from topo4d_tpu.opt.adam import adam_init as j_adam_init  # noqa: E402
from topo4d_tpu.pipeline.trainer import Trainer as JTrainer  # noqa: E402
from topo4d_tpu.rasterizer.pallas import attach_compact as j_attach_compact  # noqa: E402
from topo4d_tpu.rasterizer.pallas import binning_for as j_binning_for  # noqa: E402
from topo4d_tpu.rasterizer.pallas import render_gaussians_pallas  # noqa: E402
from topo4d_tpu.rasterizer.tiled import render_gaussians_tiled  # noqa: E402
from topo4d_tpu.testing import make_camera_ring as j_ring  # noqa: E402
from topo4d_tpu.texture.dense import TextureState as JTextureState  # noqa: E402
from topo4d_tpu.texture.dense import dense_rendervars as j_dense_rv  # noqa: E402
from topo4d_tpu.texture.dense import make_texture_step as j_make_texture_step  # noqa: E402
from topo4d_tpu.topology.interpolate import interpolate_dense_attribute as j_interp  # noqa: E402
from topo4d_tpu.topology.obj_io import load_obj as j_load_obj  # noqa: E402
from topo4d_tpu.topology.regions import load_facial_regions as j_load_regions  # noqa: E402

from topo4d_tpu_torch import convert  # noqa: E402
from topo4d_tpu_torch.config import Config  # noqa: E402
from topo4d_tpu_torch.losses.image import photometric_loss  # noqa: E402
from topo4d_tpu_torch.opt.adam import adam_init  # noqa: E402
from topo4d_tpu_torch.pipeline.scene import build_dense_pre_constraints, build_scene, init_dense_params  # noqa: E402
from topo4d_tpu_torch.pipeline.trainer import Trainer  # noqa: E402
from topo4d_tpu_torch.rasterizer.render import attach_compact, binning_for, render_gaussians  # noqa: E402
from topo4d_tpu_torch.testing import grid_scene  # noqa: E402
from topo4d_tpu_torch.testing import make_camera_ring as t_ring  # noqa: E402
from topo4d_tpu_torch.validate.fabricate import render_frame  # noqa: E402

# after this package's imports: the script puts a fixed checkout path first on sys.path
from fabricate_dataset import fabricate as j_fabricate  # noqa: E402
from topo4d_tpu_torch.texture.dense import TextureState, dense_rendervars, make_texture_step  # noqa: E402
from topo4d_tpu_torch.topology.interpolate import interpolate_dense_attribute  # noqa: E402
from topo4d_tpu_torch.topology.knn import mean_knn_sq_dist  # noqa: E402
from topo4d_tpu_torch.topology.obj_io import load_obj  # noqa: E402
from topo4d_tpu_torch.topology.regions import load_facial_regions  # noqa: E402

CPU = "cpu"
ROWS, COLS, VIEWS, WORK_W, WORK_H, RATIO = 92, 90, 24, 375, 512, 8
DENSITY, SPAN, WINDOW = 30, 2, 192
DENSE_LR = {
    "dense_rgb_colors": 2.5e-3, "dense_unnorm_rotations": 1e-3,
    "dense_logit_opacities": 0.0, "dense_log_scales": 0.0,
}
WEIGHTS = {"im": 1.0, "soft_color": 0.02}


def _cfg(c):
    c.texture.gen_tex, c.texture.density, c.texture.tex_res = True, DENSITY, 8192
    c.raster.max_span = SPAN
    return c


@pytest.fixture(scope="module")
def seam(tmp_path_factory):
    """Both packages' scene of the protocol's tree (JAX's fabricator writes
    the mesh and the regions), the known scene's colours as the fitted
    geometry's, and view 0's dense camera cut to the window."""
    root = str(tmp_path_factory.mktemp("tex8k") / "fab")
    j_fabricate(root, 1, 1, ROWS, COLS, 16, 16, 1, 0.004, dense_tree=False, uv_seam=True)
    obj = os.path.join(root, "seq01", "face_v5.obj")
    regions_pkl = os.path.join(root, "assets", "facial_regions.pkl")
    jmesh, jregions = j_load_obj(obj), j_load_regions(regions_pkl)
    jp, js = j_scene_mod.build_scene(jmesh, jregions, _cfg(JConfig()), num_views=VIEWS)
    tp, ts = build_scene(load_obj(obj), load_facial_regions(regions_pkl), _cfg(Config()), num_views=VIEWS)
    # the geometry fit's target colours, with build_scene's pre-loop writes
    known = grid_scene(jmesh.vertices, ROWS, COLS)
    for p, regions in ((jp, jregions), (tp, ts.regions)):
        p["rgb_colors"] = known["rgb_colors"].copy()
        p["rgb_colors"][regions.masks["dynamic_mouth_masks"]] = 0.0
        p["rgb_colors"][regions.masks["dynamic_eye_masks"]] = 1.0

    cams = j_ring(VIEWS, width=WORK_W, height=WORK_H, distance=2.0)
    full = JCamera(
        w2c=cams.w2c, fx=np.asarray(cams.fx) * RATIO, fy=np.asarray(cams.fy) * RATIO,
        cx=np.asarray(cams.cx) * RATIO, cy=np.asarray(cams.cy) * RATIO,
        width=WORK_W * RATIO, height=WORK_H * RATIO,
    )[0]
    # the window: whole tiles around the seam column's end at the patch's edge
    dense_v = js.dense.topo.dense_vertices
    seam_pt = dense_v[np.argmin(np.abs(dense_v[:, 0]) + np.abs(dense_v[:, 1] - dense_v[:, 1].max()))]
    cam_pt = np.asarray(full.w2c)[:3, :3] @ seam_pt + np.asarray(full.w2c)[:3, 3]
    u = float(full.fx) * cam_pt[0] / cam_pt[2] + float(full.cx)
    v = float(full.fy) * cam_pt[1] / cam_pt[2] + float(full.cy)
    ox, oy = (int(u) - WINDOW // 2) // 16 * 16, (int(v) - WINDOW // 2) // 16 * 16
    win = JCamera(
        w2c=np.asarray(full.w2c), fx=np.float32(full.fx), fy=np.float32(full.fy),
        cx=np.float32(float(full.cx) - ox), cy=np.float32(float(full.cy) - oy), width=WINDOW, height=WINDOW,
    )
    return {"jp": jp, "js": js, "tp": tp, "ts": ts, "known": known, "win": win}


@pytest.fixture(scope="module")
def dense(seam):
    """Each package's ``init_dense_params`` and interpolated dense means."""
    js, ts = seam["js"], seam["ts"]
    mp = pytest.MonkeyPatch()
    mp.setattr(j_scene_mod, "mean_knn_sq_dist", mean_knn_sq_dist)
    try:
        jd = j_scene_mod.init_dense_params(seam["jp"], js, VIEWS)
    finally:
        mp.undo()
    td = init_dense_params(seam["tp"], ts, VIEWS)
    jt, tt = js.dense.topo, ts.dense.topo
    jm = np.asarray(j_interp(jnp.asarray(seam["jp"]["means3D"]), jnp.asarray(jt.quad_faces),
                             jnp.asarray(jt.father_face), jnp.asarray(jt.weights)))
    tm = interpolate_dense_attribute(torch.as_tensor(seam["tp"]["means3D"]), torch.as_tensor(tt.quad_faces),
                                     torch.as_tensor(tt.father_face), torch.as_tensor(tt.weights)).numpy()
    return jd, td, jm, tm


def _j_fabricated(known, cams):
    """JAX's fabricator render of each view of ``cams`` -> (V, H, W, 3) uint8."""
    jrv = j_activate({k: jnp.asarray(v) for k, v in known.items()})
    jcams = jax.tree_util.tree_map(jnp.asarray, cams)
    return np.stack([
        np.asarray(jnp.clip(
            render_gaussians_tiled(jrv, jcams[v], max_span=4, capacity=512).image.transpose(1, 2, 0) * 255.0, 0, 255
        ).astype(jnp.uint8))
        for v in range(int(np.asarray(cams.fx).shape[0]))
    ])


def _assert_fabricated_close(j8, t8):
    d = np.abs(j8.astype(np.int16) - t8.astype(np.int16))
    assert d.max() <= 1 and np.mean(d > 0) <= 1e-3, (int(d.max()), float(np.mean(d > 0)))


@pytest.fixture(scope="module")
def target(seam):
    """(a) The dense target of the window: JAX's fabricator render and the
    port's, uint8 as the fabricators write them."""
    win = jax.tree_util.tree_map(lambda x: np.asarray(x)[None], seam["win"])
    j8 = _j_fabricated(seam["known"], win)[0]
    t8 = render_frame(seam["known"], seam["known"]["means3D"], convert.camera_from_numpy(win, CPU))[0]
    return j8, t8


def test_dense_target_matches_jax_fabricator(target):
    j8, t8 = target
    _assert_fabricated_close(j8, t8)
    assert np.mean(j8 > 0) > 0.5  # the window lies on the head


def test_edge_on_working_views_match_jax_fabricator(seam):
    views = [14]
    ring = j_ring(VIEWS, width=WORK_W, height=WORK_H, distance=2.0)
    j8 = _j_fabricated(seam["known"], jax.tree_util.tree_map(lambda x: np.asarray(x)[views], ring))
    t8 = render_frame(seam["known"], seam["known"]["means3D"], t_ring(VIEWS, width=WORK_W, height=WORK_H,
                                                                      distance=2.0, device=CPU)[views])
    _assert_fabricated_close(j8, t8)


def test_dense_set_matches_jax(seam, dense):
    jd, td, jm, tm = dense
    jt, tt = seam["js"].dense.topo, seam["ts"].dense.topo
    assert jt.dense_vertices.shape[0] == tt.dense_vertices.shape[0] == 356_550
    for name in ("quad_faces", "father_face"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name), err_msg=name)
    for name in ("dense_vertices", "weights"):
        np.testing.assert_allclose(getattr(tt, name), getattr(jt, name), rtol=1e-6, atol=1e-6, err_msg=name)
    assert tt.num_seam_edge_instances == jt.num_seam_edge_instances > 0
    for k in jd:
        np.testing.assert_allclose(td[k], np.asarray(jd[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(tm, jm, rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def states(seam, dense, target):
    """Both packages' frozen binnings of the window, from JAX's dense set."""
    jd, _, jm, _ = dense
    gt = target[0].astype(np.float32).transpose(2, 0, 1) / 255.0
    jparams = {k: jnp.asarray(v) for k, v in jd.items()}
    jcam = jax.tree_util.tree_map(jnp.asarray, seam["win"])
    tparams = convert.params_from_numpy(jd, CPU)
    tcam = convert.camera_from_numpy(seam["win"], CPU)
    jb = j_binning_for(j_dense_rv(jparams, jnp.asarray(jm)), jcam, max_span=SPAN, with_static=True)
    tb = binning_for(dense_rendervars(tparams, torch.as_tensor(jm)), tcam, max_span=SPAN, with_static=True)
    occ = int(torch.sum(tb.tile_count > 0))
    assert occ == int(jnp.sum(jb.tile_count > 0))
    t = int(tb.tile_count.shape[0])
    # the auto capacity of the trainers; on the window it is the canvas (the
    # head covers every tile but two), so the compact list is sized to the
    # occupancy, as a manual ``texture.tile_capacity`` sizes it
    auto = Trainer._auto_tile_capacity(SimpleNamespace(_auto_tile_cap=0), occ, t)
    assert auto == JTrainer._auto_tile_capacity(SimpleNamespace(), occ, t)
    assert occ < t
    return gt, jparams, jcam, j_attach_compact(jb, occ), tparams, tcam, attach_compact(tb, occ), occ


def test_first_render_matches_jax(dense, states):
    gt, jparams, jcam, jb, tparams, tcam, tb, _ = states
    jm = jnp.asarray(dense[2])
    jo = render_gaussians_pallas(j_dense_rv(jparams, jm), jcam, max_span=SPAN, interpret=True, binning=jb)
    with torch.no_grad():
        to = render_gaussians(dense_rendervars(tparams, torch.as_tensor(dense[2])), tcam, max_span=SPAN, binning=tb)
    assert int(to.num_cropped) == int(jo.num_cropped)
    assert int(to.num_overflow) == 0
    np.testing.assert_allclose(to.image.numpy(), np.asarray(jo.image), rtol=1e-4, atol=1e-5)
    want = float(j_photometric(jo.image, jnp.asarray(gt)))
    assert float(photometric_loss(to.image, torch.as_tensor(gt))) == pytest.approx(want, rel=1e-5)


def test_first_dense_step_matches_jax(seam, dense, states):
    """One step from the frame-0 state: the anchor is the colours themselves,
    so every soft-colour residual is exactly 0 (the stage where the port
    parted from JAX)."""
    gt, jparams, jcam, jb, tparams, tcam, tb, _ = states
    jd, _, jm, _ = dense
    jcams = jax.tree_util.tree_map(lambda x: jnp.asarray(x)[None], seam["win"])
    tcams = convert.camera_from_numpy(jcams, CPU)
    jpre = j_scene_mod.build_dense_pre_constraints(jparams, seam["js"].regions)
    tpre = build_dense_pre_constraints(jd, seam["ts"].regions, CPU)
    jstep = j_make_texture_step(
        lambda rv, cam, b: render_gaussians_pallas(rv, cam, max_span=SPAN, interpret=True, binning=b)
    )
    js1, jm1 = jstep(
        JTextureState(params=jparams, opt=j_adam_init(jparams)), jnp.asarray(jm), jnp.asarray(gt), jcams,
        jnp.asarray(0, jnp.int32), jparams["dense_rgb_colors"], jpre,
        {k: jnp.asarray(v, jnp.float32) for k, v in DENSE_LR.items()},
        {k: jnp.asarray(v, jnp.float32) for k, v in WEIGHTS.items()}, jb,
    )
    tstep = make_texture_step(lambda rv, cam, b: render_gaussians(rv, cam, max_span=SPAN, binning=b))
    ts1, tm1 = tstep(
        TextureState(params=tparams, opt=adam_init(tparams)), torch.as_tensor(jm), torch.as_tensor(gt), tcams, 0,
        tparams["dense_rgb_colors"], tpre, DENSE_LR, WEIGHTS, tb,
    )
    assert float(tm1["loss_total"]) == pytest.approx(float(jm1["loss_total"]), rel=1e-5)
    lr = DENSE_LR["dense_rgb_colors"]
    got = ts1.params["dense_rgb_colors"].numpy()
    want = np.asarray(js1.params["dense_rgb_colors"])
    d = np.abs(got - want)
    # most colours lie outside the window: JAX's step moves each of them by
    # -lr through the anchor's derivative at 0 alone
    moved = np.abs(want - jd["dense_rgb_colors"]) > 0.5 * lr
    assert np.mean(moved) > 0.9, np.mean(moved)
    assert d.max() <= 2 * lr + 1e-6, d.max()
    assert np.mean(d <= 1e-6) >= 0.999, (np.mean(d <= 1e-6), d.max())
