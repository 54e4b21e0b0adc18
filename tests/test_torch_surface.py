"""The JAX package's public functions that the port added last, each against
its JAX counterpart on the CPU, as cases of one parametrised test.

Inputs are made from a seed with NumPy and go through both. Tolerances as
the JAX suite's: values rtol 1e-5 / atol 1e-6 in float32, host results
(index tables, binnings, files, NumPy oracles) exactly; gradients rtol 1e-4
/ atol 1e-7 after dividing by their largest magnitude
(tests/test_rasterizer_pallas.py:89-94). Gradients are held for
``gather_neighbors`` and the three flatten losses. ``flatten_loss``'s
gradient goes through (cos + 1) of edges within a few degrees of flat,
down to ~5e-5, which costs digits in float32: JAX's own float32 gradient
moves by 1e-7 of its largest between its eager and jitted runs and lies
1e-4 of its largest from the float64 one. So the port's gradient is held
to JAX's in float64, no further from it than JAX's jitted float32 one.
``build_scene`` without a view count takes ``data.max_cams`` rows of camera
corrections, as JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topo4d_tpu import testing as jt
from topo4d_tpu.config import Config as JConfig
from topo4d_tpu.core import camera as jcam
from topo4d_tpu.core import gaussian as jgauss
from topo4d_tpu.core import quaternion as jquat
from topo4d_tpu.losses import flatten as jflat
from topo4d_tpu.losses import image as jimage
from topo4d_tpu.losses import neighbors as jnb
from topo4d_tpu.opt import constraints as jcons
from topo4d_tpu.pipeline import scene as jscene
from topo4d_tpu.rasterizer import tiles as jtiles
from topo4d_tpu.texture import bake_pallas as jbake
from topo4d_tpu.topology import adjacency as jadj
from topo4d_tpu.topology import obj_io as jobj
from topo4d_tpu.topology import regions as jregions

from topo4d_tpu_torch import testing as pt
from topo4d_tpu_torch.config import Config
from topo4d_tpu_torch.core import camera as pcam
from topo4d_tpu_torch.core import gaussian as pgauss
from topo4d_tpu_torch.core import quaternion as pquat
from topo4d_tpu_torch.losses import flatten as pflat
from topo4d_tpu_torch.losses import image as pimage
from topo4d_tpu_torch.losses import neighbors as pnb
from topo4d_tpu_torch.opt import constraints as pcons
from topo4d_tpu_torch.pipeline import scene as pscene
from topo4d_tpu_torch.rasterizer import tiles as ptiles
from topo4d_tpu_torch.texture import bake_tiled as pbake
from topo4d_tpu_torch.topology import adjacency as padj
from topo4d_tpu_torch.topology import obj_io as pobj
from topo4d_tpu_torch.topology import regions as pregions

CPU = "cpu"


def _close(a, b, err_msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6, err_msg=err_msg)


def _grads_close(a, b, err_msg=""):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.abs(b).max(), 1e-30)
    np.testing.assert_allclose(a / scale, b / scale, rtol=1e-4, atol=1e-7, err_msg=err_msg)


def _as_accurate(port_grad, jax_grad, jax_fn, x, err_msg=""):
    """The port's float32 gradient of ``jax_fn``'s function at ``x`` no
    further (max-norm, relative to its largest) from the float64 gradient
    than JAX's float32 one, within 1e-6."""
    with jax.enable_x64(True):
        g64 = np.asarray(jax.jit(jax.grad(jax_fn))(jnp.asarray(x, jnp.float64)))
    scale = np.abs(g64).max()
    port_err = np.abs(np.asarray(port_grad) - g64).max() / scale
    jax_err = np.abs(np.asarray(jax_grad) - g64).max() / scale
    assert port_err <= jax_err + 1e-6, f"{err_msg}: {port_err} from float64, JAX's float32 {jax_err}"


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), device=CPU, requires_grad=grad)


def _value_and_grad(port_fn, jax_fn, x):
    """Both functions' scalar value and gradient in ``x`` (a NumPy array)."""
    xt = _t(x, grad=True)
    out = port_fn(xt)
    out.backward()
    jv, jg = jax.jit(jax.value_and_grad(jax_fn))(jnp.asarray(x))
    return (out.detach().numpy(), xt.grad.numpy()), (jv, jg)


def _mesh(rows=7, cols=8, seed=0):
    verts, faces = jt.make_grid_mesh(rows, cols, seed=seed)
    rng = np.random.default_rng(seed)
    verts = verts + rng.normal(0, 0.02, verts.shape).astype(np.float32)  # bent: every dihedral angle differs
    return verts.astype(np.float32), faces


# ---------------------------------------------------------------------------
# the cases: each builds its inputs, runs both and compares
# ---------------------------------------------------------------------------


def case_l2_losses():
    rng = np.random.default_rng(1)
    x, y = rng.normal(size=(2, 7, 5, 3)).astype(np.float32)
    w1 = rng.uniform(size=(7, 5, 3)).astype(np.float32)
    w2 = rng.uniform(size=(7, 5)).astype(np.float32)
    _close(pimage.l2_loss(_t(x), _t(y)), jimage.l2_loss(x, y))
    _close(pimage.weighted_l2_loss_v1(_t(x), _t(y), _t(w1)), jimage.weighted_l2_loss_v1(x, y, w1))
    _close(pimage.weighted_l2_loss_v2(_t(x), _t(y), _t(w2)), jimage.weighted_l2_loss_v2(x, y, w2))


def case_flatten_loss():
    verts, faces = _mesh()
    tri = jadj.triangulate_faces(faces)
    jq, pq = jflat.build_dihedral_quadruples(np.asarray(tri)), pflat.build_dihedral_quadruples(np.asarray(tri))
    # at 175 degrees both branches run: 42 of the 113 edges within 5 degrees
    # of flat take the penalty, the others are exempt
    jax_fn = lambda v: jflat.flatten_loss(v, jq, 175.0)  # noqa: E731
    (pv, pg), (jv, jg) = _value_and_grad(lambda v: pflat.flatten_loss(v, pq, 175.0), jax_fn, verts)
    _close(pv, jv)
    _as_accurate(pg, jg, jax_fn, verts, "threshold 175")


def case_soft_flatten_loss():
    verts, faces = _mesh(seed=2)
    jq = jflat.build_dihedral_quadruples(np.asarray(faces))
    pq = pflat.build_dihedral_quadruples(np.asarray(faces))
    cos0 = jax.jit(lambda v: jflat.soft_flatten_loss(v, jq)[1])(verts)
    moved = verts + np.random.default_rng(3).normal(0, 0.01, verts.shape).astype(np.float32)
    for init in (None, np.asarray(cos0)):
        (pv, pg), (jv, jg) = _value_and_grad(
            lambda v: pflat.soft_flatten_loss(v, pq, None if init is None else _t(init))[0],
            lambda v: jflat.soft_flatten_loss(v, jq, None if init is None else jnp.asarray(init))[0],
            moved,
        )
        _close(pv, jv)
        _grads_close(pg, jg)
    loss, cos = pflat.soft_flatten_loss(_t(verts, grad=True), pq)
    assert loss.requires_grad and not cos.requires_grad  # the cosines come back detached
    _close(cos, cos0)


def case_umbrella_flatten_loss():
    verts, faces = _mesh(seed=4)
    n = verts.shape[0]
    ring = padj.find_adjacent_vertices(n, faces)
    region = np.arange(0, n, 3)
    js = jflat.build_umbrella_flatten(ring, n, region=region, ex_mask=[0, 3])
    ps = pflat.build_umbrella_flatten(ring, n, region=region, ex_mask=[0, 3])
    (pv, pg), (jv, jg) = _value_and_grad(
        lambda v: pflat.umbrella_flatten_loss(v, ps), lambda v: jflat.umbrella_flatten_loss(v, js), verts
    )
    _close(pv, jv)
    _grads_close(pg, jg)


def case_gather_neighbors():
    verts, faces = _mesh(seed=5)
    idx = padj.pad_one_ring(padj.find_adjacent_vertices(verts.shape[0], faces))
    inv = padj.inverse_slots(idx)
    np.testing.assert_array_equal(inv, jadj.inverse_slots(idx))
    x = np.random.default_rng(6).normal(size=(verts.shape[0], 3)).astype(np.float32)
    cot = np.random.default_rng(7).normal(size=idx.shape + (3,)).astype(np.float32)
    xt = _t(x, grad=True)
    got = pnb.gather_neighbors(xt, torch.as_tensor(idx, dtype=torch.int64), torch.as_tensor(inv, dtype=torch.int64))
    (got * _t(cot)).sum().backward()
    want, vjp = jax.vjp(lambda v: jnb.gather_neighbors(v, jnp.asarray(idx), jnp.asarray(inv)), jnp.asarray(x))
    _close(got.detach(), want)
    _grads_close(xt.grad, vjp(jnp.asarray(cot))[0])
    # the gather backward is the scatter-add's sum
    xs = _t(x, grad=True)
    (xs[torch.as_tensor(idx, dtype=torch.int64)] * _t(cot)).sum().backward()
    _grads_close(xt.grad, xs.grad)


def case_build_inverse_incidence_split():
    verts, faces = _mesh(seed=8)
    jq = jflat.build_dihedral_quadruples(np.asarray(faces))
    flat = np.concatenate([jq.v0, jq.v1, jq.v2, jq.v3, [verts.shape[0]] * 3])  # with sentinels
    for slots in (0, None):
        for a, b in zip(pnb.build_inverse_incidence_split(flat, verts.shape[0], slots),
                        jnb.build_inverse_incidence_split(flat, verts.shape[0], slots)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def case_quaternions():
    rng = np.random.default_rng(9)
    q1, q2 = rng.normal(size=(2, 40, 4)).astype(np.float32)
    _close(pquat.quat_mult(_t(q1), _t(q2)), jax.jit(jquat.quat_mult)(q1, q2))
    _close(pquat.quat_conjugate(_t(q1)), jax.jit(jquat.quat_conjugate)(q1))
    d = rng.normal(size=(40, 3)).astype(np.float32)
    d[0] = [-2.0, 0.0, 0.0]  # antiparallel to +x: the fallback rotation
    d[1] = [3.0, 0.0, 0.0]
    _close(pquat.normal_to_quat(_t(d)), jax.jit(jquat.normal_to_quat)(d))
    u1 = q1 / np.linalg.norm(q1, axis=-1, keepdims=True)
    u2 = q2 / np.linalg.norm(q2, axis=-1, keepdims=True)
    u2[:3] = u1[:3]  # equal quaternions: angle 0
    np.testing.assert_allclose(pquat.quaternion_similarity(_t(u1), _t(u2)).numpy(),
                               np.asarray(jax.jit(jquat.quaternion_similarity)(u1, u2)), rtol=1e-5, atol=2e-3)


def case_camera_points():
    pts = np.random.default_rng(10).normal(0, 0.4, (50, 3)).astype(np.float32)
    # JAX's side jitted: one compile per function, not one per eager op
    jax_points = jax.jit(lambda c, x: (c.cam_center, jcam.world_to_view(c, x), jcam.project_points(c, x)))
    for pc, jc in ((pt.make_synthetic_camera(64, 48, angle=0.4, device=CPU), jt.make_synthetic_camera(64, 48, angle=0.4)),
                   (pt.make_camera_ring(3, 40, 30, device=CPU), jt.make_camera_ring(3, 40, 30))):
        center, view, (jpix, jz) = jax_points(jc, jnp.asarray(pts))
        _close(pc.cam_center, center)
        _close(pcam.world_to_view(pc, _t(pts)), view)
        pix, z = pcam.project_points(pc, _t(pts))
        np.testing.assert_allclose(pix.numpy(), np.asarray(jpix), rtol=1e-5, atol=1e-4)  # pixels: ~100 in size
        _close(z, jz)


def case_build_cov3d():
    rng = np.random.default_rng(11)
    q = rng.normal(size=(30, 4)).astype(np.float32)
    s = rng.uniform(0.01, 0.2, (30, 3)).astype(np.float32)
    _close(pgauss.build_cov3d(_t(q), _t(s)), jax.jit(jgauss.build_cov3d)(q, s))


def case_face_masks():
    _, faces = _mesh(seed=12)
    faces = np.asarray(faces)
    mask = np.random.default_rng(12).choice(faces.max() + 1, 20, replace=False)
    for p, j in ((padj.faces_fully_inside, jadj.faces_fully_inside), (padj.faces_touching, jadj.faces_touching)):
        got, want = p(faces, mask), j(faces, mask)
        assert got.shape == want.shape and got.size
        np.testing.assert_array_equal(got, want)


def case_write_obj_del_vertex(tmp_path):
    verts, faces = _mesh(seed=13)
    uvs = pt.grid_uvs(7, 8)
    idx = padj.pad_one_ring(padj.find_adjacent_vertices(verts.shape[0], faces))
    dels = list(range(0, 20)) + [40, 41]
    for ring in (None, idx):
        pobj.write_obj_del_vertex(str(tmp_path / "p.obj"), verts, faces, uvs, faces, dels, ring)
        jobj.write_obj_del_vertex(str(tmp_path / "j.obj"), verts, faces, uvs, faces, dels, ring)
        assert (tmp_path / "p.obj").read_text() == (tmp_path / "j.obj").read_text()


def _regions(n, faces):
    return pt.make_synthetic_regions(n, faces), jt.make_synthetic_regions(n, faces)


def case_region_lookup():
    verts, faces = _mesh(seed=14)
    pr, jr = _regions(verts.shape[0], faces)
    got, want = pregions.region_lookup(pr, verts.shape[0]), jregions.region_lookup(jr, verts.shape[0])
    assert list(got) == list(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _params0(n, seed):
    rng = np.random.default_rng(seed)
    return {
        "means3D": rng.normal(size=(n, 3)).astype(np.float32),
        "rgb_colors": rng.uniform(size=(n, 3)).astype(np.float32),
        "logit_opacities": rng.normal(size=(n, 1)).astype(np.float32),
        "log_scales": rng.normal(size=(n, 3)).astype(np.float32),
    }


def case_constant_constraint():
    p0 = _params0(30, 15)
    idx = np.array([3, 7, 7, 29])
    pc = pcons.constant_constraint("log_scales", idx, -2.5, _t(p0["log_scales"]))
    jc = jcons.constant_constraint("log_scales", idx, -2.5, jnp.asarray(p0["log_scales"]))
    np.testing.assert_array_equal(pc.idx, jc.idx)
    _close(pc.value, jc.value)
    got = pcons.apply_constraints({k: _t(v) for k, v in p0.items()}, [pc])
    want = jcons.apply_constraints({k: jnp.asarray(v) for k, v in p0.items()}, [jc])
    for k in p0:
        _close(got[k], want[k], k)


def case_build_constraints_forms():
    verts, faces = _mesh(seed=16)
    n = verts.shape[0]
    pr, jr = _regions(n, faces)
    p0 = _params0(n, 16)
    jp0 = {k: jnp.asarray(v) for k, v in p0.items()}
    ffa_p = pscene.cache_first_frame_attrs(p0, pr)
    ffa_j = jscene.cache_first_frame_attrs(jp0, jr)
    start = _params0(n, 17)
    j_apply = jax.jit(jcons.apply_constraints)
    # "track": the most writes, every phase's constants and the frame-0 attributes
    for merge, dense in ((True, True), (True, False), (False, False)):
        pc = pscene.build_constraints("track", p0, pr, ffa_p, CPU, merge=merge, dense=dense)
        jc = jscene.build_constraints("track", jp0, jr, ffa_j, merge=merge, dense=dense)
        assert [c.param for c in pc] == [c.param for c in jc]
        got = pcons.apply_constraints({k: _t(v) for k, v in start.items()}, pc)
        want = j_apply({k: jnp.asarray(v) for k, v in start.items()}, jc)
        for k in start:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=f"{merge} {dense} {k}")
        if merge and not dense:
            for a, b in zip(pc, jc):
                np.testing.assert_array_equal(a.idx, b.idx)
                np.testing.assert_array_equal(a.value.numpy(), np.asarray(b.value))
    # merge_constraints alone: the last write wins
    cons = [pcons.ScatterConstraint(np.array([1, 2]), np.ones((2, 3), np.float32), "rgb_colors"),
            pcons.ScatterConstraint(np.array([2, 5]), np.zeros((2, 3), np.float32), "rgb_colors")]
    jc = [jcons.ScatterConstraint(c.idx, jnp.asarray(c.value), c.param) for c in cons]
    for a, b in zip(pscene.merge_constraints(cons), jscene.merge_constraints(jc)):
        np.testing.assert_array_equal(a.idx, b.idx)
        np.testing.assert_array_equal(a.value, np.asarray(b.value))


def _projected(n=120, seed=18, w=64, h=48):
    params = jt.make_synthetic_scene(n, seed=seed, spread=0.3, scale=0.06)
    jc, pc = jt.make_synthetic_camera(w, h), pt.make_synthetic_camera(w, h, device=CPU)
    jrv = jax.jit(jgauss.activate_params)({k: jnp.asarray(v) for k, v in params.items()})
    prv = pgauss.activate_params({k: _t(v) for k, v in params.items()})
    return pgauss.project_gaussians(prv, pc), jax.jit(jgauss.project_gaussians)(jrv, jc), prv, jrv


def case_bin_gaussians():
    pp, jp, _, _ = _projected()
    # max_span 2 crops some Gaussians; span 4 runs in bin_gaussians_packed
    got, want = ptiles.bin_gaussians(pp, 64, 48, 2), jtiles.bin_gaussians(jp, 64, 48, 2)
    assert int(want.num_cropped) > 0
    for f in ptiles.TileBins._fields:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def case_bin_gaussians_packed():
    pp, jp, prv, jrv = _projected(seed=19)
    for chunk in (128, 256):
        got = ptiles.bin_gaussians_packed(pp, prv.colors, prv.opacities, 64, 48, 4, chunk)
        want = jtiles.bin_gaussians_packed(jp, jrv.colors, jrv.opacities, 64, 48, 4, chunk)
        a, b = got.packed.numpy(), np.asarray(want.packed)
        assert a.shape == b.shape
        valid = b[6] < 4 * 3  # a real tile id (the canvas has 4 x 3 tiles); padding -1, invalid entries T
        np.testing.assert_array_equal(a[6], b[6])
        _close(a[:, valid], b[:, valid])
        for f in ("tile_start", "tile_count", "num_cropped"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)


def case_bin_triangles_np():
    rng = np.random.default_rng(20)
    verts = np.concatenate([rng.uniform(-10, 110, (60, 2)), rng.uniform(0, 1, (60, 1))], 1).astype(np.float32)
    tris = rng.integers(0, 60, (80, 3)).astype(np.int32)
    colors = rng.uniform(size=(60, 3)).astype(np.float32)
    for args in ((100, 90), (100, 90, 128, 1024, 16)):
        got = pbake.bin_triangles_np(verts, tris, colors, *args)
        want = jbake.bin_triangles_np(verts, tris, colors, *args)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def case_testing_oracles():
    for n, seed in ((64, 0), (300, 3)):
        a, b = pt.make_synthetic_scene(n, seed), jt.make_synthetic_scene(n, seed)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    rng = np.random.default_rng(21)
    m = 30
    args = (rng.uniform(0, 32, (40, 2)), rng.uniform(0, 32, (m, 2)), np.stack([rng.uniform(0.05, 0.3, m),
            rng.uniform(-0.02, 0.02, m), rng.uniform(0.05, 0.3, m)], 1), rng.uniform(size=(m, 3)),
            rng.uniform(1, 3, m), rng.uniform(0.2, 1.0, m), rng.uniform(size=m) > 0.1, np.array([0.1, 0.2, 0.3]))
    rect = tuple(np.asarray(v) for v in (rng.integers(0, 2, m), rng.integers(0, 2, m), np.full(m, 2), np.full(m, 2)))
    for r in (None, rect):
        for a, b in zip(pt.sequential_blend_numpy(*args, rect=r), jt.sequential_blend_numpy(*args, rect=r)):
            np.testing.assert_array_equal(a, b)


def case_build_scene_max_cams():
    verts, faces = jt.make_grid_mesh(5, 5, extent=0.5)
    mesh = pobj.MeshObj(vertices=verts, uvs=np.zeros((verts.shape[0], 2), np.float32), faces=faces, uv_faces=faces)
    jmesh = jobj.MeshObj(vertices=verts, uvs=mesh.uvs, faces=faces, uv_faces=faces)
    pr, jr = _regions(verts.shape[0], faces)
    assert Config().data.max_cams == JConfig().data.max_cams == 24
    cfg, jcfg = Config(), JConfig()
    cfg.data.max_cams = jcfg.data.max_cams = 7
    params, _ = pscene.build_scene(mesh, pr, cfg)
    jparams, _ = jscene.build_scene(jmesh, jr, jcfg)
    for k in jparams:
        _close(params[k], jparams[k], k)
    assert params["cam_m"].shape == params["cam_c"].shape == (7, 3)
    assert Config.from_json(jcfg.to_json()).data.max_cams == 7


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax(name, tmp_path):
    fn = CASES[name]
    if fn.__code__.co_argcount:
        fn(tmp_path)
    else:
        fn()
