"""The face3d library surface of the port (``topo4d_tpu_torch.mesh3d``:
transform, light, bfm, io, vis) against the JAX package's
(``topo4d_tpu.mesh3d``) on the CPU, on the same NumPy inputs.

- transform and light: every function at rtol 1e-5 / atol 1e-6, with the
  least squares on a rank-deficient system (coplanar points: the
  minimum-norm solution) and ``matrix2angle`` at the gimbal case;
  get_normal's sums come from ``index_add_``;
- bfm: ``load_bfm`` on a ``.mat`` written in BFM's layout, arrays equal;
  generation at rtol 1e-5 (atol 1e-6 of the largest magnitude, for
  coordinates near 0); ``fit_points`` / ``fit`` within 1e-4 relative on s,
  R, t and the reprojection, and the recovery checks of
  ``tests/test_mesh3d.py:228-266`` on the port; ``make_synthetic_bfm`` at a
  small size;
- io: the OBJ, MTL and ASC files byte for byte (the absolute paths in them
  aside), the texture PNG by its decoded pixels; vis: the same drawing,
  skipped without matplotlib;
- without a card, a function handed only host values raises at the
  default ``device="cuda"``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import torch
from PIL import Image

from topo4d_tpu.mesh3d import bfm as j_bfm
from topo4d_tpu.mesh3d import io as j_io
from topo4d_tpu.mesh3d import light as j_light
from topo4d_tpu.mesh3d import transform as j_transform

from topo4d_tpu_torch import convert
from topo4d_tpu_torch.mesh3d import bfm, io, light, transform
from topo4d_tpu_torch.testing import make_synthetic_bfm

CPU = "cpu"
# JAX's fits compiled as one program each: op by op JAX compiles every
# primitive on its first call, which takes longer here
j_fit_points = jax.jit(j_bfm.fit_points, static_argnames=("n_sp", "n_ep", "max_iter"))
j_fit = jax.jit(j_bfm.fit, static_argnames=("max_iter",))


def t(a):
    return torch.as_tensor(np.array(a))


def close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def close_scaled(got, want, rtol=1e-5):
    """rtol, and atol of ``1e-6`` times the largest magnitude."""
    want = np.asarray(want)
    close(got, want, rtol=rtol, atol=1e-6 * np.abs(want).max())


# ---------------------------------------------------------------------------
# transform
# ---------------------------------------------------------------------------

ANGLES = [[12.0, -25.0, 33.0], [0.0, 0.0, 90.0], [-170.0, 89.0, 5.5], [0.0, 90.0, 0.0]]


@pytest.mark.parametrize("angles", ANGLES)
def test_rotations_match_jax(angles):
    close(transform.angle2matrix(angles, CPU), j_transform.angle2matrix(angles))
    rad = np.deg2rad(angles).tolist()
    close(transform.angle2matrix_3ddfa(rad, CPU), j_transform.angle2matrix_3ddfa(rad))
    v = np.random.default_rng(0).normal(size=(17, 3)).astype(np.float32)
    close(transform.rotate(t(v), angles), j_transform.rotate(jnp.asarray(v), angles))
    r = j_transform.angle2matrix(angles)
    close(transform.similarity_transform(t(v), 2.5, t(r), [0.1, -0.2, 0.3]),
          j_transform.similarity_transform(jnp.asarray(v), 2.5, r, [0.1, -0.2, 0.3]))
    # angles as a tensor keep their device
    assert transform.angle2matrix(torch.tensor(angles)).device.type == "cpu"


@pytest.mark.parametrize("angles", ANGLES)
def test_matrix2angle_matches_jax(angles):
    """At yaw 90 the rotation is singular (gimbal): the branch-free form
    takes the other atan2 and a roll of 0, as JAX's does."""
    r = np.asarray(j_transform.angle2matrix(angles))
    got = transform.matrix2angle(t(r))
    want = j_transform.matrix2angle(jnp.asarray(r))
    for g, w in zip(got, want):
        close(g, w, rtol=1e-5, atol=1e-4)  # degrees: atan2 of float32 entries
    sy = float(np.hypot(r[0, 0], r[1, 0]))
    if angles[1] == 90.0:
        assert sy < 1e-6 and float(got[2]) == 0.0


def test_camera_and_projections_match_jax():
    rng = np.random.default_rng(1)
    v = rng.normal(size=(23, 3)).astype(np.float32)
    close(transform.lookat_camera(t(v), [0.3, -0.2, 2.0]), j_transform.lookat_camera(jnp.asarray(v), [0.3, -0.2, 2.0]))
    close(transform.lookat_camera(t(v), [1.0, 2.0, 3.0], at=[0.1, 0.0, -0.2], up=[0.0, 0.0, 1.0]),
          j_transform.lookat_camera(jnp.asarray(v), [1.0, 2.0, 3.0], at=[0.1, 0.0, -0.2], up=[0.0, 0.0, 1.0]))
    assert transform.orthographic_project(t(v)) is not None
    close(transform.orthographic_project(t(v)), j_transform.orthographic_project(jnp.asarray(v)))
    vz = v - np.array([0, 0, 5], np.float32)  # in front of the camera
    close(transform.perspective_project(t(vz), 30.0, 1.3), j_transform.perspective_project(jnp.asarray(vz), 30.0, 1.3))
    close(transform.perspective_project(t(vz), 45.0, near=0.5, far=50.0),
          j_transform.perspective_project(jnp.asarray(vz), 45.0, near=0.5, far=50.0))
    for persp in (False, True):
        close(transform.to_image(t(v), 64, 128, persp), j_transform.to_image(jnp.asarray(v), 64, 128, persp))


def _pose_case(seed, coplanar):
    rng = np.random.default_rng(seed)
    x3d = rng.normal(size=(20, 3)).astype(np.float32)
    if coplanar:
        x3d[:, 2] = 0.0  # rank-deficient: the z column of the system is 0
    r = np.asarray(j_transform.angle2matrix([10.0, 20.0, 5.0]))
    x2d = (2.3 * x3d @ r[:2].T + np.array([3.0, -2.0])).astype(np.float32)
    x2d += rng.normal(0, 0.01, x2d.shape).astype(np.float32)
    return x3d, x2d


@pytest.mark.parametrize("coplanar", [False, True])
def test_affine_estimates_match_jax(coplanar):
    x3d, x2d = _pose_case(2, coplanar)
    p = transform.estimate_affine_matrix_3d22d(t(x3d), t(x2d))
    jp = j_transform.estimate_affine_matrix_3d22d(jnp.asarray(x3d), jnp.asarray(x2d))
    close(p, jp, rtol=1e-5, atol=1e-5)
    for g, w in zip(transform.p2srt(p), j_transform.p2srt(jp)):
        close(g, w, rtol=1e-5, atol=1e-5)
    y3d = (x3d @ np.array([[1.0, 0.2, 0.0], [0.1, 0.9, 0.3], [0.0, 0.4, 1.1]], np.float32) + 0.5).astype(np.float32)
    close(transform.estimate_affine_matrix_3d23d(t(x3d), t(y3d)),
          j_transform.estimate_affine_matrix_3d23d(jnp.asarray(x3d), jnp.asarray(y3d)), rtol=1e-5, atol=1e-5)


def test_lstsq_gives_the_minimum_norm_solution_as_jax():
    """Two equal columns: a one-dimensional null space, the minimum-norm
    solution splits the weight between them."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(12, 3)).astype(np.float32)
    a = np.concatenate([a, a[:, 1:2]], 1)
    b = rng.normal(size=(12, 2)).astype(np.float32)
    got = transform.lstsq(t(a), t(b))
    want = jnp.linalg.lstsq(jnp.asarray(a), jnp.asarray(b))[0]
    close(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), got[3].numpy(), rtol=1e-4)  # the weight split evenly
    close(transform.lstsq(t(a), t(b[:, 0])), want[:, 0], rtol=1e-5, atol=1e-5)


def test_host_values_go_to_the_card_or_raise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transform.angle2matrix([1.0, 2.0, 3.0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_synthetic_bfm(0, rings=3, around=4, cap=1, n_sp=2, n_ep=2, n_tp=2, n_kpt=2)


# ---------------------------------------------------------------------------
# light
# ---------------------------------------------------------------------------


def _light_mesh():
    """A bumpy 6x6 grid patch and an isolated vertex (no face)."""
    k = 6
    xs, ys = np.meshgrid(np.linspace(0, 1, k), np.linspace(0, 1, k))
    zs = 0.2 * np.sin(3 * xs) * np.cos(2 * ys)
    verts = np.stack([xs.reshape(-1), ys.reshape(-1), zs.reshape(-1)], 1)
    verts = np.vstack([verts, [[9.0, 9.0, 9.0]]]).astype(np.float32)
    idx = np.arange(k * k).reshape(k, k)
    a, b, c, d = idx[:-1, :-1].reshape(-1), idx[:-1, 1:].reshape(-1), idx[1:, 1:].reshape(-1), idx[1:, :-1].reshape(-1)
    tris = np.concatenate([np.stack([a, b, c], 1), np.stack([a, c, d], 1)]).astype(np.int32)
    return verts, tris


def test_get_normal_matches_jax():
    verts, tris = _light_mesh()
    got = light.get_normal(t(verts), t(tris))
    close(got, j_light.get_normal(jnp.asarray(verts), jnp.asarray(tris)))
    np.testing.assert_array_equal(got[-1].numpy(), [1.0, 0.0, 0.0])  # face3d's default for a lone vertex


def test_lights_match_jax():
    verts, tris = _light_mesh()
    rng = np.random.default_rng(4)
    colors = rng.uniform(0.2, 0.9, (verts.shape[0], 3)).astype(np.float32)
    pos = np.array([[0.5, 0.5, -10.0], [3.0, -2.0, -4.0]], np.float32)
    inten = np.array([[1.0, 0.5, 0.25], [0.3, 0.3, 0.6]], np.float32)
    close(light.add_light(t(verts), tris, t(colors), pos, inten),
          j_light.add_light(jnp.asarray(verts), jnp.asarray(tris), jnp.asarray(colors), jnp.asarray(pos),
                            jnp.asarray(inten)))
    coeff = rng.normal(size=9).astype(np.float32)
    close(light.add_light_sh(t(verts), tris, t(colors), coeff),
          j_light.add_light_sh(jnp.asarray(verts), jnp.asarray(tris), jnp.asarray(colors), jnp.asarray(coeff)))
    normals = rng.normal(size=(400, 3))
    normals = (normals / np.linalg.norm(normals, axis=1, keepdims=True)).astype(np.float32)
    close(light.sh_basis(t(normals)), j_light.sh_basis(jnp.asarray(normals)))
    albedo = rng.uniform(0.2, 0.9, (400, 3)).astype(np.float32)
    c_true = rng.normal(size=9).astype(np.float32)
    observed = (albedo * (light.sh_basis(t(normals)).numpy() @ c_true)[:, None]).astype(np.float32)
    for lamb in (1e-4, 10.0):
        got = light.fit_light_sh(t(observed), t(albedo), t(normals), lamb=lamb)
        close(got, j_light.fit_light_sh(jnp.asarray(observed), jnp.asarray(albedo), jnp.asarray(normals), lamb=lamb),
              rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(light.fit_light_sh(t(observed), t(albedo), t(normals), lamb=1e-4).numpy(), c_true,
                               atol=1e-3)


# ---------------------------------------------------------------------------
# bfm
# ---------------------------------------------------------------------------


def _models(seed=4, nver=40, n_sp=5, n_ep=3):
    """The 40-vertex model of ``tests/test_mesh3d.py:200`` (with a texture
    PCA, triangles and keypoints) in both packages."""
    rng = np.random.default_rng(seed)
    arrays = dict(
        shape_mu=rng.normal(0, 10.0, size=(3 * nver,)).astype(np.float32),
        shape_pc=rng.normal(size=(3 * nver, n_sp)).astype(np.float32),
        shape_ev=np.full((n_sp,), 1e3, np.float32),
        exp_pc=rng.normal(size=(3 * nver, n_ep)).astype(np.float32),
        exp_ev=np.full((n_ep,), 1e3, np.float32),
        triangles=rng.integers(0, nver, (30, 3)).astype(np.int32),
        kpt_ind=rng.choice(nver, 12, replace=False).astype(np.int32),
        tex_mu=rng.uniform(60, 200, 3 * nver).astype(np.float32),
        tex_pc=rng.normal(size=(3 * nver, 4)).astype(np.float32),
        tex_ev=np.linspace(5, 1, 4).astype(np.float32),
    )
    jm = j_bfm.MorphableModel(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return jm, convert.morphable_model_from_numpy(jm, CPU), rng


def test_load_bfm_matches_jax(tmp_path):
    """A ``.mat`` in BFM's layout (column vectors, (3, F) 1-based triangles,
    a ``tri_mouth`` supplement, 1-based keypoints), float64 as BFM ships."""
    rng = np.random.default_rng(5)
    nv, nf = 40, 30
    model = {
        "shapeMU": rng.normal(0, 10, (3 * nv, 1)), "shapePC": rng.normal(size=(3 * nv, 5)),
        "shapeEV": rng.uniform(1, 2, (5, 1)), "expMU": rng.normal(size=(3 * nv, 1)),
        "expPC": rng.normal(size=(3 * nv, 3)), "expEV": rng.uniform(1, 2, (3, 1)),
        "texMU": rng.uniform(60, 200, (3 * nv, 1)), "texPC": rng.normal(size=(3 * nv, 4)),
        "texEV": rng.uniform(1, 2, (4, 1)), "tri": rng.integers(1, nv + 1, (3, nf)).astype(np.float64),
        "tri_mouth": rng.integers(1, nv + 1, (3, 7)).astype(np.float64),
        "kpt_ind": rng.choice(np.arange(1, nv + 1), (1, 12), replace=False).astype(np.float64),
    }
    path = str(tmp_path / "BFM.mat")
    sio.savemat(path, {"model": model})
    got, want = bfm.load_bfm(path, CPU), j_bfm.load_bfm(path)
    for name in bfm.MorphableModel._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == (torch.float32 if w.dtype == np.float32 else torch.int64), name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert got.triangles.shape == (nf, 3) and int(got.triangles.min()) >= 0  # tri_mouth left out, 0-based
    assert (got.nver, got.n_shape_para, got.n_exp_para) == (nv, 5, 3)


def test_generation_matches_jax():
    jm, m, rng = _models()
    sp, ep, tp = (rng.normal(size=k).astype(np.float32) for k in (5, 3, 4))
    v = bfm.generate_vertices(m, t(sp), ep)
    close_scaled(v, j_bfm.generate_vertices(jm, jnp.asarray(sp), jnp.asarray(ep)))
    close_scaled(bfm.generate_colors(m, tp), j_bfm.generate_colors(jm, jnp.asarray(tp)))
    jv = j_bfm.generate_vertices(jm, jnp.asarray(sp), jnp.asarray(ep))
    close_scaled(bfm.transform(m, v, 1.7, [8.0, -15.0, 25.0], [5.0, -3.0, 1.0]),
                 j_bfm.transform(jm, jv, 1.7, [8.0, -15.0, 25.0], [5.0, -3.0, 1.0]))


def _fit_case(seed):
    jm, m, rng = _models(seed)
    sp_true, ep_true = rng.normal(size=5).astype(np.float32), rng.normal(size=3).astype(np.float32)
    v = np.asarray(j_bfm.generate_vertices(jm, jnp.asarray(sp_true), jnp.asarray(ep_true)))
    r_true = np.asarray(j_transform.angle2matrix([8.0, -15.0, 25.0]))
    x = (1.7 * v @ r_true[:2].T + np.array([5.0, -3.0])).astype(np.float32)  # scaled orthographic
    return jm, m, x, np.arange(v.shape[0], dtype=np.int32), r_true


def _reprojection(model_fn, model, sp, ep, s, r, t_):
    """The fitted model's vertices projected by (s, R, t); coefficients of a
    fit cut to fewer components padded with zeros."""
    sp = np.pad(np.asarray(sp), (0, model.shape_pc.shape[1] - len(sp)))
    ep = np.pad(np.asarray(ep), (0, model.exp_pc.shape[1] - len(ep)))
    v = np.asarray(model_fn(model, sp, ep))
    return float(s) * v @ np.asarray(r)[:2].T + np.asarray(t_)[:2]


@pytest.mark.parametrize("max_iter,subset", [(4, False), (6, True)])
def test_fit_points_matches_jax(max_iter, subset):
    """s, R, t and the reprojection within 1e-4 relative of JAX's; on a
    subset of the vertices, n_sp and n_ep cut to 3 and 2."""
    jm, m, x, ind, _ = _fit_case(6)
    kw = dict(n_sp=3, n_ep=2) if subset else {}
    if subset:
        ind, x = ind[::2], x[::2]
    got = bfm.fit_points(t(x), t(ind), m, max_iter=max_iter, **kw)
    want = j_fit_points(jnp.asarray(x), jnp.asarray(ind), jm, max_iter=max_iter, **kw)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4 * np.abs(np.asarray(w)).max())
    rp = _reprojection(bfm.generate_vertices, m, *[a.numpy() for a in got])
    jrp = _reprojection(j_bfm.generate_vertices, jm, *want)
    assert np.abs(rp - jrp).max() / np.abs(jrp).max() < 1e-4


def test_fit_points_recovers_pose_and_coefficients():
    """``tests/test_mesh3d.py:228``'s recovery on the port."""
    _, m, x, ind, r_true = _fit_case(5)
    sp, ep, s, r, t_ = bfm.fit_points(t(x), t(ind), m, max_iter=6)
    assert abs(float(s) - 1.7) < 1e-2 * 1.7
    np.testing.assert_allclose(r.numpy(), r_true, atol=2e-2)
    x_fit = _reprojection(bfm.generate_vertices, m, sp, ep, s, r, t_)
    assert np.abs(x_fit - x).max() / (np.abs(x).max() + 1e-9) < 2e-3


def test_fit_euler_wrapper_matches_jax():
    """``tests/test_mesh3d.py:253`` on the port, and against JAX."""
    jm, m, _ = _models(6)
    v = bfm.generate_vertices(m, torch.zeros(5), torch.zeros(3)).numpy()
    x = 2.0 * v[:, :2] + np.array([1.0, 2.0], np.float32)
    ind = np.arange(v.shape[0], dtype=np.int32)
    sp, ep, s, angles, t_ = bfm.fit(m, t(x), t(ind))
    assert abs(float(s) - 2.0) < 1e-2 and all(abs(float(a)) < 1.0 for a in angles)
    _, _, js, jangles, jt = j_fit(jm, jnp.asarray(x), jnp.asarray(ind))
    np.testing.assert_allclose(float(s), float(js), rtol=1e-4)
    np.testing.assert_allclose([float(a) for a in angles], [float(a) for a in jangles], atol=1e-3)
    np.testing.assert_allclose(t_.numpy(), np.asarray(jt), rtol=1e-4, atol=1e-4)


def test_synthetic_bfm_at_a_small_size():
    """``make_synthetic_bfm``'s layout at 5 rings of 8: 40 vertices, 68
    triangles (64 around, a fan of 4), indices in range, keypoints on the
    front; the defaults give BFM's counts (checked by arithmetic here, built
    by chip_smoke.py)."""
    m = make_synthetic_bfm(3, rings=5, around=8, cap=4, n_sp=5, n_ep=3, n_tp=4, n_kpt=10, device=CPU)
    assert (m.nver, m.triangles.shape, m.n_shape_para, m.n_exp_para, m.tex_pc.shape) == (40, (68, 3), 5, 3, (120, 4))
    assert int(m.triangles.min()) == 0 and int(m.triangles.max()) == 39
    assert len(set(m.kpt_ind.tolist())) == 10 and bool((m.shape_mu.reshape(-1, 3)[m.kpt_ind, 2] > 0).all())
    assert (145 * 367, 2 * 144 * 367 + 144) == (53215, 105840)
    again = make_synthetic_bfm(3, rings=5, around=8, cap=4, n_sp=5, n_ep=3, n_tp=4, n_kpt=10, device=CPU)
    assert all(torch.equal(a, b) for a, b in zip(m, again))  # made from the seed alone


# ---------------------------------------------------------------------------
# io and vis
# ---------------------------------------------------------------------------


def _mesh(seed=3):
    rng = np.random.default_rng(seed)
    verts = rng.normal(size=(9, 3))
    tris = rng.integers(0, 9, (7, 3)).astype(np.int32)
    return verts, tris, rng


def test_write_obj_with_colors_and_asc_match_jax(tmp_path):
    verts, tris, rng = _mesh()
    colors = rng.uniform(size=(9, 3))
    for name, v, c in (("f64", verts, colors), ("f32", verts.astype(np.float32), colors.astype(np.float32))):
        io.write_obj_with_colors(str(tmp_path / f"port_{name}"), t(v), t(tris), c)
        j_io.write_obj_with_colors(str(tmp_path / f"jax_{name}.obj"), v, tris, c)
        assert (tmp_path / f"port_{name}.obj").read_bytes() == (tmp_path / f"jax_{name}.obj").read_bytes()
        io.write_asc(str(tmp_path / f"port_{name}"), t(v))
        j_io.write_asc(str(tmp_path / f"jax_{name}"), v)
        assert (tmp_path / f"port_{name}.asc").read_bytes() == (tmp_path / f"jax_{name}.asc").read_bytes()


@pytest.mark.parametrize("kind", ["float_rgb", "uint8_rgb", "uint8_gray", "float_rgba"])
def test_write_obj_with_texture_matches_jax(tmp_path, kind):
    verts, tris, rng = _mesh(4)
    uv = rng.uniform(size=(9, 2))
    shape = {"float_rgb": (8, 6, 3), "uint8_rgb": (8, 6, 3), "uint8_gray": (5, 7), "float_rgba": (4, 4, 4)}[kind]
    tex = rng.uniform(-0.1, 1.1, shape)
    if kind.startswith("uint8"):
        tex = (tex.clip(0, 1) * 255).astype(np.uint8)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    io.write_obj_with_texture(str(tmp_path / "port" / "face.obj"), verts, tris, tex, uv)
    j_io.write_obj_with_texture(str(tmp_path / "jax" / "face.obj"), verts, tris, tex, uv)
    for f in ("face.obj", "face.mtl"):
        got = (tmp_path / "port" / f).read_text().replace(str(tmp_path / "port"), "<dir>")
        assert got == (tmp_path / "jax" / f).read_text().replace(str(tmp_path / "jax"), "<dir>"), f
    with Image.open(tmp_path / "port" / "face_texture.png") as a, Image.open(tmp_path / "jax" / "face_texture.png") as b:
        assert a.mode == b.mode
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_plot_mesh_draws_as_jax():
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from topo4d_tpu.mesh3d.vis import plot_mesh as j_plot_mesh

    from topo4d_tpu_torch.mesh3d.vis import plot_mesh

    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0.3]], np.float32)
    tris = np.array([[0, 1, 2], [1, 3, 2]], np.int32)
    images = []
    for fn, v in ((plot_mesh, t(verts)), (j_plot_mesh, verts)):
        fig = plt.figure(figsize=(2, 2))
        ax = fn(v, tris, title="toy", lwdt=0.5)
        assert ax.get_title() == "toy"
        fig.canvas.draw()
        images.append(np.asarray(fig.canvas.buffer_rgba()).copy())
        plt.close(fig)
    assert (images[0][..., :3] < 250).mean() > 0.01  # drew something
    np.testing.assert_array_equal(images[0], images[1])
