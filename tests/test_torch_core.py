"""Core math of the PyTorch port against the JAX package on the CPU:
camera, activation and the EWA projection (values and autograd gradients).

Tolerances: radii and mask equal; means2d, depths, conics rtol 1e-5 /
atol 1e-6; gradients rtol 1e-4 (scaled by their largest element).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topo4d_tpu.core.camera import full_projection_matrix as j_full_proj
from topo4d_tpu.core.gaussian import activate_params as j_activate
from topo4d_tpu.core.gaussian import project_gaussians as j_project
from topo4d_tpu.core.quaternion import normal_to_quat_reference as j_n2q
from topo4d_tpu.testing import make_camera_ring as j_ring
from topo4d_tpu.testing import make_head_fixture as j_head
from topo4d_tpu.testing import make_synthetic_camera as j_cam
from topo4d_tpu.testing import make_synthetic_scene

from topo4d_tpu_torch import convert
from topo4d_tpu_torch.core.camera import full_projection_matrix
from topo4d_tpu_torch.core.gaussian import activate_params, project_gaussians
from topo4d_tpu_torch.core.quaternion import normal_to_quat_reference
from topo4d_tpu_torch.device import resolve_device
from topo4d_tpu_torch.testing import make_camera_ring, make_head_fixture, make_synthetic_camera

CPU = "cpu"
CASES = [(160, 7, 64, 48, 0.0), (300, 1, 40, 30, 0.6), (64, 3, 33, 47, -0.4)]


def _torch_params(p):
    return {k: torch.as_tensor(v) for k, v in p.items()}


@pytest.mark.parametrize("n,seed,w,h,angle", CASES)
def test_camera_matches_jax(n, seed, w, h, angle):
    cj = j_cam(w, h, angle=angle)
    ct = make_synthetic_camera(w, h, angle=angle, device=CPU)
    np.testing.assert_array_equal(ct.w2c.numpy(), np.asarray(cj.w2c))
    np.testing.assert_allclose(
        full_projection_matrix(ct).numpy(), np.asarray(j_full_proj(cj)), rtol=1e-6, atol=1e-7
    )
    np.testing.assert_allclose(ct.tan_fovx.numpy(), np.asarray(cj.tan_fovx), rtol=1e-7)


def test_camera_ring_matches_jax():
    cj = j_ring(5, 48, 40, 1.5)
    ct = make_camera_ring(5, 48, 40, 1.5, device=CPU)
    for f in ("w2c", "fx", "fy", "cx", "cy"):
        np.testing.assert_array_equal(getattr(ct, f).numpy(), np.asarray(getattr(cj, f)))
    one = ct[3]
    np.testing.assert_array_equal(one.w2c.numpy(), np.asarray(cj[3].w2c))
    assert (one.width, one.height) == (cj.width, cj.height)


def test_convert_camera_roundtrip():
    cj = j_ring(3, 48, 40, 1.5)
    ct = convert.camera_from_numpy(cj, CPU)
    np.testing.assert_array_equal(ct.w2c.numpy(), np.asarray(cj.w2c))
    assert (ct.width, ct.height, ct.near, ct.far) == (cj.width, cj.height, cj.near, cj.far)


@pytest.mark.parametrize("n,seed,w,h,angle", CASES)
def test_activate_params_matches_jax(n, seed, w, h, angle):
    p = make_synthetic_scene(n=n, seed=seed)
    rj = j_activate({k: jnp.asarray(v) for k, v in p.items()})
    rt = activate_params(_torch_params(p))
    for a, b in zip(rt, rj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n,seed,w,h,angle", CASES)
def test_project_gaussians_matches_jax(n, seed, w, h, angle):
    p = make_synthetic_scene(n=n, seed=seed)
    pj = j_project(j_activate({k: jnp.asarray(v) for k, v in p.items()}), j_cam(w, h, angle=angle))
    pt = project_gaussians(activate_params(_torch_params(p)), make_synthetic_camera(w, h, angle=angle, device=CPU))
    np.testing.assert_array_equal(pt.radii.numpy(), np.asarray(pj.radii))
    np.testing.assert_array_equal(pt.mask.numpy(), np.asarray(pj.mask))
    for name in ("means2d", "depths", "conics"):
        np.testing.assert_allclose(
            getattr(pt, name).numpy(), np.asarray(getattr(pj, name)), rtol=1e-5, atol=1e-6, err_msg=name
        )


@pytest.mark.parametrize("n,seed,w,h,angle", CASES)
def test_projection_gradients_match_jax(n, seed, w, h, angle):
    p = make_synthetic_scene(n=n, seed=seed)
    rng = np.random.default_rng(seed + 100)
    wm = rng.normal(size=(n, 2)).astype(np.float32)
    wd = rng.normal(size=(n,)).astype(np.float32)
    wc = rng.normal(size=(n, 3)).astype(np.float32)
    cj = j_cam(w, h, angle=angle)

    def loss_j(params):
        pr = j_project(j_activate(params), cj)
        return jnp.sum(pr.means2d * wm) + jnp.sum(pr.depths * wd) + jnp.sum(pr.conics * wc)

    gj = jax.jit(jax.grad(loss_j))({k: jnp.asarray(v) for k, v in p.items()})
    tp = {k: v.requires_grad_(True) for k, v in _torch_params(p).items()}
    pr = project_gaussians(activate_params(tp), make_synthetic_camera(w, h, angle=angle, device=CPU))
    loss = (pr.means2d * torch.as_tensor(wm)).sum() + (pr.depths * torch.as_tensor(wd)).sum() + (
        pr.conics * torch.as_tensor(wc)
    ).sum()
    loss.backward()
    for k in ("means3D", "unnorm_rotations", "log_scales"):
        a, b = tp[k].grad.numpy(), np.asarray(gj[k])
        scale = np.abs(b).max()
        np.testing.assert_allclose(a / scale, b / scale, rtol=1e-4, atol=1e-6, err_msg=k)


def test_means2d_offset_gradient_matches_jax():
    p = make_synthetic_scene(n=96, seed=4)
    n = 96
    cj = j_cam(64, 48)
    rv_j = j_activate({k: jnp.asarray(v) for k, v in p.items()})
    gj = jax.grad(lambda off: jnp.sum(j_project(rv_j, cj, off).means2d ** 2))(jnp.zeros((n, 2)))
    off = torch.zeros((n, 2), requires_grad=True)
    (project_gaussians(activate_params(_torch_params(p)), make_synthetic_camera(64, 48, device=CPU), off).means2d ** 2).sum().backward()
    np.testing.assert_allclose(off.grad.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-4)


def test_normal_to_quat_reference_matches_jax():
    rng = np.random.default_rng(0)
    d = rng.normal(size=(200, 3)).astype(np.float32)
    np.testing.assert_allclose(normal_to_quat_reference(d), np.asarray(j_n2q(jnp.asarray(d))), rtol=1e-5, atol=1e-6)


def test_head_fixture_matches_jax():
    pt, ct, (vt, ft) = make_head_fixture(rows=12, cols=10, num_views=3, width=64, height=48, device=CPU)
    pj, cj, (vj, fj) = j_head(rows=12, cols=10, num_views=3, width=64, height=48)
    for k in pj:
        np.testing.assert_array_equal(pt[k], pj[k], err_msg=k)
    np.testing.assert_array_equal(vt, vj)
    assert ft == fj
    np.testing.assert_array_equal(ct.w2c.numpy(), np.asarray(cj.w2c))


def test_entry_points_default_to_the_card():
    """No card and no device argument: the entry point raises, it does not
    fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_synthetic_camera()
    assert resolve_device("cpu") == torch.device("cpu")
