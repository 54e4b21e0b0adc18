"""The tiled and oracle renderers of the port (``rasterizer/tiled.py``,
``rasterizer/reference.py``, plain PyTorch) against the JAX package's, on
the CPU.

Scenes of ``tests/test_rasterizer_tiled.py`` (200 Gaussians, 80x56 and a
50x37 canvas, no multiple of 16) and ``tests/test_rasterizer_oracle.py``
(128 Gaussians, 48x32). Forward at those files' tolerances (image and
alpha rtol 1e-4 / atol 1e-5, depth atol 1e-4, radii exact), the overflow
and crop counts exactly, and the gradients of an L1 + alpha loss with
respect to every parameter and to a ``means2d_offset`` at rtol 2e-3 /
atol 2e-6. The loss's target is 0.05, not the black background the
renders give exactly: ``jax.grad(abs)(0)`` is 1, PyTorch's 0 (ROADMAP
Queue 3). The port's default front end (``rasterizer/render.py``, the
plain blend on the CPU) is held to JAX's oracle on the same
``means2d_offset`` gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topo4d_tpu.core.gaussian import activate_params as j_activate
from topo4d_tpu.rasterizer.reference import render_gaussians as j_oracle
from topo4d_tpu.rasterizer.tiled import render_gaussians_tiled as j_tiled
from topo4d_tpu.testing import make_synthetic_camera as j_camera
from topo4d_tpu.testing import make_synthetic_scene

from topo4d_tpu_torch.core.gaussian import activate_params
from topo4d_tpu_torch.rasterizer.reference import render_gaussians as oracle
from topo4d_tpu_torch.rasterizer.render import render_gaussians as front_end
from topo4d_tpu_torch.rasterizer.tiled import render_gaussians_tiled as tiled
from topo4d_tpu_torch.testing import make_synthetic_camera

CPU = "cpu"
TARGET = 0.05


def _scene(n, seed, w, h):
    params = {k: np.asarray(v, np.float32) for k, v in make_synthetic_scene(n=n, seed=seed).items()}
    return params, make_synthetic_camera(width=w, height=h, device=CPU), j_camera(width=w, height=h)


SCENES = {"tiled": (200, 3, 80, 56), "odd": (200, 3, 50, 37), "oracle": (128, 0, 48, 32)}
RENDERERS = {
    "tiled": (lambda rv, cam, **kw: tiled(rv, cam, max_span=8, capacity=256, **kw),
              lambda rv, cam, **kw: j_tiled(rv, cam, max_span=8, capacity=256, **kw)),
    "oracle": (lambda rv, cam, **kw: oracle(rv, cam, **kw), lambda rv, cam, **kw: j_oracle(rv, cam, **kw)),
}


def _torch(params):
    return {k: torch.as_tensor(v) for k, v in params.items()}


@pytest.mark.parametrize("scene", list(SCENES))
@pytest.mark.parametrize("kind", list(RENDERERS))
def test_forward_matches_jax(kind, scene):
    params, cam, jcam = _scene(*SCENES[scene])
    bg = np.array([0.2, 0.1, 0.4], np.float32)
    port, jax_fn = RENDERERS[kind]
    got = port(activate_params(_torch(params)), cam, bg=torch.as_tensor(bg))
    want = jax_fn(j_activate({k: jnp.asarray(v) for k, v in params.items()}), jcam, bg=jnp.asarray(bg))
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got.radii.numpy(), np.asarray(want.radii))
    assert got.image.shape == (3, cam.height, cam.width)
    if kind == "tiled":
        assert int(got.num_cropped) == int(want.num_cropped) == 0
        assert int(got.num_overflow) == int(want.num_overflow) == 0


def _grads_port(render, params, cam):
    p = {k: v.clone().requires_grad_(True) for k, v in _torch(params).items()}
    off = torch.zeros((params["means3D"].shape[0], 2), requires_grad=True)
    out = render(activate_params(p), cam, means2d_offset=off)
    loss = torch.mean(torch.abs(out.image - TARGET)) + 0.1 * torch.mean(out.alpha)
    loss.backward()
    return {**{k: v.grad.numpy() for k, v in p.items()}, "means2d_offset": off.grad.numpy()}


def _grads_jax(render, params, cam):
    def loss(p, off):
        out = render(j_activate(p), cam, means2d_offset=off)
        return jnp.mean(jnp.abs(out.image - TARGET)) + 0.1 * jnp.mean(out.alpha)

    off = jnp.zeros((params["means3D"].shape[0], 2))
    g, g_off = jax.grad(loss, argnums=(0, 1))({k: jnp.asarray(v) for k, v in params.items()}, off)
    return {**{k: np.asarray(v) for k, v in g.items()}, "means2d_offset": np.asarray(g_off)}


@pytest.mark.parametrize("kind", list(RENDERERS))
def test_gradients_match_jax(kind):
    params, cam, jcam = _scene(*SCENES[kind])
    port, jax_fn = RENDERERS[kind]
    got, want = _grads_port(port, params, cam), _grads_jax(jax_fn, params, jcam)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.abs(want[k]).max() > 0 or k == "logit_opacities", k
        np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=2e-6, err_msg=k)


def test_oracle_remat_gradients_equal():
    """``remat`` recomputes each row block in the backward: same gradients."""
    params, cam, _ = _scene(*SCENES["oracle"])
    a = _grads_port(lambda rv, c, **kw: oracle(rv, c, row_block=8, **kw), params, cam)
    b = _grads_port(lambda rv, c, **kw: oracle(rv, c, row_block=8, remat=True, **kw), params, cam)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_front_end_means2d_offset_gradient_matches_jax_oracle():
    params, cam, jcam = _scene(*SCENES["tiled"])
    got = _grads_port(lambda rv, c, **kw: front_end(rv, c, max_span=8, **kw), params, cam)
    want = _grads_jax(lambda rv, c, **kw: j_oracle(rv, c, **kw), params, jcam)
    np.testing.assert_allclose(got["means2d_offset"], want["means2d_offset"], rtol=2e-3, atol=2e-6)
    assert np.abs(want["means2d_offset"]).max() > 0


@pytest.mark.parametrize("capacity,max_span", [(8, 8), (256, 1), (100, 4)])
def test_overflow_and_crop_counts_match_jax(capacity, max_span):
    params, cam, jcam = _scene(*SCENES["tiled"])
    got = tiled(activate_params(_torch(params)), cam, max_span=max_span, capacity=capacity, chunk=64)
    want = j_tiled(j_activate({k: jnp.asarray(v) for k, v in params.items()}), jcam, max_span=max_span,
                   capacity=capacity, chunk=64)
    assert int(got.num_overflow) == int(want.num_overflow)
    assert int(got.num_cropped) == int(want.num_cropped)
    assert int(got.num_overflow) + int(got.num_cropped) > 0 or capacity == 100
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image), rtol=1e-4, atol=1e-5)
