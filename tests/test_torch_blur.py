"""The SSIM blur of the PyTorch port (K5's plain version) against the JAX
package on the CPU.

The plain blur against JAX's Pallas blur in interpret mode and against
JAX's shifted-slice form, rtol 1e-5 / atol 1e-6 (the JAX suite's own,
``tests/test_losses.py:57``); the self-adjoint backward rule on the plain
version against autograd; SSIM through the new window against JAX. The
CUDA kernel runs only on the card: the ``cuda`` test compares it with the
plain version (bit for bit: same operation order, no fused multiply-add)
and skips here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topo4d_tpu.losses.blur_pallas import gauss_blur_pallas
from topo4d_tpu.losses.image import _shift_pass as j_shift_pass
from topo4d_tpu.losses.image import l1_loss_sum_last as j_l1_sum_last
from topo4d_tpu.losses.image import ssim as j_ssim

from topo4d_tpu_torch.losses.blur import (
    LAUNCHES,
    SelfAdjointBlur,
    gauss_blur,
    gauss_blur_cuda,
    gauss_blur_plain,
    reset_launches,
)
from topo4d_tpu_torch.losses.image import l1_loss_sum_last, ssim

SHAPES = [(3, 37, 51), (15, 200, 300), (2, 128, 128)]
# the kernel's edge cases: H and W below the window, widths no multiple of 4
# or of its 128-column strip, a single row of strips; (3, 2161, 3843), its
# run and strip edges at 4K, goes to the card only (interpret mode at that
# size would take minutes)
EDGE_SHAPES = [(3, 7, 5), (2, 37, 53), (1, 11, 700)]


def _x(shape, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES + EDGE_SHAPES)
def test_plain_blur_matches_jax_pallas_blur(shape):
    x = _x(shape)
    a = gauss_blur_plain(torch.as_tensor(x)).numpy()
    b = np.asarray(gauss_blur_pallas(jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES + EDGE_SHAPES)
def test_plain_blur_matches_jax_shift_form(shape):
    x = _x(shape, 1)
    a = gauss_blur_plain(torch.as_tensor(x)).numpy()
    xj = jnp.asarray(x)
    b = np.asarray(j_shift_pass(j_shift_pass(xj, 1, 11, 1.5), 2, 11, 1.5))
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_self_adjoint_backward_is_the_blur_of_the_cotangent():
    """The kernel's autograd rule, run on the plain version, against
    autograd through the plain version (and JAX's custom VJP)."""
    x = _x((2, 40, 60), 2)
    w = _x((2, 40, 60), 3)
    xa = torch.as_tensor(x).requires_grad_(True)
    (ga,) = torch.autograd.grad((SelfAdjointBlur.apply(xa, gauss_blur_plain) * torch.as_tensor(w)).sum(), xa)
    xb = torch.as_tensor(x).requires_grad_(True)
    (gb,) = torch.autograd.grad((gauss_blur_plain(xb) * torch.as_tensor(w)).sum(), xb)
    np.testing.assert_allclose(ga.numpy(), gb.numpy(), rtol=1e-5, atol=1e-6)
    gj = jax.grad(lambda a: jnp.sum(gauss_blur_pallas(a, interpret=True) * jnp.asarray(w)))(jnp.asarray(x))
    np.testing.assert_allclose(ga.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-6)


def test_cpu_tensors_take_the_plain_version():
    reset_launches()
    gauss_blur(torch.as_tensor(_x((1, 9, 13))))
    assert LAUNCHES == {"gauss_blur": 0, "gauss_blur_plain": 1}
    with pytest.raises(ValueError, match="CUDA"):
        gauss_blur_cuda(torch.zeros(1, 4, 4))


@pytest.mark.parametrize("seed", [0, 1])
def test_ssim_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (3, 64, 96)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(
        float(ssim(torch.as_tensor(a), torch.as_tensor(b))), float(j_ssim(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5
    )
    ta = torch.as_tensor(a).requires_grad_(True)
    (gt,) = torch.autograd.grad(ssim(ta, torch.as_tensor(b)), ta)
    gj = jax.grad(lambda x: j_ssim(x, jnp.asarray(b)))(jnp.asarray(a))
    scale = float(np.abs(np.asarray(gj)).max())
    np.testing.assert_allclose(gt.numpy() / scale, np.asarray(gj) / scale, rtol=1e-4, atol=1e-5)


def test_l1_loss_sum_last_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(50, 3)).astype(np.float32)
    y = rng.normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_allclose(
        float(l1_loss_sum_last(torch.as_tensor(x), torch.as_tensor(y))),
        float(j_l1_sum_last(jnp.asarray(x), jnp.asarray(y))), rtol=1e-6,
    )


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the blur kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(15, 512, 375)] + EDGE_SHAPES + [(3, 2161, 3843)])
def test_blur_kernel_matches_plain_on_the_card(cuda, shape):
    x = torch.as_tensor(_x(shape, 5), device=cuda).requires_grad_(True)
    g = torch.as_tensor(_x(shape, 6), device=cuda)
    yk = gauss_blur(x)
    yp = gauss_blur_plain(x)
    torch.testing.assert_close(yk, yp, rtol=0, atol=0)
    (dk,) = torch.autograd.grad(yk, x, g)
    (dp,) = torch.autograd.grad(yp, x, g)
    torch.testing.assert_close(dk, dp, rtol=1e-5, atol=1e-6)
