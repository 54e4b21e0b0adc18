"""The face-parsing masks of ``topo4d_tpu_torch/pipeline/masks.py``
against the JAX package's, bit for bit.

Mirrors ``tests/test_masks.py`` (the colormap's bits, a label's exact color
block, the dimming of only the masked pixels) with each result also held
to JAX's, and adds a random parsing image mixing every label's color with
colors one step off it, through every label set the pipeline uses.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topo4d_tpu.config import DEFAULT_CMAP_INDEX as J_CMAP_INDEX
from topo4d_tpu.pipeline import masks as J

from topo4d_tpu_torch.config import DEFAULT_CMAP_INDEX
from topo4d_tpu_torch.pipeline import masks as P
from topo4d_tpu_torch.texture.dense import DENSE_MASK_LABELS


def test_cmap_index_matches_jax():
    assert DEFAULT_CMAP_INDEX == J_CMAP_INDEX


@pytest.mark.parametrize("n", [11, 14, 19, 8])
def test_label_colormap_matches_jax(n):
    np.testing.assert_array_equal(P.label_colormap(n), J.label_colormap(n))
    np.testing.assert_array_equal(P.bgr_colormap(n), J.bgr_colormap(n))


def _parsing_image(h, w, seed):
    """Every label's BGR color, plus colors 1 and 2 steps off a label, per pixel."""
    rng = np.random.default_rng(seed)
    cmap = P.bgr_colormap(14).astype(np.int32)
    img = cmap[rng.integers(0, 14, (h, w))]
    off = rng.integers(-2, 3, (h, w, 3)) * (rng.uniform(size=(h, w, 1)) < 0.3)
    return (np.clip(img + off, 0, 255).astype(np.float32) / 255.0).transpose(2, 0, 1)


@pytest.mark.parametrize("labels", [("inner_mouth",), tuple(DENSE_MASK_LABELS), ("background", "glasses")])
def test_get_mask_bit_for_bit(labels):
    mask_img = _parsing_image(23, 31, seed=len(labels))
    got = P.get_mask(labels, torch.as_tensor(mask_img), DEFAULT_CMAP_INDEX)
    want = np.asarray(J.get_mask(labels, jnp.asarray(mask_img), J_CMAP_INDEX))
    assert got.shape == (3, 23, 31) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.mean() < 1


def test_get_mask_hits_exact_label_color():
    cmap = P.bgr_colormap(14)
    idx = DEFAULT_CMAP_INDEX["inner_mouth"]
    h, w = 6, 8
    mask_img = np.zeros((3, h, w), np.float32)
    mask_img[:, 2:4, 3:5] = (cmap[idx].astype(np.float32) / 255.0)[:, None, None]
    got = P.get_mask(["inner_mouth"], torch.as_tensor(mask_img), DEFAULT_CMAP_INDEX).numpy()
    want = np.zeros((h, w))
    want[2:4, 3:5] = 1
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(got[1], want)
    np.testing.assert_array_equal(got, np.asarray(J.get_mask(["inner_mouth"], jnp.asarray(mask_img), J_CMAP_INDEX)))


def test_dim_inner_mouth_scales_only_masked_pixels():
    cmap = P.bgr_colormap(14)
    idx = DEFAULT_CMAP_INDEX["inner_mouth"]
    h, w = 4, 4
    mask_img = np.zeros((3, h, w), np.float32)
    mask_img[:, 0, 0] = cmap[idx].astype(np.float32) / 255.0
    gt = np.full((3, h, w), 0.8, np.float32)
    out = P.dim_inner_mouth(torch.as_tensor(gt), torch.as_tensor(mask_img), DEFAULT_CMAP_INDEX).numpy()
    np.testing.assert_allclose(out[:, 0, 0], 0.08, rtol=1e-6)
    np.testing.assert_allclose(out[:, 1:, :], 0.8, rtol=1e-6)
    np.testing.assert_allclose(out[:, 0, 1:], 0.8, rtol=1e-6)


def test_dim_inner_mouth_bit_for_bit():
    mask_img = _parsing_image(29, 17, seed=5)
    gt = np.random.default_rng(6).uniform(size=(3, 29, 17)).astype(np.float32)
    got = P.dim_inner_mouth(torch.as_tensor(gt), torch.as_tensor(mask_img), DEFAULT_CMAP_INDEX).numpy()
    want = np.asarray(J.dim_inner_mouth(jnp.asarray(gt), jnp.asarray(mask_img), J_CMAP_INDEX))
    np.testing.assert_array_equal(got, want)
    assert (got != gt).any()
