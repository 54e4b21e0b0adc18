"""K1's warp-uniform bounding-box cull, through its plain mirror, on the CPU.

``warp_block_cull_plain`` (``rasterizer/blend.py``) mirrors the cull of
``csrc/blend_fwd.cu``: an entry is skipped for a warp's 8 x 8 pixel block
when the block lies outside a box around the entry's centre. The cull is
safe only if it never removes an entry that some pixel of the block would
blend. These tests hold the mirror to the plain blend's own test
(``tile_alpha``: power <= 0 and alpha >= 1/255) at every pixel of every
culled block, on the blend suite's scenes, the saturated-window scene, the
head fixture, hand-made entries whose alpha reaches 1/255 exactly at a
pixel of a neighbouring block, and hypothesis-drawn conics; and check that
it culls a real share of the head fixture's pairs. The kernel's own cull
runs only on the card (``chip_smoke.py`` counts it with this mirror).
"""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from topo4d_tpu.testing import make_synthetic_scene

from topo4d_tpu_torch.convert import params_from_numpy
from topo4d_tpu_torch.core.gaussian import activate_params, project_gaussians
from topo4d_tpu_torch.rasterizer.blend import cull_box_plain, tile_alpha, warp_block_cull_plain
from topo4d_tpu_torch.rasterizer.tiles import PACK_FIELDS, compute_binning, pack_with_binning
from topo4d_tpu_torch.testing import make_head_fixture, make_synthetic_camera

CPU = "cpu"
BLEND_CASES = [(160, 7, 64, 48, 8), (160, 7, 64, 48, 4), (300, 3, 48, 40, 2)]  # tests/test_torch_blend.py


def _pack(rv, cam, w, h, span):
    proj = project_gaussians(rv, cam)
    bins = pack_with_binning(proj, rv.colors, rv.opacities, compute_binning(proj, w, h, span))
    return bins.packed, bins.tile_start, bins.tile_count, -(-w // 16)


def _check_safe(packed, start, count, tiles_x):
    """No culled (row, warp block, entry) has a pixel that passes the plain
    blend's test -> (culled pairs, pairs in the ranges)."""
    culled = warp_block_cull_plain(packed, start, count, tiles_x)
    alpha, _ = tile_alpha(packed, start, count, tiles_x)
    r, _, m = alpha.shape
    # (R, 256, M) pixels row-major -> (R, block row, 8, block column, 8, M)
    passes = (alpha > 0).view(r, 2, 8, 2, 8, m).any(4).any(2).reshape(r, 4, m)
    bad = culled & passes
    assert not bool(bad.any()), f"{int(bad.sum())} culled (entry, warp) pairs have a pixel that passes"
    return int(culled.sum()), 4 * int(count.sum())


@pytest.mark.parametrize("n,seed,w,h,span", BLEND_CASES)
def test_cull_is_conservative_on_the_blend_cases(n, seed, w, h, span):
    p = make_synthetic_scene(n=n, seed=seed)
    with torch.no_grad():
        rv = activate_params({k: torch.as_tensor(v) for k, v in p.items()})
        culled, pairs = _check_safe(*_pack(rv, make_synthetic_camera(w, h, device=CPU), w, h, span))
    assert 0 < culled < pairs


def test_cull_is_conservative_in_saturated_windows():
    """The scene of test_torch_blend.py's saturated-window test: 64
    Gaussians at opacity sigmoid(8) inside one tile."""
    n = 64
    rng = np.random.default_rng(5)
    params = {
        "means3D": rng.normal(0, 0.003, (n, 3)).astype(np.float32),
        "rgb_colors": rng.uniform(0.2, 0.8, (n, 3)).astype(np.float32),
        "unnorm_rotations": np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
        "logit_opacities": np.full((n, 1), 8.0, np.float32),
        "log_scales": np.full((n, 3), np.log(0.05), np.float32),
    }
    with torch.no_grad():
        rv = activate_params({k: torch.as_tensor(v) for k, v in params.items()})
        _check_safe(*_pack(rv, make_synthetic_camera(32, 32, device=CPU), 32, 32, 8))


def test_cull_removes_a_share_of_the_head_fixture():
    """The head fixture (a 12 x 12 grid, 96 x 64): safe, and it culls a
    nonzero share of the (entry, warp) pairs, so the safety checks above
    do not pass vacuously."""
    params, cams, _ = make_head_fixture(rows=12, cols=12, num_views=1, width=96, height=64, device=CPU)
    with torch.no_grad():
        rv = activate_params(params_from_numpy(params, CPU))
        culled, pairs = _check_safe(*_pack(rv, cams[0], 96, 64, 4))
    assert culled > 0.2 * pairs


def _single_tile(entries):
    """One 16 x 16 tile whose range holds ``entries`` (x, y, a, b, c, o) in
    order -> (packed, start, count, tiles_x)."""
    e = len(entries)
    packed = torch.zeros((PACK_FIELDS, max(e, 1)), dtype=torch.float32)
    if e:
        packed[:6] = torch.tensor(entries, dtype=torch.float32).T
        packed[8:12] = 0.5
    return packed, torch.tensor([0], dtype=torch.int32), torch.tensor([e], dtype=torch.int32), 1


def _tight_entries():
    """Round Gaussians whose alpha reaches 1/255 within rounding at a pixel
    d columns (or rows) from the centre, with the centre on a block edge or
    a pixel off it, so that the pixel lies in the neighbouring block."""
    out = []
    for o in (1.0, 0.5, 0.05, 1.0 / 255.0 * 1.001):
        for d in range(1, 12):
            sigma2 = d * d / (2.0 * math.log(255.0 * o))
            q = 1.0 / sigma2
            for cx, cy in ((7.0, 3.0), (8.0 - d, 3.0), (7.0 - d + 8.0, 12.0), (3.0, 8.0 - d), (12.0, 15.0 - d)):
                for scale in (1.0, 1.0 + 1e-6, 1.0 - 1e-6):
                    out.append((cx, cy, q * scale, 0.0, q * scale, o))
    return out


def test_cull_is_conservative_at_the_threshold():
    for i in range(0, len(_tight_entries()), 60):
        _check_safe(*_single_tile(_tight_entries()[i : i + 60]))


def test_cull_box_edge_branches():
    """Opacity above 1, a conic that is not positive definite and a NaN cull
    nothing; an opacity below 1/255 culls every pixel."""
    x = torch.tensor([4.0, 4.0, 4.0, 4.0, float("nan"), 4.0])
    y = torch.full_like(x, 4.0)
    a = torch.tensor([0.5, 0.5, -0.5, 0.5, 0.5, 0.5])
    b = torch.tensor([0.0, 0.6, 0.0, 0.0, 0.0, 0.0])
    c = torch.tensor([0.5, 0.5, 0.5, 0.5, 0.5, 0.5])
    o = torch.tensor([1.5, 0.5, 0.5, 1.0 / 255.0 * 0.999, 0.5, float("nan")])
    hx, hy = cull_box_plain(x, y, a, b, c, o)
    inf = float("inf")
    assert hx.tolist() == [inf, inf, inf, -inf, inf, inf]
    assert hy.tolist() == hx.tolist()


_edges = st.sampled_from([0.0, 7.0, 7.5, 8.0, 8.5, 15.0, 16.0, -0.5, -8.0, 23.5])
_coord = st.one_of(_edges, _edges.map(lambda v: v + 1e-4), st.floats(-40.0, 56.0))
_opacity = st.one_of(
    st.sampled_from([1.0, 0.99999, 0.5, 1.0 / 255.0, 1.0 / 255.0 * 1.00001, 1.0 / 255.0 * 0.99999, 1.0 + 1e-6]),
    st.floats(1e-4, 1.2),
)


@st.composite
def _entry(draw):
    """An entry with a drawn centre and opacity and a conic that is round,
    elongated and rotated, or near-degenerate (b^2 close to ac)."""
    x, y, o = draw(_coord), draw(_coord), draw(_opacity)
    if draw(st.booleans()):
        s1 = draw(st.floats(0.3, 40.0))
        s2 = draw(st.floats(0.3, 40.0))
        th = draw(st.floats(0.0, math.pi))
        ct, sn = math.cos(th), math.sin(th)
        a = ct * ct / s1**2 + sn * sn / s2**2
        c = sn * sn / s1**2 + ct * ct / s2**2
        b = ct * sn * (1.0 / s1**2 - 1.0 / s2**2)
    else:
        a = draw(st.floats(1e-3, 4.0))
        c = draw(st.floats(1e-3, 4.0))
        eps = draw(st.sampled_from([0.0, 1e-7, 1e-5, 1e-3, 1e-2, 0.3]))
        b = draw(st.sampled_from([1.0, -1.0])) * math.sqrt(a * c) * (1.0 - eps)
    return (x, y, a, b, c, o)


@settings(max_examples=150, deadline=None)
@given(st.lists(_entry(), min_size=1, max_size=12))
def test_cull_is_conservative_on_drawn_conics(entries):
    _check_safe(*_single_tile(entries))
