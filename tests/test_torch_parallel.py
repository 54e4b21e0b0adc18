"""The multi-rank paths of the PyTorch port on the CPU, in spawned gloo
worlds (``tests/torch_ranks.py``), against the port on one process and the
JAX package's sharded paths on the 8 virtual CPU devices of
``tests/conftest.py`` (``tests/test_parallel.py:49-128``, ``:141``,
``:208``, ``:273``; ``tests/test_texture.py:261``).

- The view-sharded batched step on 2 and 4 ranks, and on 3 ranks, where 8
  views make a mesh of 2 and the third rank holds none: against the port's
  unsharded step and JAX's ``make_view_mesh(8)`` step (Pallas in interpret
  mode, as ``test_shard_map_pallas_matches_unsharded`` runs it): loss rtol
  1e-5, parameters rtol 1e-4 / atol 1e-6; every rank's parameters, Adam
  moments and radii equal bit for bit. The topological terms carry weight
  (the scale losses), so a gradient that counted them once per rank shows.
- The sharded loss's gradient equal to the mean of per-view gradients
  (rtol 1e-4 / atol 1e-7, ``:95``).
- A world of one process: the sharded step equal to the unsharded one bit
  for bit (a one-rank all-reduce is the identity).
- The tile-sharded render, full canvas and frozen compact list, on 2 and 3
  ranks: forward and gradients equal in value to the port's single render;
  against ``render_gaussians_pallas_tile_sharded``, pixels within JAX's
  tolerance (rtol 1e-5 / atol 1e-6) and gradients, scaled by their largest
  element, within the port's render tolerance against JAX (rtol 2e-3 /
  atol 2e-5, ``tests/test_torch_compact.py``): JAX's own 1e-4 / 1e-6 holds
  one implementation against itself, and the plain blend sums in another
  order than the Pallas kernels (the rotations' gradients differ by up to
  1.3e-6 of the largest).
- The sharded bake, ``bands`` 4 and 6 on 2 and 3 ranks, bit for bit against
  the port's plain single bake, and against JAX's ``bake_texture_sharded``
  at the bake tolerance but for JAX's crack pixels (zero in JAX's, covered
  in the port's), as ``tests/test_torch_bake.py`` allows them.
"""

import datetime
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from topo4d_tpu.core.gaussian import activate_params as j_activate
from topo4d_tpu.losses.temporal import TemporalPriors as JTemporal
from topo4d_tpu.opt.adam import adam_init as j_adam_init
from topo4d_tpu.opt.step import GeometryPriors as JPriors
from topo4d_tpu.opt.step import TrainState as JState
from topo4d_tpu.parallel.batched import make_batched_geometry_step as j_batched_step
from topo4d_tpu.parallel.mesh import make_view_mesh as j_view_mesh
from topo4d_tpu.parallel.mesh import replicated as j_replicated
from topo4d_tpu.parallel.mesh import shard_view_batch as j_shard
from topo4d_tpu.rasterizer.pallas import render_gaussians_pallas_tile_sharded
from topo4d_tpu.testing import make_head_fixture as j_head
from topo4d_tpu.testing import make_synthetic_camera as j_cam
from topo4d_tpu.testing import make_synthetic_scene
from topo4d_tpu.texture.bake import bake_texture_sharded as j_bake_sharded

from topo4d_tpu_torch import convert
from topo4d_tpu_torch.core.gaussian import activate_params
from topo4d_tpu_torch.parallel.batched import make_batched_geometry_step
from topo4d_tpu_torch.parallel.mesh import make_view_mesh
from topo4d_tpu_torch.rasterizer.render import attach_compact, binning_for, render_gaussians
from topo4d_tpu_torch.texture.bake_tiled import bake_texture_tiled
from torch_ranks import _state, priors, render_fn, run_world

CPU = "cpu"
V, W, H = 8, 48, 32
PHASES = ("init", "init")
LR = {k: 1e-3 for k in ("means3D", "rgb_colors", "unnorm_rotations", "logit_opacities", "log_scales", "cam_m",
                        "cam_c")}
WEIGHTS = {"im": 1.0, "scale": 10.0, "scale_max": 10.0}
TOL_BAKE = dict(rtol=2e-4, atol=2e-5)
BANDS = (4, 6)


def view_inputs():
    """``tests/test_parallel.py`` ``small_setup(v=8)``: 8 views at 48x32 of
    the 8x8 head grid, random targets, zero priors."""
    params, cams, (verts, _) = j_head(rows=8, cols=8, num_views=V, width=W, height=H)
    n = verts.shape[0]
    images = np.random.default_rng(0).uniform(0, 1, (V, 3, H, W)).astype(np.float32)
    z = lambda *s: np.zeros(s, np.float32)
    pri = {
        "neighbor_indices": np.zeros((4, n), np.int32), "neighbor_dist": z(4, n), "iso_w": z(4, n),
        "rig_w": z(4, n), "rot_w": z(4, n), "init_scale": np.full((n,), 0.05, np.float32),
        "temporal": {"prev_inv_rot": z(4, n), "prev_offset": z(3, 4, n)}, "cos_init": z(0),
    }
    cam = {k: np.asarray(getattr(cams, k)) for k in ("w2c", "fx", "fy", "cx", "cy")}
    cam.update(width=cams.width, height=cams.height, near=cams.near, far=cams.far)
    return {"params": params, "cams": cam, "images": images, "priors": pri, "lr": LR, "weights": WEIGHTS,
            "phases": PHASES, "grad_views": 4}, cams


def tile_inputs():
    """The scenes of ``test_tile_sharded_render_matches_single_device`` and
    ``test_tile_sharded_compact_matches_single_device``."""
    out = {}
    for name, seed, spread, (w, h), bg, tseed, alpha_w, compact in (
        ("full", 7, 0.5, (128, 64), (0.2, 0.1, 0.3), 3, 0.05, False),
        ("compact", 11, 0.12, (192, 96), (0.05, 0.1, 0.15), 5, 0.0, True),
    ):
        c = j_cam(w, h)
        cam = {k: np.asarray(getattr(c, k)) for k in ("w2c", "fx", "fy", "cx", "cy")}
        cam.update(width=c.width, height=c.height, near=c.near, far=c.far)
        out[name] = {
            "params": make_synthetic_scene(n=160, seed=seed, spread=spread), "cam": cam,
            "bg": np.asarray(bg, np.float32), "compact": compact, "alpha_w": alpha_w,
            "target": np.random.default_rng(tseed).uniform(0, 1, (3, h, w)).astype(np.float32),
        }
    return out


def random_mesh(h, w, n_tris=60, seed=11, max_size=5.0):
    """``tests/test_texture.py:63``, as ``test_sharded_bake_matches_single_device`` calls it."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(5, min(h, w) - 5, (n_tris, 2))
    offsets = rng.uniform(-max_size / 2, max_size / 2, (n_tris, 3, 2))
    verts = np.hstack([(centers[:, None, :] + offsets).reshape(-1, 2), rng.uniform(-1, 1, (n_tris * 3, 1))])
    return (verts.astype(np.float32), np.arange(n_tris * 3).reshape(n_tris, 3).astype(np.int32),
            rng.uniform(0, 1, (n_tris * 3, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    view, cams_j = view_inputs()
    tile = tile_inputs()
    verts, tris, colors = random_mesh(64, 64)
    bake = {"verts": verts, "tris": tris, "colors": colors, "h": 64, "w": 64, "bands": BANDS}
    work = tmp_path_factory.mktemp("worlds")
    worlds = {
        2: run_world(2, work, "parallel", {"view": view, "tile": tile, "bake": bake}),
        3: run_world(3, work, "parallel", {"view": view, "tile": tile, "bake": bake}),
        4: run_world(4, work, "parallel", {"view": view}),
    }
    return view, cams_j, tile, bake, worlds


def _port_steps(view):
    """The port's unsharded steps -> per step (metrics, state)."""
    n = view["params"]["means3D"].shape[0]
    step = make_batched_geometry_step({}, {}, render_fn, n, device=CPU)
    state, pri = _state(view["params"]), priors(view["priors"])
    images, cams = torch.as_tensor(view["images"]), convert.camera_from_numpy(_ns(view["cams"]), CPU)
    out = []
    for phase in view["phases"]:
        state, pri, m = step(state, images, cams, pri, [], LR, WEIGHTS, phase)
        out.append((m, state))
    return out


def _ns(d):
    import types

    return types.SimpleNamespace(**d)


@pytest.fixture(scope="module")
def port_steps(fx):
    return _port_steps(fx[0])


@pytest.mark.parametrize("world", [2, 3, 4])
def test_view_sharded_step_matches_unsharded(fx, port_steps, world):
    ranks = fx[4][world]
    assert int(ranks[0]["view/mesh"][0]) == {2: 2, 3: 2, 4: 4}[world]
    for i, (m, state) in enumerate(port_steps):
        r = ranks[0]
        for k in ("loss_total", "loss_im", "psnr"):
            np.testing.assert_allclose(r[f"view/{i}/{k}"], m[k].numpy(), rtol=1e-5, err_msg=(i, k))
        for k, val in state.params.items():
            np.testing.assert_allclose(r[f"view/{i}/params/{k}"], val.numpy(), rtol=1e-4, atol=1e-6, err_msg=(i, k))
        np.testing.assert_array_equal(r[f"view/{i}/radius"], state.max_2d_radius.numpy())


@pytest.mark.parametrize("world", [2, 3, 4])
def test_view_sharded_ranks_hold_the_same_bits(fx, world):
    """Parameters, Adam moments and radii after every step, bit for bit on
    every rank (on 3 ranks the third holds no views)."""
    ranks = fx[4][world]
    assert [int(r["view/mesh"][1]) for r in ranks] == {2: [4, 4], 3: [4, 4, 0], 4: [2, 2, 2, 2]}[world]
    for r in ranks:  # ``replicated``: rank 0's copy everywhere
        np.testing.assert_array_equal(r["view/replicated"], np.zeros(3, np.float32))
    keys = [k for k in ranks[0] if k.count("/") >= 2 and k.split("/")[2] in ("params", "mu", "nu", "radius",
                                                                             "loss_total", "psnr")]
    assert len(keys) > 20
    for r in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


@pytest.fixture(scope="module")
def jax_sharded(fx):
    """JAX's view-sharded steps on ``make_view_mesh(8)``, Pallas in interpret mode."""
    from topo4d_tpu.rasterizer.pallas import render_gaussians_pallas

    view, cams = fx[0], fx[1]
    p = {k: jnp.asarray(v) for k, v in view["params"].items()}
    pr = view["priors"]
    priors_j = JPriors(
        neighbor_indices=jnp.asarray(pr["neighbor_indices"]), neighbor_dist=jnp.asarray(pr["neighbor_dist"]),
        iso_w=jnp.asarray(pr["iso_w"]), rig_w=jnp.asarray(pr["rig_w"]), rot_w=jnp.asarray(pr["rot_w"]),
        init_scale=jnp.asarray(pr["init_scale"]),
        temporal=JTemporal(**{k: jnp.asarray(v) for k, v in pr["temporal"].items()}),
        cos_init=jnp.asarray(pr["cos_init"]),
    )
    mesh = j_view_mesh(8)
    step = j_batched_step({}, {}, lambda rv, cam: render_gaussians_pallas(rv, cam, max_span=4, interpret=True),
                          mesh=mesh)
    state = JState(params=p, opt=j_adam_init(p), max_2d_radius=jnp.zeros(p["means3D"].shape[0]))
    lr = {k: jnp.asarray(v, jnp.float32) for k, v in LR.items()}
    w = {k: jnp.asarray(v, jnp.float32) for k, v in WEIGHTS.items()}
    out = []
    with mesh:
        images, cams_s = j_shard(mesh, jnp.asarray(view["images"])), j_shard(mesh, cams)
        state, priors_j = j_replicated(mesh, state), j_replicated(mesh, priors_j)
        for phase in view["phases"]:
            state, priors_j, m = step(state, images, cams_s, priors_j, [], lr, w, phase)
            out.append(({k: float(v) for k, v in m.items()}, {k: np.asarray(v) for k, v in state.params.items()}))
    return out


@pytest.mark.parametrize("world", [2, 3, 4])
def test_view_sharded_step_matches_jax_sharded(fx, jax_sharded, world):
    r = fx[4][world][0]
    for i, (m, params) in enumerate(jax_sharded):
        for k in ("loss_total", "loss_im", "psnr"):
            np.testing.assert_allclose(r[f"view/{i}/{k}"], m[k], rtol=1e-5, err_msg=(i, k))
        for k, val in params.items():
            np.testing.assert_allclose(r[f"view/{i}/params/{k}"], val, rtol=1e-4, atol=1e-6, err_msg=(i, k))


@pytest.mark.parametrize("world", [2, 3, 4])
def test_sharded_gradient_equals_mean_of_per_view_gradients(fx, world):
    """``tests/test_parallel.py:95`` on the sharded loss: its gradient,
    summed over the ranks, is the mean of the single views' gradients."""
    from topo4d_tpu_torch.losses.image import photometric_loss

    view = fx[0]
    cams = convert.camera_from_numpy(_ns(view["cams"]), CPU)
    grads = []
    for i in range(view["grad_views"]):
        p = {k: torch.as_tensor(v).requires_grad_(True) for k, v in view["params"].items()}
        out = render_fn(activate_params(p), cams[i])
        im = torch.exp(p["cam_m"][i])[:, None, None] * out.image + p["cam_c"][i][:, None, None]
        grads.append(torch.autograd.grad(photometric_loss(im, torch.as_tensor(view["images"][i])), p["means3D"])[0])
    want = torch.mean(torch.stack(grads), dim=0).numpy()
    for r in fx[4][world]:
        np.testing.assert_allclose(r["view/grad_means3D"], want, rtol=1e-4, atol=1e-7)


def test_world_of_one_equals_unsharded_step_bit_for_bit(fx, port_steps, tmp_path):
    """A one-process gloo world: the mesh path's all-reduces are the
    identity, so its steps equal the unsharded step's bit for bit."""
    view = fx[0]
    dist.init_process_group("gloo", init_method="file://" + str(tmp_path / "rendezvous"), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        n = view["params"]["means3D"].shape[0]
        step = make_batched_geometry_step({}, {}, render_fn, n, device=CPU, mesh=make_view_mesh(1, device=CPU))
        state, pri = _state(view["params"]), priors(view["priors"])
        images, cams = torch.as_tensor(view["images"]), convert.camera_from_numpy(_ns(view["cams"]), CPU)
        for phase, (m_want, want) in zip(view["phases"], port_steps):
            state, pri, m = step(state, images, cams, pri, [], LR, WEIGHTS, phase)
            for k in ("loss_total", "loss_im", "psnr"):
                assert torch.equal(m[k], m_want[k]), k
            for k in want.params:
                assert torch.equal(state.params[k], want.params[k]), k
                assert torch.equal(state.opt.nu[k], want.opt.nu[k]), k
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the tile-sharded render
# ---------------------------------------------------------------------------


def _single_render(case):
    cam = convert.camera_from_numpy(_ns(case["cam"]), CPU)
    params = {k: torch.as_tensor(v).requires_grad_(True) for k, v in case["params"].items()}
    binning = None
    if case["compact"]:
        b = binning_for(activate_params(params), cam, max_span=4, with_static=True)
        binning = attach_compact(b, int((b.tile_count > 0).sum()) + 1)
        assert binning.compact is not None and binning.compact.ids.shape[0] < b.tile_count.shape[0]
    r = render_gaussians(activate_params(params), cam, bg=torch.as_tensor(case["bg"]), max_span=4, binning=binning)
    loss = torch.mean(torch.abs(r.image - torch.as_tensor(case["target"]))) + case["alpha_w"] * torch.mean(r.alpha)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return r, {k: g for k, g in zip(params, grads) if g is not None}


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("case", ["full", "compact"])
def test_tile_sharded_render_equals_single_render(fx, world, case):
    """Each rank's assembled render and gradients equal the single
    render's in value (one writer per tile, one owner per packed entry)."""
    r, grads = _single_render(fx[2][case])
    for rank in fx[4][world]:
        for k in ("image", "depth", "alpha"):
            np.testing.assert_array_equal(rank[f"tile/{case}/{k}"], getattr(r, k).detach().numpy(), err_msg=k)
        assert int(rank[f"tile/{case}/overflow"]) == 0
        assert {k.split("/")[-1] for k in rank if k.startswith(f"tile/{case}/grad/")} == set(grads)
        for k, g in grads.items():
            np.testing.assert_array_equal(rank[f"tile/{case}/grad/{k}"], g.numpy(), err_msg=k)


@pytest.mark.parametrize("case", ["full", "compact"])
def test_tile_sharded_render_matches_jax(fx, case):
    """Against ``render_gaussians_pallas_tile_sharded`` on 8 devices, Pallas
    in interpret mode: pixels at ``tests/test_parallel.py:232-238``'s
    tolerance, gradients at the port's against JAX (module docstring)."""
    from jax.sharding import Mesh

    from topo4d_tpu.rasterizer.pallas import attach_compact as j_attach
    from topo4d_tpu.rasterizer.pallas import binning_for as j_binning_for

    c = fx[2][case]
    cam = j_cam(c["cam"]["width"], c["cam"]["height"])
    mesh = Mesh(np.array(jax.devices()[:8]), ("tile",))
    params = {k: jnp.asarray(v) for k, v in c["params"].items()}
    binning = None
    if c["compact"]:
        b = j_binning_for(j_activate(params), cam, max_span=4, with_static=True)
        binning = j_attach(b, int(np.sum(np.asarray(b.tile_count) > 0)) + 1)
    target, bg = jnp.asarray(c["target"]), jnp.asarray(c["bg"])

    def render(p):
        return render_gaussians_pallas_tile_sharded(j_activate(p), cam, mesh, bg=bg, max_span=4, chunk=128,
                                                    interpret=True, binning=binning)

    def loss(p):
        out = render(p)
        return jnp.mean(jnp.abs(out.image - target)) + c["alpha_w"] * jnp.mean(out.alpha), out

    (_, want), g_want = jax.value_and_grad(loss, has_aux=True)(params)
    got = fx[4][2][0]
    for k in ("image", "depth", "alpha"):
        np.testing.assert_allclose(got[f"tile/{case}/{k}"], np.asarray(getattr(want, k)), rtol=1e-5, atol=1e-6)
    for k in g_want:
        a = np.asarray(g_want[k])
        b = got.get(f"tile/{case}/grad/{k}", np.zeros_like(a))  # a parameter the render does not read
        scale = np.maximum(np.abs(a).max(), 1e-8)
        np.testing.assert_allclose(b / scale, a / scale, rtol=2e-3, atol=2e-5, err_msg=k)


# ---------------------------------------------------------------------------
# the sharded bake
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("bands", BANDS)
def test_sharded_bake_bit_for_bit(fx, world, bands):
    bake = fx[3]
    want = bake_texture_tiled(bake["verts"], bake["tris"], bake["colors"], 64, 64, device=CPU).numpy()
    assert (want > 0).any()
    for rank in fx[4][world]:
        got = rank[f"bake/{bands}"]
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("bands", BANDS)
def test_sharded_bake_matches_jax(fx, bands):
    bake = fx[3]
    want = j_bake_sharded(bake["verts"], bake["tris"], bake["colors"], 64, 64, window=8, bands=bands)
    got = fx[4][3][0][f"bake/{bands}"]
    differ = ~np.isclose(got, want, **TOL_BAKE).all(-1)
    assert np.all(want[differ] == 0) and np.all(got[differ].max(-1) > 0)
    assert differ.mean() < 0.01
