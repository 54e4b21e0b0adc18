"""Entry points (the counterparts of the JAX package's
``__graft_entry__.py``).

- ``entry(device)`` -> (fn, args): one forward step of the production
  renderer plus the photometric loss at the reference's geometry scale
  (8,280 mesh-bound Gaussians, view 0 at 375x512, ``max_span`` 2, a zero
  target). On the card ``fn`` launches K1 once and K5 once, at (15, 512,
  375); on the CPU their plain versions.
- ``dryrun_multichip(n_devices, device)``: the multi-rank paths once each
  over a world of ``n_devices`` spawned ranks (NCCL on ``cuda:0 .. n-1``,
  or gloo with ``device="cpu"``): the batched training step over the view
  mesh with the tiled renderer and with the kernels, the tile-sharded
  render of one view (forward and backward), a dense texture step through a
  frozen binning and compact tiles below the occupancy, the trainer's dense
  render under ``texture.tile_shard`` against one rank's step, and the
  sharded bake against one rank's canvas. Every loss and gradient must be
  finite; rank 0's results come back by part.

    python -c "from topo4d_tpu_torch.entry import dryrun_multichip; dryrun_multichip(2, 'cpu')"
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from topo4d_tpu_torch.device import resolve_device


def entry(device="cuda") -> Tuple[Callable, tuple]:
    """(fn, (params, gt)): ``fn(params, gt)`` renders view 0 of
    ``testing.make_head_fixture`` from the raw ``params`` through the blend
    (``max_span`` 2) and returns the photometric loss against ``gt``, a
    zero image (``__graft_entry__.py:17``)."""
    from topo4d_tpu_torch.core.gaussian import activate_params
    from topo4d_tpu_torch.losses.image import photometric_loss
    from topo4d_tpu_torch.rasterizer.render import render_gaussians
    from topo4d_tpu_torch.testing import make_head_fixture

    dev = resolve_device(device)
    params_np, cams, _ = make_head_fixture(device=dev)
    cam0 = cams[0]
    params = {k: torch.as_tensor(v, device=dev) for k, v in params_np.items()}
    gt = torch.zeros((3, cam0.height, cam0.width), dtype=torch.float32, device=dev)

    def fn(params, gt):
        return photometric_loss(render_gaussians(activate_params(params), cam0, max_span=2).image, gt)

    return fn, (params, gt)


def dryrun_inputs(num_views: int, device="cuda") -> Dict[str, object]:
    """The inputs of the dryrun's batched step (``__graft_entry__.py:77-161``):
    the 12x12 head grid, ``num_views`` views at 64x48, the flatten sets on
    one set of dihedral quadruples and one umbrella table, the temporal and
    one-ring priors, a constraint on the first 8 means, lr 1e-4, the
    reference's weights, and seeded target images."""
    from topo4d_tpu_torch.core.quaternion import quat_normalize
    from topo4d_tpu_torch.losses.flatten import (
        build_dihedral_quadruples,
        build_fused_flatten,
        build_umbrella_flatten,
        dihedral_cos,
    )
    from topo4d_tpu_torch.losses.temporal import make_temporal_priors
    from topo4d_tpu_torch.opt.adam import adam_init
    from topo4d_tpu_torch.opt.constraints import ScatterConstraint, compile_dense_constraints
    from topo4d_tpu_torch.opt.step import HARD_FLATTEN_KEYS, SOFT_FLATTEN_KEYS, GeometryPriors, TrainState
    from topo4d_tpu_torch.testing import make_head_fixture
    from topo4d_tpu_torch.topology.adjacency import build_one_ring, triangulate_faces

    dev = resolve_device(device)
    params_np, cams, (verts, faces) = make_head_fixture(rows=12, cols=12, num_views=num_views, width=64, height=48,
                                                        device=dev)
    n = verts.shape[0]
    params = {k: torch.as_tensor(v, device=dev) for k, v in params_np.items()}
    ring = build_one_ring(verts, faces)
    quads = build_dihedral_quadruples(np.asarray(triangulate_faces(faces)))
    umb = build_umbrella_flatten(ring.ragged, n)
    quadruples = {k: quads for k in ("flat", "flat_lip_bottom", "flat_lip", "flat_mouth", "flat_lid_top",
                                     "flat_lid_bottom")}
    umbrellas = {k: umb for k in ("flat_eye", "flat_lip_socket", "flat_face_bottom")}

    def tp(a):  # one-ring tables as (K, N)
        return torch.as_tensor(np.ascontiguousarray(np.asarray(a).T), device=dev)

    nbr = tp(ring.indices).to(torch.int64)
    fused = build_fused_flatten(quadruples, HARD_FLATTEN_KEYS, SOFT_FLATTEN_KEYS)
    priors = GeometryPriors(
        neighbor_indices=nbr, neighbor_dist=tp(ring.dist), iso_w=tp(ring.weight), rig_w=tp(ring.weight),
        rot_w=tp(ring.weight), init_scale=torch.full((n,), 0.05, device=dev),
        temporal=make_temporal_priors(params["means3D"], quat_normalize(params["unnorm_rotations"]), nbr),
        cos_init=dihedral_cos(params["means3D"], fused.quads)[fused.num_hard:].detach(),
    )
    state = TrainState(params=params, opt=adam_init(params), max_2d_radius=torch.zeros(n, device=dev))
    constraints = compile_dense_constraints(
        params_np, [ScatterConstraint(param="means3D", idx=np.arange(8), value=params_np["means3D"][:8])], dev
    )
    weights = {
        "im": 1.0, "rigid": 3.5, "rot": 20.0, "iso": 20.0, "flat": 2e-4, "flat_lip_bottom": 2e-4,
        "flat_lid_top": 2e-4, "flat_lid_bottom": 1e-2, "flat_lip": 1e-4, "flat_mouth": 1e-3, "flat_eye": 1e4,
        "flat_face_bottom": 1e3, "flat_lip_socket": 1e3,
    }
    images = np.random.default_rng(0).uniform(0, 1, (num_views, 3, 48, 64)).astype(np.float32)
    return {
        "quadruples": quadruples, "umbrellas": umbrellas, "num_vertices": n, "state": state, "priors": priors,
        "constraints": constraints, "lr": {k: 1e-4 for k in params}, "weights": weights,
        "images": torch.as_tensor(images, device=dev), "cams": cams,
    }


def dryrun_multichip(n_devices: int, device="cuda") -> Dict[str, float]:
    """The multi-rank paths over ``n_devices`` spawned ranks
    (``__graft_entry__.py:43-357``) -> rank 0's results by part.

    ``device="cuda"``: one rank per card on ``cuda:0 .. n-1`` over NCCL
    (raises when fewer cards are present); ``device="cpu"``: gloo. Each rank
    prints nothing but rank 0, which prints one line per part. Raises if a
    rank fails a check (every loss and gradient finite, the dense step's
    overflow counted, the tile-sharded dense step equal to one rank's, the
    sharded bake equal to one rank's canvas bit for bit).
    """
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    n = int(n_devices)
    if dev.type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"dryrun_multichip({n}): {torch.cuda.device_count()} card(s) present, {n} needed")
    from topo4d_tpu_torch.parallel.multihost import free_port

    with tempfile.TemporaryDirectory(prefix="topo4d_dryrun_") as path:
        mp.start_processes(_dryrun_rank, args=(n, free_port(), dev.type, path), nprocs=n, start_method="spawn")
        return torch.load(os.path.join(path, "rank0.pt"))


def _dryrun_rank(rank: int, n: int, port: int, kind: str, path: str) -> None:
    """One rank: joins the world of ``n`` at ``localhost:port`` (NCCL on
    ``cuda:<rank>``, gloo on the CPU; a world of one too, which
    ``initialize_multihost`` leaves alone), runs the parts, and rank 0
    saves its results under ``path``."""
    import datetime

    import torch.distributed as dist

    if kind == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=n, rank=rank, device_id=dev)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)  # the ranks share the host's cores
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=n, rank=rank,
                                timeout=datetime.timedelta(seconds=300))
    try:
        out = _dryrun_parts(n, dev, rank)
        if rank == 0:
            torch.save(out, os.path.join(path, "rank0.pt"))
    finally:
        dist.destroy_process_group()


def _finite(name: str, *xs) -> None:
    for x in xs:
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"dryrun_multichip: non-finite {name}")


def _dryrun_parts(n: int, dev: torch.device, rank: int) -> Dict[str, float]:
    from topo4d_tpu_torch.config import Config
    from topo4d_tpu_torch.core.gaussian import activate_params
    from topo4d_tpu_torch.opt.adam import adam_init
    from topo4d_tpu_torch.parallel.batched import make_batched_geometry_step
    from topo4d_tpu_torch.parallel.mesh import make_view_mesh, replicated, shard_view_batch
    from topo4d_tpu_torch.pipeline.trainer import make_dense_render_fn
    from topo4d_tpu_torch.rasterizer.render import (
        attach_compact,
        binning_for,
        render_gaussians,
        render_gaussians_tile_sharded,
    )
    from topo4d_tpu_torch.rasterizer.tiled import render_gaussians_tiled
    from topo4d_tpu_torch.testing import make_camera_ring, make_synthetic_camera
    from topo4d_tpu_torch.texture.bake_tiled import bake_texture_sharded, bake_texture_tiled, process_uv
    from topo4d_tpu_torch.texture.dense import TextureState, dense_rendervars, make_texture_step

    def say(msg: str) -> None:
        if rank == 0:
            print(f"dryrun_multichip({n}): {msg}", flush=True)

    inp = dryrun_inputs(n, dev)
    params, images, cams = inp["state"].params, inp["images"], inp["cams"]
    mesh = make_view_mesh(n, device=dev)
    images_l, cams_l = shard_view_batch(mesh, images), shard_view_batch(mesh, cams)
    state, priors = replicated(mesh, inp["state"]), replicated(mesh, inp["priors"])
    args = (inp["constraints"], inp["lr"], inp["weights"], "track")
    out: Dict[str, float] = {}

    # 1-2: the batched step over the view mesh, the tiled renderer, then the kernels
    for name, render_fn in (
        ("tiled_step", lambda rv, cam: render_gaussians_tiled(rv, cam, max_span=4, capacity=128)),
        ("kernel_step", lambda rv, cam: render_gaussians(rv, cam, max_span=4)),
    ):
        step = make_batched_geometry_step(inp["quadruples"], inp["umbrellas"], render_fn, inp["num_vertices"],
                                          device=dev, mesh=mesh)
        new_state, _, m = step(state, images_l, cams_l, priors, *args)
        _finite(f"{name} loss", m["loss_total"])
        _finite(f"{name} parameters", *new_state.params.values())
        out[name] = float(m["loss_total"])
        if name == "tiled_step":
            out["tiled_step_psnr"] = float(m["psnr"])
            say(f"OK, loss {out[name]:.5f}, psnr {out['tiled_step_psnr']:.2f}")
        else:
            say(f"sharded step with the blend kernels OK, loss {out[name]:.5f}")

    # 3: one view's tiles sharded over the ranks, forward and backward
    cam0 = cams[0]
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    r = render_gaussians_tile_sharded(activate_params(p), cam0, max_span=4)
    tl = torch.mean(torch.abs(r.image - images[0]))
    (g_means,) = torch.autograd.grad(tl, p["means3D"])
    _finite("tile-sharded render", tl, g_means)
    out["tile_sharded_render"] = float(tl.detach())
    say(f"tile-sharded render OK, loss {out['tile_sharded_render']:.5f}")

    # 4: a dense texture step, frozen binning with static rows, capacity 8 below the occupancy
    dense = {
        "dense_rgb_colors": params["rgb_colors"], "dense_unnorm_rotations": params["unnorm_rotations"],
        "dense_logit_opacities": params["logit_opacities"], "dense_log_scales": params["log_scales"],
    }
    means = params["means3D"]
    binning = binning_for(dense_rendervars(dense, means), cam0, max_span=4, with_static=True)
    tex_step = make_texture_step(lambda rv, c, b: render_gaussians(rv, c, max_span=4, binning=b, tile_capacity=8))
    lr_d = {k: 1e-3 for k in dense}
    w_d = {"im": 1.0, "soft_color": 0.02}
    tex_state, m = tex_step(TextureState(params=dense, opt=adam_init(dense)), means, images[0], cams[:1], 0,
                            dense["dense_rgb_colors"], (), lr_d, w_d, binning, with_metrics=False)
    _finite("dense texture step", m["loss_total"], *tex_state.params.values())
    overflow = int(m["num_tile_overflow"])
    if overflow <= 0:
        raise AssertionError("dryrun_multichip: capacity 8 below the occupancy dropped no tile")
    out["dense_step"], out["dense_step_overflow"] = float(m["loss_total"]), float(overflow)
    say(f"dense texture step OK, loss {out['dense_step']:.5f} (deliberate under-capacity counted: {overflow} tiles)")

    # 5: the trainer's dense render under texture.tile_shard against one rank's step
    cfg_sh = Config()
    cfg_sh.raster.backend = "pallas"
    cfg_sh.raster.max_span = 4
    cfg_sh.texture.tile_shard = True
    cfg_sh.texture.split_pack = True
    cfg_1d = dataclasses.replace(cfg_sh, texture=dataclasses.replace(cfg_sh.texture, tile_shard=False))
    camd = make_synthetic_camera(width=128, height=96, device=dev)  # 8 x 6 = 48 tiles
    camsd = make_camera_ring(1, width=128, height=96, device=dev)  # the same pose, batched
    bin_d = binning_for(dense_rendervars(dense, means), camd, max_span=4, with_static=True)
    occ = int(torch.sum(bin_d.tile_count > 0))
    t_d = int(bin_d.tile_count.shape[0])
    if not occ + 1 < t_d:
        raise AssertionError(f"dryrun_multichip: compact mode would not engage ({occ} of {t_d} tiles)")
    bin_d = attach_compact(bin_d, occ + 1)
    gtd = torch.as_tensor(np.random.default_rng(7).uniform(0, 1, (3, 96, 128)).astype(np.float32), device=dev)
    runs = {}
    for name, cfg in (("dense_tile_sharded_step", cfg_sh), ("dense_single_rank_step", cfg_1d)):
        step_fn = make_texture_step(make_dense_render_fn(cfg, dev))
        runs[name] = step_fn(TextureState(params=dense, opt=adam_init(dense)), means, gtd, camsd, 0,
                             dense["dense_rgb_colors"], (), lr_d, w_d, bin_d, with_metrics=False)
        out[name] = float(runs[name][1]["loss_total"])
    (st_sh, m_sh), (st_1d, _) = runs["dense_tile_sharded_step"], runs["dense_single_rank_step"]
    l_sh, l_1d = out["dense_tile_sharded_step"], out["dense_single_rank_step"]
    if not (np.isfinite(l_sh) and abs(l_sh - l_1d) <= 1e-6 * max(abs(l_1d), 1.0)):
        raise AssertionError(f"dryrun_multichip: tile-sharded dense loss {l_sh} against one rank's {l_1d}")
    if int(m_sh["num_tile_overflow"]) != 0:
        raise AssertionError("dryrun_multichip: the tile-sharded dense step dropped tiles")
    for k in dense:
        torch.testing.assert_close(st_sh.params[k], st_1d.params[k], rtol=1e-5, atol=1e-7, msg=k)
    say(f"dense tile-sharded step OK, matches one rank (loss {l_sh:.5f}, compact {occ + 1}/{t_d} tiles, split-pack on)")

    # 6: the sharded bake of a tiny canvas, bit for bit against one rank's
    rngb = np.random.default_rng(3)
    uv = rngb.uniform(0.05, 0.95, (60, 2))
    btris = rngb.integers(0, 60, (40, 3)).astype(np.int32)
    bcolors = rngb.uniform(0, 1, (60, 3)).astype(np.float32)
    uv_px = process_uv(uv, 64, 64)
    uv_px[:, 2] = rngb.uniform(0, 1, 60)
    single = bake_texture_tiled(uv_px, btris, bcolors, 64, 64, device=dev)
    sharded = bake_texture_sharded(uv_px, btris, bcolors, 64, 64, bands=2 * n, device=dev)
    if not torch.equal(single, sharded):
        raise AssertionError("dryrun_multichip: sharded bake != one rank's canvas")
    out["sharded_bake_sum"] = float(torch.sum(sharded))
    say("sharded bake OK, bitwise equal")
    return out
