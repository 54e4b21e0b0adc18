"""Spawned gloo worlds for the multi-rank tests of ``topo4d_tpu_torch``.

``run_world(world, workdir, task, inputs)`` starts ``world`` processes with
the spawn start method, joins them in a gloo process group through a
``file://`` rendezvous in ``workdir`` (no port for parallel test workers to
race for), runs ``TASKS[task](rank, world, inputs, path)`` on each and
returns each rank's result dict (NumPy arrays, written as ``rank<r>.npz``).
A rank's exception fails the spawn. The inputs travel as a pickle of NumPy
arrays. This module imports no JAX: the children import it to find their
task.
"""

from __future__ import annotations

import datetime
import os
import pickle
import types

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

CPU = "cpu"


def run_world(world: int, workdir, task: str, inputs) -> list:
    path = os.path.join(str(workdir), f"{task}_{world}")
    os.makedirs(path)
    with open(os.path.join(path, "inputs.pkl"), "wb") as fh:
        pickle.dump(inputs, fh)
    mp.spawn(_entry, args=(world, path, task), nprocs=world, join=True)
    out = []
    for r in range(world):
        with np.load(os.path.join(path, f"rank{r}.npz")) as d:
            out.append({k: d[k] for k in d.files})
    return out


def _entry(rank: int, world: int, path: str, task: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(path, "rendezvous"), rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=120),
    )
    try:
        with open(os.path.join(path, "inputs.pkl"), "rb") as fh:
            inputs = pickle.load(fh)
        out = TASKS[task](rank, world, inputs, path)
        np.savez(os.path.join(path, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def camera(c) -> "Camera":
    from topo4d_tpu_torch import convert

    return convert.camera_from_numpy(types.SimpleNamespace(**c), CPU)


def priors(p):
    from topo4d_tpu_torch import convert

    ns = types.SimpleNamespace(**p)
    ns.temporal = types.SimpleNamespace(**p["temporal"])
    return convert.priors_from_numpy(ns, CPU)


def _state(params_np):
    from topo4d_tpu_torch import convert
    from topo4d_tpu_torch.opt.adam import adam_init
    from topo4d_tpu_torch.opt.step import TrainState

    p = convert.params_from_numpy(params_np, CPU)
    return TrainState(params=p, opt=adam_init(p), max_2d_radius=torch.zeros(p["means3D"].shape[0]))


def render_fn(rv, cam):
    from topo4d_tpu_torch.rasterizer.render import render_gaussians

    return render_gaussians(rv, cam, max_span=4)


# ---------------------------------------------------------------------------
# tasks
# ---------------------------------------------------------------------------


def view_sharded(rank, world, inp, path):
    """``inp["steps"]`` view-sharded batched steps from one state (each
    step's loss, PSNR, parameters, Adam moments and radii), and the
    gradient of the sharded loss on the first ``inp["grad_views"]`` views,
    summed over the ranks."""
    from topo4d_tpu_torch.core.gaussian import activate_params
    from topo4d_tpu_torch.parallel.batched import make_batched_geometry_step
    from topo4d_tpu_torch.parallel.mesh import all_reduce_flat, make_view_mesh, mesh_size, replicated, shard_view_batch
    from topo4d_tpu_torch.parallel.sharded import make_sharded_view_loss

    images, cams = torch.as_tensor(inp["images"]), camera(inp["cams"])
    v = images.shape[0]
    mesh = make_view_mesh(mesh_size(v, world), device=CPU)
    n = inp["params"]["means3D"].shape[0]
    step = make_batched_geometry_step({}, {}, render_fn, n, device=CPU, mesh=mesh)
    state, pri = _state(inp["params"]), priors(inp["priors"])
    images_l, cams_l = shard_view_batch(mesh, images), shard_view_batch(mesh, cams)
    out = {"mesh": np.array([mesh.size, images_l.shape[0]])}
    out["replicated"] = replicated(mesh, {"x": torch.full((3,), float(rank))})["x"].numpy()
    for i, phase in enumerate(inp["phases"]):
        state, pri, m = step(state, images_l, cams_l, pri, [], inp["lr"], inp["weights"], phase)
        for k in ("loss_total", "loss_im", "psnr"):
            out[f"{i}/{k}"] = m[k].numpy()
        for k, val in state.params.items():
            out[f"{i}/params/{k}"] = val.numpy()
            out[f"{i}/mu/{k}"] = state.opt.mu[k].numpy()
            out[f"{i}/nu/{k}"] = state.opt.nu[k].numpy()
        out[f"{i}/radius"] = state.max_2d_radius.numpy()

    gv = inp["grad_views"]
    gmesh = make_view_mesh(mesh_size(gv, world), device=CPU)
    params = {k: torch.as_tensor(val).requires_grad_(True) for k, val in inp["params"].items()}
    loss, _, _ = make_sharded_view_loss(render_fn, gmesh)(
        params, activate_params(params), shard_view_batch(gmesh, images[:gv]), shard_view_batch(gmesh, cams[:gv])
    )
    g = torch.autograd.grad(loss, params["means3D"]) if loss.requires_grad else (torch.zeros_like(params["means3D"]),)
    out["grad_means3D"] = all_reduce_flat([g[0]])[0].numpy()
    return out


def tile_sharded(rank, world, inp, path):
    """The tile-sharded render of each case (full canvas; a frozen compact
    binning): forward image, depth and alpha, and the gradient of the
    case's loss."""
    from topo4d_tpu_torch.core.gaussian import activate_params
    from topo4d_tpu_torch.rasterizer.render import attach_compact, binning_for, render_gaussians_tile_sharded

    out = {}
    for name, case in inp.items():
        cam, bg = camera(case["cam"]), torch.as_tensor(case["bg"])
        params = {k: torch.as_tensor(val).requires_grad_(True) for k, val in case["params"].items()}
        binning = None
        if case["compact"]:
            b = binning_for(activate_params(params), cam, max_span=4, with_static=True)
            binning = attach_compact(b, int((b.tile_count > 0).sum()) + 1)
        r = render_gaussians_tile_sharded(activate_params(params), cam, bg=bg, max_span=4, binning=binning)
        loss = torch.mean(torch.abs(r.image - torch.as_tensor(case["target"]))) + case["alpha_w"] * torch.mean(r.alpha)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        out[f"{name}/image"], out[f"{name}/depth"] = r.image.detach().numpy(), r.depth.detach().numpy()
        out[f"{name}/alpha"], out[f"{name}/overflow"] = r.alpha.detach().numpy(), r.num_overflow.numpy()
        for k, g in zip(params, grads):
            if g is not None:
                out[f"{name}/grad/{k}"] = g.numpy()
    return out


def bake_sharded(rank, world, inp, path):
    from topo4d_tpu_torch.texture.bake_tiled import bake_texture_sharded

    return {
        str(b): bake_texture_sharded(inp["verts"], inp["tris"], inp["colors"], inp["h"], inp["w"], bands=b,
                                     device=CPU).numpy()
        for b in inp["bands"]
    }


def parallel(rank, world, inp, path):
    """One world for every check of ``tests/test_torch_parallel.py``."""
    out = {}
    for name, task in (("view", view_sharded), ("tile", tile_sharded), ("bake", bake_sharded)):
        if name in inp:
            out.update({f"{name}/{k}": val for k, val in task(rank, world, inp[name], path).items()})
    return out


def trainer_runs(rank, world, inp, path):
    """Fit ``inp["batched"]``'s sequence with ``Trainer.run`` (every rank
    handed its own output directory, so that a file rank 1 wrote shows), run
    it again with resume on rank 0's directory (a no-op), then resume with
    rank 1's directory elsewhere (every rank raises); then ``inp["dense"]``'s
    parity-mode sequence with a tile-sharded dense phase."""
    from topo4d_tpu_torch.pipeline.trainer import Trainer

    case = inp["batched"]
    out_dir = os.path.join(case["out"], f"rank{rank}") if rank else case["out"]
    cfg, source, params, statics = small_run(case, out_dir)
    tr = Trainer(cfg, source, params, statics, device=CPU)
    tr.run(resume=False)
    out = {f"params/{k}": v.numpy() for k, v in tr.state.params.items()}
    out.update({f"mu/{k}": v.numpy() for k, v in tr.state.opt.mu.items()})
    out.update({f"nu/{k}": v.numpy() for k, v in tr.state.opt.nu.items()})
    out["mesh"] = np.array(tr.mesh.size if tr.mesh is not None else 0)
    out["segments"] = np.array(len(tr.geo_segments))
    out["rows"] = np.array(json_rows(tr.metrics_log))

    cfg, source, params, statics = small_run(case, case["out"])
    again = Trainer(cfg, source, params, statics, device=CPU)
    steps = []
    again.batched_step = lambda *a, **k: steps.append(1)  # records a step: none may run
    again.run(resume=True)
    out["resumed_steps"] = np.array(len(steps))
    out["resumed_equal"] = np.array(all(torch.equal(again.state.params[k], tr.state.params[k]) for k in params))

    cfg2, source2, _, _ = small_run(case, case["out"] if rank == 0 else os.path.join(case["out"], "elsewhere"))
    try:
        Trainer(cfg2, source2, params, statics, device=CPU).run(resume=True)
        out["mismatch"] = np.array("")
    except RuntimeError as exc:
        out["mismatch"] = np.array(str(exc))

    cfg, source, params, statics = small_run(inp["dense"], inp["dense"]["out"])
    tr = Trainer(cfg, source, params, statics, device=CPU)
    tr.run(resume=False)
    out.update({f"dense/{k}": v.numpy() for k, v in tr.texture_state.params.items()})
    out.update({f"dense/geometry/{k}": v.numpy() for k, v in tr.state.params.items()})
    return out


def json_rows(rows):
    import json

    return [json.dumps(r, sort_keys=True) for r in rows]


def small_run(inp, out_dir):
    """A small sequence for ``Trainer.run``: the port's own scene (a grid
    head, its dense mesh when ``texture`` is given) and synthetic source,
    built from ``inp``'s seed, sizes and config sections."""
    from topo4d_tpu_torch.config import Config
    from topo4d_tpu_torch.pipeline.data import SyntheticSequence
    from topo4d_tpu_torch.pipeline.scene import build_scene
    from topo4d_tpu_torch.testing import grid_uvs, make_camera_ring, make_grid_mesh, make_synthetic_regions
    from topo4d_tpu_torch.topology.obj_io import MeshObj

    rows = cols = inp["grid"]
    verts, faces = make_grid_mesh(rows, cols, extent=0.5)
    mesh = MeshObj(vertices=verts, uvs=grid_uvs(rows, cols), faces=faces, uv_faces=[list(f) for f in faces])
    cfg = Config()
    cfg.data.output_dir = str(out_dir)
    cfg.data.use_mask = False
    cfg.data.log_views = []
    for section in ("data", "schedule", "raster", "texture"):
        for k, val in inp.get(section, {}).items():
            setattr(getattr(cfg, section), k, val)
    params, statics = build_scene(mesh, make_synthetic_regions(verts.shape[0], faces), cfg, num_views=inp["views"])
    rng = np.random.default_rng(inp["seed"])
    n = verts.shape[0]
    params = dict(params, log_scales=(params["log_scales"] + rng.uniform(-0.3, 0.3, (n, 3))).astype(np.float32))
    truth = dict(params, rgb_colors=rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32))
    cams = make_camera_ring(inp["views"], inp["w"], inp["h"], 2.0, device=CPU)
    source = SyntheticSequence(params=truth, cameras=cams, num_frames=cfg.schedule.frame_num)
    return cfg, source, params, statics


TASKS = {"parallel": parallel, "trainer_runs": trainer_runs}
