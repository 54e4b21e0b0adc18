#!/usr/bin/env python3
"""The port's multi-rank paths on several cards of one host, over NCCL.

    torchrun --nproc_per_node=N chip_multicard.py [--device cpu] [--small]

Each rank joins through ``initialize_multihost`` (torchrun's variables:
``cuda:<LOCAL_RANK>`` and NCCL; ``--device cpu``: gloo) and runs, every rank
in step, at ``chip_smoke.py``'s full widths (``--small``: its rehearsal
sizes, for a run on the CPU):

1. the view-sharded batched ``Trainer.run`` of ``chip_smoke.py`` phase 8's
   configuration (24 views, 10 + 46 batched steps, geometry only): K1/K2
   24 / N times and K5 48 / N times per step on each rank, no plain
   version; every rank's parameters, Adam moments and radii equal to rank
   0's after each step (SHA-256); rank 0 alone writes; a resumed run
   launches nothing;
2. three sharded steps from the run's state against three single-rank
   steps on rank 0 (the others wait), in turns (one rank, N ranks, N
   ranks, one rank): loss rtol 1e-4, every leaf within 2 * lr * steps;
3. three tile-sharded dense steps at 3840x2160 (compact, then the full
   canvas) against rank 0's single-rank steps, every metric row and
   parameter equal; ms per dense step of both; each all-reduce's bytes and
   its time alone;
4. the sharded 8192x8192 bake (8 bands) against rank 0's single-rank K6
   canvas, bit for bit (SHA-256).

Any failure raises; rank 0 then prints the card's name and power limit,
one JSON object of the measurements and, last, ``{"ok": true, ...}``.
Compare two versions only within one run.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

RUN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_multicard_run")
CHECK_STEPS = 3


def bcast_digests(digests, dev):
    """Rank 0's list of hex digests on every rank."""
    import torch.distributed as dist

    blob = torch.tensor(list("".join(digests).encode()), dtype=torch.uint8, device=dev)
    dist.broadcast(blob, src=0)
    text = bytes(blob.cpu().tolist()).decode()
    return [text[i : i + 64] for i in range(0, len(text), 64)]


def main() -> int:
    parser = argparse.ArgumentParser(description="The port's multi-rank paths over NCCL, one rank per card.")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--small", action="store_true", help="chip_smoke.py's CPU rehearsal sizes")
    args = parser.parse_args()
    import torch.distributed as dist

    import chip_smoke as c
    from topo4d_tpu_torch import kernels
    from topo4d_tpu_torch.parallel.batched import make_batched_geometry_step
    from topo4d_tpu_torch.parallel.mesh import shard_view_batch
    from topo4d_tpu_torch.parallel.multihost import initialize_multihost, process_count, process_index, rank_device
    from topo4d_tpu_torch.pipeline.trainer import Trainer

    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_multicard: no CUDA device available", file=sys.stderr)
        return 1
    if not initialize_multihost(device=args.device):
        print("chip_multicard: launch with torchrun --nproc_per_node=N (N > 1)", file=sys.stderr)
        return 1
    dev = rank_device()
    rank, world = process_index(), process_count()
    c.DEVICE = str(dev)
    if args.small:  # a rehearsal on the CPU
        torch.cuda.synchronize = lambda *a, **k: None
        c.FULL_W, c.FULL_H, c.TEX_RES, c.DENSITY, c.INIT_ITERS = 96, 64, 64, 2, 6
        c.MULTI_MAIN_PATH = {"grid": (12, 12), "size": (48, 32)}
        if dev.type == "cpu":  # the plain versions run there, not K1/K2/K5
            c.check_counts = lambda *a, **k: None
    c.MULTI_BANDS[world] = 8
    c.MULTI_DIR = os.path.join(os.path.dirname(RUN_DIR), "chip_multicard")
    if dev.type == "cuda":
        c.CARD = subprocess.run(["nvidia-smi", "-i", str(dev.index), "--query-gpu=name,power.limit",
                                 "--format=csv,noheader"], capture_output=True, text=True, check=True).stdout.strip()
        if rank == 0:
            kernels.build_all(verbose=False)
    dist.barrier()  # the kernels are built once, by rank 0
    t_start = time.perf_counter()
    cfg, src, trainer, scene = c.build_main_path(**c.MULTI_MAIN_PATH)
    params_np, statics = scene[3], trainer.statics
    for t in range(1, c.FRAMES + 1):  # the targets, rendered here: the run's read-ahead launches nothing
        src.frame(t)
    out = {"world": world, "backend": dist.get_backend(), "device": str(dev)}

    # 1. the view-sharded run
    bcfg = copy.deepcopy(cfg)
    bcfg.schedule.views_per_step = 0
    bcfg.schedule.init_opt_num = c.BATCHED_INIT_ITERS
    bcfg.texture.gen_tex = False
    bcfg.data.output_dir = RUN_DIR
    if rank == 0:
        shutil.rmtree(RUN_DIR, ignore_errors=True)
    dist.barrier()
    tr = Trainer(bcfg, src, params_np, statics, device=dev)
    views = src.num_views
    if tr.mesh is None or tr.mesh.size != world or tr.batched_multi_step is not None:
        raise AssertionError(f"rank {rank}: view mesh {tr.mesh}, batched multi-step {tr.batched_multi_step}")
    digests = []
    sharded_step = tr.batched_step

    def step(*a, **k):
        r = sharded_step(*a, **k)
        digests.append(c.state_digest(r[0]))
        return r

    tr.batched_step = step
    parts = c.instrument(tr)
    torch.cuda.synchronize()
    c.reset_counts()
    t0 = time.perf_counter()
    tr.run(resume=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = c.read_counts()
    total = sum(tr.batched_schedule(p["frame"], views)[0] for p in parts)
    local = tr.mesh.block(views)[1]
    c.check_counts(counts, f"rank {rank}'s run", {
        "tile_blend_fwd": local * total, "tile_blend_bwd": local * total, "gauss_blur": 2 * local * total,
        "tile_blend_v3_fwd": 0, "tile_blend_v3_bwd": 0, "uv_bake": 0, "tile_blend_plain": 0, "gauss_blur_plain": 0,
    })
    if bcast_digests(digests, dev) != digests or len(digests) != total:
        raise AssertionError(f"rank {rank}: its state differs from rank 0's after some step of the run")
    tree = os.path.join(RUN_DIR, cfg.data.exp, cfg.data.seq)
    if rank == 0:
        for f in ("resume.pkl", "params.npz", "metrics.jsonl", "000002/face.obj"):
            if not os.path.exists(os.path.join(tree, f)):
                raise AssertionError(f"rank 0 did not write {f}")
    again = Trainer(bcfg, src, params_np, statics, device=dev)
    c.reset_counts()
    again.run(resume=True)
    if any(c.read_counts().values()):
        raise AssertionError(f"rank {rank}: the resumed run launched {c.read_counts()}")
    geo = parts[-1]
    nb = tr.batched_schedule(geo["frame"], views)[0]
    out["run"] = {"wall_s": wall, "tracked_ms_per_step": geo["wall"] / nb * 1e3, "steps": total,
                  "views_per_rank": local, "launches_per_rank": counts}

    # 2. sharded steps against one rank's, from the run's state, in turns
    st = tr.statics
    single_step = make_batched_geometry_step(st.quadruples, st.umbrellas, tr.render_fn, st.ring.indices.shape[0],
                                             ring_indices=st.ring.indices, device=dev)
    images = torch.as_tensor(src.frame(c.FRAMES).images, device=dev)
    cons = tr._constraints("track")
    lr, weights = tr.lrs_for("track"), tr.weights_for("track")
    images_l, cams_l = shard_view_batch(tr.mesh, images), shard_view_batch(tr.mesh, src.cameras)
    res = {"single": [], "sharded": []}
    for name in ("single", "sharded", "sharded", "single"):
        state, priors = c.batched_state(tr, dev)
        if name == "sharded":
            res[name].append(c.timed_steps(sharded_step, CHECK_STEPS, state, priors, images_l, cams_l, cons, lr,
                                           weights, "track"))
        elif rank == 0:
            res[name].append(c.timed_steps(single_step, CHECK_STEPS, state, priors, images, src.cameras, cons, lr,
                                           weights, "track"))
        dist.barrier()
    if rank == 0:
        (ls, ps, _, _), (lu, pu, _, _) = res["sharded"][0], res["single"][0]
        np.testing.assert_allclose(np.array(ls), np.array(lu), rtol=1e-4)
        worst = [c.assert_leaf_close(k, ps[k], pu[k], 2 * lr[k] * CHECK_STEPS) for k in pu]
        out["check"] = {"loss_rel_err": float(np.max(np.abs(np.array(ls) - np.array(lu)) / np.abs(np.array(lu)))),
                        "leaves": worst, "max_scaled": {k: c.max_scaled_err(ps[k], pu[k]) for k in pu},
                        "ms_single": [r[2] for r in res["single"]], "ms_sharded": [r[2] for r in res["sharded"]]}

    # 3. tile-sharded dense steps against one rank's
    dense = c.rank_dense(rank, world, cfg, src, params_np, statics)
    if rank == 0:
        out["dense"] = {}
        for mode, r in dense["dense"].items():
            sh, one = r[True], r[False]
            if sh["rows"] != one["rows"] or not all(torch.equal(sh["params"][k], one["params"][k]) for k in one["params"]):
                raise AssertionError(f"{mode}: the tile-sharded dense steps differ from one rank's")
            out["dense"][mode] = {"ms_sharded": sh["step_ms"], "ms_single": one["step_ms"],
                                  "all_reduce_bytes": sorted(set(sh["all_reduce"])), "launches_per_rank": sh["counts"]}
        out["all_reduce_ms"] = dense["all_reduce_ms"]

    # 4. the sharded bake against one rank's K6 canvas
    bake = c.rank_bake(rank, world, statics)
    want = bake["bake_digest"]
    if rank == 0:
        from topo4d_tpu_torch.pipeline.export import build_bake_binning
        from topo4d_tpu_torch.texture.bake_tiled import bake_canvas

        nd = statics.dense.topo.dense_vertices.shape[0]
        colors = torch.rand((nd, 3), device=dev, generator=torch.Generator(dev).manual_seed(21))
        want = c.canvas_digest(bake_canvas(build_bake_binning(statics, c.TEX_RES, dev), colors, c.TEX_RES, c.TEX_RES))
    if bcast_digests([want], dev) != [bake["bake_digest"]]:
        raise AssertionError(f"rank {rank}: the sharded bake differs from rank 0's single-rank canvas")
    out["bake_ms"] = bake["bake_ms"][1]
    dist.barrier()
    if rank == 0:
        shutil.rmtree(os.path.dirname(RUN_DIR) + "/chip_multicard", ignore_errors=True)
        shutil.rmtree(RUN_DIR, ignore_errors=True)
        out["seconds"] = time.perf_counter() - t_start
        print(c.CARD or "cpu", flush=True)
        print(json.dumps(out, default=str), flush=True)
        kind = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
        print(json.dumps({"ok": True, "device": {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}), flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
