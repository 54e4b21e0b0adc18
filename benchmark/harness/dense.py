"""Traffic phase ``dense``: tracked frames' dense texture phase, back to back.

Set-up makes the scene from the seed, renders the targets of a cycle of
``cycle_frames`` heads of the known motion (uint8 on the host), builds the
port's trainer, and runs the check's four steps through
``Trainer.fit_frame_texture`` (frame 0 for one step, frame 1 for three:
the single step and the multi-step), which also warms every shape the
window uses. The window then fits frames
2, 3, ... in full, each from the previous frame's dense state, frame t on
head and targets t mod ``cycle_frames``; it takes whole frames and ends
with the first frame that finishes at or after ``--seconds``.
``dense_s_per_frame`` is its wall time over its frames. The traced run
fits one frame under the profiler instead.
"""

from __future__ import annotations

import functools
import gc
import math
import time

import numpy as np
import torch

from benchmark.harness import check, program
from benchmark.harness import trace as tr
from benchmark.harness.scene import make_scene
from benchmark.harness.targets import render_views
from benchmark.reference.dense_set import OPACITY, densify, knn_log_scales
from benchmark.reference.step import run_reference


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def run(run) -> dict:
    cfg, traffic, dev = run.config, run.traffic, run.device
    stages = {"start": time.perf_counter() - run.t0}
    scene = make_scene(cfg, run.seed, dev)
    cycle = traffic["cycle_frames"]
    heads = [scene.head(k, traffic["motion"]) for k in range(cycle)]
    stages["scene"] = time.perf_counter() - run.t0
    targets = [render_views(scene, scene.dense_rig, h, dev) for h in heads]
    stages["targets"] = time.perf_counter() - run.t0
    trainer = program.build_trainer(scene, cfg, traffic, dev)
    names = trainer.source.view_names
    stages["trainer"] = time.perf_counter() - run.t0
    prog = check.program_readings(trainer, heads, targets, names)
    _sync(dev)
    setup_s = stages["check_steps"] = time.perf_counter() - run.t0
    peak = _peak(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    t = len(check.CHECK_STEPS)
    result = {"breakdown": None, "busy": None}

    def fit(t):
        k = t % cycle
        program.set_geometry(trainer, heads[k])
        row = trainer.fit_frame_texture(t, program.frame_data(targets[k], names))
        _sync(dev)
        return math.isfinite(float(row.get("tex_psnr_fixed", float("nan"))))

    frames = failed = 0
    if run.trace:
        calls = {}
        with tr.spans(calls, run.bench_dir):
            _sync(dev)
            acts = [torch.profiler.ProfilerActivity.CPU] + (
                [torch.profiler.ProfilerActivity.CUDA] if dev.type == "cuda" else [])
            with torch.profiler.profile(activities=acts) as prof:
                with torch.profiler.record_function(tr.WINDOW):
                    failed += not fit(t)
                    frames += 1
        window_peak = _peak(dev)
        head = heads[t % cycle]
        context = {"scene": scene, "config": cfg, "device": dev,
                   "dense_gaussians": functools.lru_cache(None)(lambda: dense_gaussians(scene, cfg, head, dev))}
        trace = tr.read_profile(prof, calls, window_peak, frames, frames * cfg["dense_opt_num"], context)
        del prof
        result["metrics"] = {name: tr.metric_reader(name, run.bench_dir)(trace) for name in run.per_layer}
        result["busy"] = (trace.busy_s, trace.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops_breakdown(trace), "idle_gaps": trace.gaps}
        result["span_device_s"] = {name: sum(op.dur_ns for op in trace.span_ops(name)) / 1e9 for name in calls}
        del trace, calls, context
    else:
        w0 = time.perf_counter()
        while True:
            failed += not fit(t)
            frames += 1
            t += 1
            if time.perf_counter() - w0 >= run.seconds:
                break
        wall = time.perf_counter() - w0
        result["metrics"] = {"dense_s_per_frame": wall / frames, "setup_s": setup_s}
    peak = max(peak, _peak(dev))

    del trainer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    stages["window_end"] = time.perf_counter() - run.t0
    ref = run_reference(scene, cfg, list(zip(heads, targets)), check.CHECK_STEPS, dev)
    stages["reference"] = time.perf_counter() - run.t0
    result.update(attempted=frames, failed=failed, memory_peak_bytes=peak, stages=stages,
                  compared=check.compare(prog, ref), readings={"program": prog, "reference": ref})
    return result


def dense_gaussians(scene, cfg, head: np.ndarray, dev) -> dict:
    """The reference's dense set on ``head`` with its first attributes: what
    the per-layer readers count the blend's work on."""
    ds = densify(scene.verts, scene.faces, scene.uvs, scene.uv_faces, scene.regions["face_masks"], cfg["density"])
    idx, w = torch.as_tensor(ds.idx, device=dev), torch.as_tensor(ds.w, device=dev)
    corners = torch.as_tensor(head, device=dev)[idx]
    means = (w[:, :, None] * corners).sum(1)
    n = means.shape[0]
    return {
        "means": means,
        "quats": torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev).repeat(n, 1),
        "scales": torch.exp(torch.as_tensor(knn_log_scales(ds.pos0), device=dev))[:, None].repeat(1, 3),
        "opacity": torch.full((n,), OPACITY, device=dev),
    }
