"""Traffic phase ``track``: tracked frames' geometry fit
(``Trainer.fit_frame_geometry``) at the working resolution, in the mode
the traffic's ``program`` settings pick. A timing probe: nothing here
decides ``correct``.

Set-up makes the scene, renders the working-resolution targets of a cycle
of heads, builds the trainer on the template head with the known colours,
and fits frame 1 with the traffic's ``warm_steps`` schedule. The window
fits frames 2, 3, ... with the full schedule until ``--seconds`` have
passed (``track_s_per_frame``); the traced run fits one frame with the
``trace_steps`` schedule under the profiler and reports the card's busy
share and device activities per step.
"""

from __future__ import annotations

import time

import torch

from benchmark.harness import program
from benchmark.harness import trace as tr
from benchmark.harness.scene import make_scene
from benchmark.harness.targets import render_views


def run(run) -> dict:
    from topo4d_tpu_torch.pipeline.scene import cache_first_frame_attrs
    from topo4d_tpu_torch.topology.regions import FacialRegions

    cfg, traffic, dev = run.config, run.traffic, run.device
    scene = make_scene(cfg, run.seed, dev)
    cycle = traffic["cycle_frames"]
    heads = [scene.head(k, traffic["motion"]) for k in range(cycle)]
    targets = [render_views(scene, scene.work_rig, h, dev) for h in heads]
    trainer = program.build_trainer(scene, cfg, traffic, dev)
    trainer.first_frame_attrs = cache_first_frame_attrs(trainer.state.params, FacialRegions.from_dict(scene.regions))
    names = trainer.source.view_names

    def fit(t):
        trainer.fit_frame_geometry(t, program.frame_data(targets[t % cycle], names))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    saved = program.apply_overrides(trainer.cfg, traffic["warm_steps"])
    fit(1)
    program.apply_overrides(trainer.cfg, saved)
    setup_s = time.perf_counter() - run.t0
    result = {"attempted": 0, "failed": 0, "compared": {}, "breakdown": None, "busy": None,
              "units": {"launches_per_step.track": "launches/step", "idle_pct.track": "%",
                        "ms_per_step.track": "ms/step", "track_s_per_frame": "s/frame", "setup_s": "s"}}
    if run.trace:
        saved = program.apply_overrides(trainer.cfg, traffic["trace_steps"])
        sched = trainer.cfg.schedule
        steps = sched.opt_num if sched.views_per_step == 1 else trainer.batched_schedule(2, cfg["views"])[0]
        acts = [torch.profiler.ProfilerActivity.CPU] + (
            [torch.profiler.ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(tr.WINDOW):
                fit(2)
        program.apply_overrides(trainer.cfg, saved)
        trace = tr.read_profile(prof, {}, 0, 1, steps, {})
        result["metrics"] = {"launches_per_step.track": len(trace.ops) / steps,
                             "idle_pct.track": 100.0 * (1.0 - trace.busy_s / trace.window_s),
                             "ms_per_step.track": 1e3 * trace.window_s / steps}
        result["busy"] = (trace.busy_s, trace.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops_breakdown(trace), "idle_gaps": trace.gaps}
        result["attempted"] = 1
    else:
        frames, t, w0 = 0, 2, time.perf_counter()
        while True:
            fit(t)
            frames, t = frames + 1, t + 1
            if time.perf_counter() - w0 >= run.seconds:
                break
        result["metrics"] = {"track_s_per_frame": (time.perf_counter() - w0) / frames, "setup_s": setup_s}
        result["attempted"] = frames
    result["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return result
