"""The long-horizon run (``scripts/run_long_r04.py``).

Two full geometry-phase fits of one fabricated sequence in the batched
all-views mode: ``headline`` (``track_rebin_freq`` 25, frozen-binning
segments) and ``batched0`` (a fresh binning every render). Both consume
every view every step, so their view schedules are one: the per-frame
distance between their exported OBJ vertices is the long-horizon cost of
the frozen binnings alone.

Each run is verified as JAX's script verifies it: the per-frame
displacement ``max_dmeans3d`` below 3x the target's per-frame motion, its
mean over the last 10 tracked frames at most 1.5x that over the first 10
(no ratchet), the final iso loss's last-10 mean under 5x its first-10 mean,
and the topology (the ``f`` lines of every exported ``face.obj``) byte
for byte that of frame 1. The drift curve between the runs (per frame: the
max, the 99th percentile, the median and the vertices beyond 5x the
motion) is bounded on its 99th percentile, its outliers and their growth,
and the saturation of its windowed means. Failures are collected, the
report is written, and then they are raised together.

``batched0_frames`` below ``frames`` fits batched0 over a prefix of the
horizon; the drift curve then covers that prefix.
"""

from __future__ import annotations

import json
import os
from typing import List, Sequence, Tuple

import numpy as np

MODES = {"headline": 25, "batched0": 0}


def fit_args(name: str, rebin: int, root: str, out_root: str, frames: int, device: str, schedule: Sequence[str] = ()):
    """``python -m topo4d_tpu_torch`` arguments of one run."""
    return [
        "-id", root, "-s", "seq01", "-od", os.path.join(out_root, name), "-e", "long",
        "-fn", str(frames), "-ion", "7000", "-on", "1100",
        "-lf", "500", "-cf", "10", "--backend", "pallas", "--no_mask",
        "-dr", "2", "--views_per_step", "0",
        "--track_rebin_freq", str(rebin),
        "--device", device, *schedule,
    ]


def run_mode(name, rebin, root, out_root, frames, device="cuda", schedule=()):
    """Fit one run -> its sequence output directory."""
    from topo4d_tpu_torch import cli

    argv = fit_args(name, rebin, root, out_root, frames, device, schedule)
    print(f"[long] {name}: python -m topo4d_tpu_torch {' '.join(argv)}", flush=True)
    cli.main(argv)
    return os.path.join(out_root, name, "long", "seq01")


def load_metrics(seq):
    with open(os.path.join(seq, "metrics.jsonl")) as fh:
        rows = [json.loads(line) for line in fh]
    summaries = {r["frame"]: r for r in rows if r.get("summary")}
    finals = {}
    for r in rows:
        if "loss_total" in r and "iter" in r:
            finals[r["frame"]] = r
    return summaries, finals


def verify_run(name, seq, frames, motion):
    """One run's report. Its windows are JAX's to the letter: with fewer
    than 10 tracked frames the last-10 slice starts below 0 and every
    window's sum is divided by 10."""
    summaries, finals = load_metrics(seq)
    tracked = sorted(t for t in summaries if t >= 1)
    if len(tracked) < frames - 1:
        raise RuntimeError(f"{name}: {len(tracked)} tracked frames in {seq}, expected {frames - 1}")
    disp = [summaries[t]["max_dmeans3d"] for t in tracked]
    losses = [finals[t]["loss_total"] for t in tracked]
    iso = [finals[t].get("loss_iso", 0.0) for t in tracked]
    rigid = [finals[t].get("loss_rigid", 0.0) for t in tracked]
    walls = [summaries[t]["frame_seconds"] for t in tracked]
    n = len(tracked)

    def seg(xs, a, b):
        return float(sum(xs[a:b]) / max(b - a, 1))

    report = {
        "frames": frames, "tracked": n,
        "max_dmeans3d": {
            "min": min(disp), "max": max(disp),
            "first10_mean": seg(disp, 0, 10),
            "last10_mean": seg(disp, n - 10, n),
        },
        "final_loss_total": {
            "first10_mean": seg(losses, 0, 10),
            "last10_mean": seg(losses, n - 10, n), "max": max(losses),
        },
        "final_loss_iso": {
            "first10_mean": seg(iso, 0, 10),
            "last10_mean": seg(iso, n - 10, n), "max": max(iso),
        },
        "final_loss_rigid": {
            "first10_mean": seg(rigid, 0, 10),
            "last10_mean": seg(rigid, n - 10, n), "max": max(rigid),
        },
        "wall_s": {
            "median": float(np.median(walls)),
            "mean": float(np.mean(walls)),
        },
    }
    fails = []
    if not report["max_dmeans3d"]["max"] < 3 * motion:
        fails.append("displacement_max")
    if not report["max_dmeans3d"]["last10_mean"] <= 1.5 * report["max_dmeans3d"]["first10_mean"]:
        fails.append("displacement_ratchet")
    if not report["final_loss_iso"]["last10_mean"] < 5 * max(report["final_loss_iso"]["first10_mean"], 1e-4):
        fails.append("iso_trend")
    f1 = topo_lines(seq, 1)
    for t in range(2, frames + 1):
        if topo_lines(seq, t) != f1:
            fails.append(f"topology_drift_frame_{t}")
            break
    report["topology_byte_stable"] = not any(f.startswith("topology") for f in fails)
    report["failed_checks"] = fails
    return report


def topo_lines(seq, t):
    with open(os.path.join(seq, "%06d" % t, "face.obj")) as fh:
        return [line for line in fh if line.startswith("f ")]


def obj_vertices(seq, t):
    with open(os.path.join(seq, "%06d" % t, "face.obj")) as fh:
        vs = [[float(x) for x in line.split()[1:4]] for line in fh if line.startswith("v ")]
    return np.asarray(vs, np.float64)


def drift_saturation(d_max) -> Tuple[List[float], int, float]:
    """The saturation rule of a per-frame drift curve (``run_long_r04.py``):
    its means over windows of an eighth of the frames -> (the window means,
    the window, the last window over the window at three quarters)."""
    d = np.asarray(d_max, np.float64)
    nf = d.shape[0]
    win = max(nf // 8, 1)
    windowed = [float(np.mean(d[i: i + win])) for i in range(0, nf, win)]
    return windowed, win, float(windowed[-1] / max(windowed[max(len(windowed) * 3 // 4 - 1, 0)], 1e-12))


def drift_report(seqs, frames, b0_frames, motion):
    """The headline-against-batched0 exported-vertex drift over the frames
    both ran -> (its summary with any failed bounds, the per-frame curves)."""
    nf = min(frames, b0_frames)
    d_max, d_p99, d_med, n_out = [], [], [], []
    for t in range(1, nf + 1):
        dv = np.linalg.norm(obj_vertices(seqs["headline"], t) - obj_vertices(seqs["batched0"], t), axis=1)
        d_max.append(float(dv.max()))
        d_p99.append(float(np.percentile(dv, 99)))
        d_med.append(float(np.median(dv)))
        n_out.append(int((dv > 5 * motion).sum()))
    d = np.asarray(d_max)
    windowed, win, ratio = drift_saturation(d)
    nverts = obj_vertices(seqs["headline"], 1).shape[0]
    dr = {
        "per_frame_max": float(d.max()),
        "argmax_frame": int(d.argmax()) + 1,
        "p99_max": float(max(d_p99)),
        "median_max": float(max(d_med)),
        "outliers_final": n_out[-1],
        "outliers_mid": n_out[nf // 2],
        "num_vertices": int(nverts),
        "windowed_means": windowed,
        "window": win,
        "last_window_over_three_quarters": ratio,
    }
    # the mesh at large within a few frame motions of the exact-binning
    # trajectory (p99), the basin-flip cluster small and not growing, the
    # max curve saturating; the raw max is recorded, not bounded
    fails = []
    if not dr["p99_max"] < 3 * motion:
        fails.append("drift_p99")
    if not dr["outliers_final"] <= max(10, int(0.005 * nverts)):
        fails.append("drift_outlier_count")
    if not dr["outliers_final"] <= 1.5 * max(dr["outliers_mid"], 4):
        fails.append("drift_outlier_growth")
    if not dr["last_window_over_three_quarters"] <= 1.1:
        fails.append("drift_saturation")
    if fails:
        dr["failed"] = fails
    return dr, {"max": d_max, "p99": d_p99, "median": d_med, "outliers": n_out}


def main(root: str, out_root: str, frames: int = 800, motion: float = 0.004, skip: Sequence[str] = (),
         b0_frames=None, device="cuda", schedule: Sequence[str] = ()):
    """Fit both runs (those in ``skip`` are read from ``out_root`` as a
    previous call left them), verify them, write ``verification.json`` and
    ``drift_per_frame.json`` under ``out_root``; raises listing every failed
    check -> the report."""
    b0_frames = frames if b0_frames is None else b0_frames
    mode_frames = {"headline": frames, "batched0": b0_frames}
    seqs = {}
    for name, rebin in MODES.items():
        if name in skip:
            seqs[name] = os.path.join(out_root, name, "long", "seq01")
            continue
        seqs[name] = run_mode(name, rebin, root, out_root, mode_frames[name], device, schedule)

    report = {name: verify_run(name, seqs[name], mode_frames[name], motion) for name in MODES}
    dr, curves = drift_report(seqs, frames, b0_frames, motion)
    report["vertex_drift_headline_vs_batched0"] = dr
    with open(os.path.join(out_root, "drift_per_frame.json"), "w") as fh:
        json.dump(curves, fh)
    with open(os.path.join(out_root, "verification.json"), "w") as fh:
        json.dump(report, fh, indent=2, default=float)
    print(json.dumps(report, indent=2, default=float))
    print(f"[long] report: {os.path.join(out_root, 'verification.json')}", flush=True)
    all_fails = [f"{m}:{f}" for m in MODES for f in report[m].get("failed_checks", [])]
    all_fails += dr.get("failed", [])
    if all_fails:
        raise RuntimeError(f"long-run checks failed: {all_fails}")
    return report
