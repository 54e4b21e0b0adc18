"""Headline-scale validation: the batched modes against parity (``scripts/validate_headline.py``).

Three full geometry-phase fits at reference scale (the 8,280-vertex grid,
24 views at 375x512, the reference schedule) on one fabricated dataset:

- ``headline``: ``views_per_step`` 0, ``track_rebin_freq`` 25 (all views
  per step, frozen binnings for 25 steps);
- ``batched0``: ``views_per_step`` 0, ``track_rebin_freq`` 0 (fresh
  binnings: isolates the frozen-binning staleness from the batched update
  rule);
- ``parity``: ``views_per_step`` 1, ``track_rebin_freq`` 0 (the
  reference's one random view per step).

Criteria, as JAX's script computes them: each frame's last logged geometry
``loss_total`` of headline at most 1.2x parity's (the modes are different
optimizers, not different implementations), and the frozen-binning drift,
the largest distance between headline's and batched0's exported
``means3D`` per frame. ``loss_total`` does not compare across modes (the
batched modes sum the photometric loss over every view), so the report
adds the common metric (``score.py``) of every mode and headline's
photometric loss over parity's per frame, the criterion to judge.

The fits run through ``topo4d_tpu_torch.cli.main`` with the JAX script's
arguments and ``--device``; ``schedule`` flags are appended after them (the
last of a repeated flag wins), to cut the schedule of a small run.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Sequence

import numpy as np

from topo4d_tpu_torch.validate import score

MODES = {
    "headline": {"views_per_step": 0, "rebin": 25},
    "batched0": {"views_per_step": 0, "rebin": 0},
    "parity": {"views_per_step": 1, "rebin": 0},
}


def fit_args(name: str, spec: Dict[str, int], root: str, out_root: str, frames: int, device: str,
             schedule: Sequence[str] = ()):
    """``python -m topo4d_tpu_torch`` arguments of one mode's fit."""
    return [
        "-id", root, "-s", "seq01", "-od", os.path.join(out_root, name), "-e", "val",
        "-fn", str(frames), "-ion", "7000", "-on", "1100",
        "-lf", "500", "-cf", "50", "--backend", "pallas", "--no_mask",
        "-dr", "2",
        "--views_per_step", str(spec["views_per_step"]),
        "--track_rebin_freq", str(spec["rebin"]),
        "--device", device, *schedule,
    ]


def run_mode(name, spec, root, out_root, frames, device="cuda", schedule=()):
    """Fit one mode -> (its metric rows, its ``params.npz``, wall seconds)."""
    from topo4d_tpu_torch import cli

    argv = fit_args(name, spec, root, out_root, frames, device, schedule)
    print(f"[validate] {name}: python -m topo4d_tpu_torch {' '.join(argv)}", flush=True)
    t0 = time.perf_counter()
    cli.main(argv)
    wall = time.perf_counter() - t0
    seq = os.path.join(out_root, name, "val", "seq01")
    with open(os.path.join(seq, "metrics.jsonl")) as fh:
        rows = [json.loads(line) for line in fh]
    return rows, np.load(os.path.join(seq, "params.npz")), wall


def frame_finals(rows, key="loss_total"):
    """Last logged geometry loss per frame (frame -> value)."""
    out = {}
    for r in rows:
        if key in r and "iter" in r:
            out[r["frame"]] = r[key]
    return out


def mode_results(rows, npz):
    return {
        "finals": frame_finals(rows),
        "psnr": frame_finals(rows, "psnr"),
        "max_dmeans3d": {r["frame"]: r["max_dmeans3d"] for r in rows if r.get("summary")},
        "means": {k: np.asarray(v) for k, v in npz.items() if k == "means3D"},
    }


def headline_report(results, frames: int):
    """JAX's report of the three modes' ``mode_results``: the per-frame
    finals, the 1.2x criterion and the frozen-binning drift."""
    report = {"frames": frames, "modes": {}}
    for name in MODES:
        report["modes"][name] = {
            "final_loss_per_frame": results[name]["finals"],
            "final_psnr_per_frame": results[name]["psnr"],
            "max_dmeans3d_per_frame": results[name]["max_dmeans3d"],
        }
    # criterion 1: headline within 1.2x of parity per frame
    ok_parity = {}
    for t, lp in results["parity"]["finals"].items():
        lh = results["headline"]["finals"].get(t)
        ok_parity[t] = (lh is not None) and (lh <= 1.2 * lp)
    report["headline_within_1p2x_parity"] = ok_parity
    # criterion 2: frozen-binning drift, exported means3D headline against
    # batched0 per frame (one optimizer, only the binning's staleness)
    mh = results["headline"]["means"]["means3D"]
    mb = results["batched0"]["means"]["means3D"]
    if mh.ndim == 2:  # one frame: nothing stacked
        mh, mb = mh[None], mb[None]
    drift = {}
    for t in range(min(mh.shape[0], mb.shape[0])):
        drift[t] = float(np.max(np.linalg.norm(mh[t] - mb[t], axis=-1)))
    report["frozen_binning_means_drift"] = drift
    return report


def main(root: str, out_root: str, frames: int = 4, device="cuda", schedule: Sequence[str] = ()):
    """Fit the three modes on the dataset at ``root`` into ``out_root``,
    score them, write ``<out_root>/headline_validation.json`` and print its
    table -> the report."""
    os.makedirs(out_root, exist_ok=True)
    results, walls, npzs = {}, {}, {}
    for name, spec in MODES.items():
        rows, npz, walls[name] = run_mode(name, spec, root, out_root, frames, device, schedule)
        results[name] = mode_results(rows, npz)
        npzs[name] = npz
    report = headline_report(results, frames)
    report["wall_s"] = walls

    src = score.open_source(root, 2, device)
    common = {name: score.score_params(src, npzs[name], frames) for name in score.MODES}
    report["common_metric"] = common
    ratio = {
        t: common["headline"][t]["photometric_mean"] / common["parity"][t]["photometric_mean"]
        for t in common["parity"]
    }
    report["headline_over_parity_photometric"] = ratio

    with open(os.path.join(out_root, "headline_validation.json"), "w") as fh:
        json.dump(report, fh, indent=2, default=float)

    ok_parity, drift = report["headline_within_1p2x_parity"], report["frozen_binning_means_drift"]
    print("\n| frame | parity loss | batched0 loss | headline loss | headline<=1.2x parity | bin-drift max|dv| "
          "| photometric parity | batched0 | headline | headline / parity |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for t in sorted(results["parity"]["finals"]):
        c = {m: common[m].get(t, {}).get("photometric_mean", float("nan")) for m in score.MODES}
        print(
            f"| {t} | {results['parity']['finals'][t]:.5f} "
            f"| {results['batched0']['finals'].get(t, float('nan')):.5f} "
            f"| {results['headline']['finals'].get(t, float('nan')):.5f} "
            f"| {ok_parity.get(t)} "
            f"| {drift.get(t, float('nan')):.2e} "
            f"| {c['parity']:.5f} | {c['batched0']:.5f} | {c['headline']:.5f} "
            f"| {ratio.get(t, float('nan')):.4f} |"
        )
    print(f"\nreport: {os.path.join(out_root, 'headline_validation.json')}", flush=True)
    return report
