"""The full-texture-scale run: fixed-view PSNR and real UV seams (``scripts/run_tex8k_r05.py``).

The composed 8K protocol (at least 3 frames, ``--gen_tex --tex_res 8192
--density 30``, 24 full-resolution views, a 301-step dense loop) on a
dataset with a real UV seam (``fabricate(..., uv_seam=True)``), checked as
JAX's script checks it:

1. quality on a fixed view: the trainer logs ``tex_psnr_fixed`` (view 0,
   eval only) beside the random view's ``tex_psnr``, so consecutive rows
   compare. Frame 1's fixed PSNR must rise by 0.05 and its all-view PSNR
   must not fall; every frame's fixed series must not fall by more than
   0.02 between rows and must end above 12.5; the tracked frames must end
   no lower than frame 1 less 0.1;
2. each baked ``face.png`` covers more than half its texels, with a colour
   standard deviation above 10;
3. seam continuity: texel colours sampled along the two islands' seam-side
   edges differ, pair by pair, no more than 3x an equally separated
   interior control line's (or 0.05 in the mean, 0.10 at the 95th
   percentile), over more than 100 lit pairs.

Every check is evaluated and written into ``verification.json`` under
``out_root``; the failures are raised together after it is written. The
8192² texture is read with this package's PNG decoder.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np

# the seam layout's island edges and v range (fabricate.seam_uvs)
U_LEFT_EDGE = 0.46  # left island's seam-side u
U_RIGHT_EDGE = 0.54  # right island's seam-side u
V_LO, V_HI = 0.05, 0.95


def sample_line(tex, u, n=400):
    """Bilinear-sample tex along the vertical line at texture-u ``u``. The
    taps are gathered before the float32 conversion (JAX's script converts
    the whole texture: the same values, without a 805 MB copy at 8K)."""
    res = tex.shape[0]
    vs = np.linspace(V_LO + 0.01, V_HI - 0.01, n)
    x = u * (res - 1)
    y = res - vs * (res - 1) - 1  # process_uv V flip
    x0 = int(np.floor(x))
    fx = x - x0
    y0 = np.floor(y).astype(int)
    fy = y - y0

    def tap(yy, xx):
        return tex[yy, xx].astype(np.float32)

    c = (
        tap(y0, x0) * (1 - fx) * (1 - fy)[:, None]
        + tap(y0, x0 + 1) * fx * (1 - fy)[:, None]
        + tap(y0 + 1, x0) * (1 - fx) * fy[:, None]
        + tap(y0 + 1, x0 + 1) * fx * fy[:, None]
    )
    return c / 255.0


def seam_check(tex, inset_texels=3.0):
    """Colour continuity across the UV seam against an interior control.

    Samples the two islands' seam-side edges (inset a few texels, so that no
    background reaches the bilinear taps) and, as the control, an interior
    line pair of the same texel separation inside the left island. Pairs
    where either side is background (unbaked) are dropped -> the stats."""
    res = tex.shape[0]
    du = inset_texels / (res - 1)
    a = sample_line(tex, U_LEFT_EDGE - du)
    b = sample_line(tex, U_RIGHT_EDGE + du)
    lit = (a.sum(1) > 0.02) & (b.sum(1) > 0.02)
    seam_d = np.abs(a - b).mean(1)[lit]
    u0 = 0.25
    ca = sample_line(tex, u0 - du)
    cb = sample_line(tex, u0 + du)
    clit = (ca.sum(1) > 0.02) & (cb.sum(1) > 0.02)
    ctrl_d = np.abs(ca - cb).mean(1)[clit]
    return {
        "seam_pairs": int(lit.sum()),
        "seam_mean": float(seam_d.mean()) if lit.any() else None,
        "seam_p95": float(np.percentile(seam_d, 95)) if lit.any() else None,
        "ctrl_pairs": int(clit.sum()),
        "ctrl_mean": float(ctrl_d.mean()) if clit.any() else None,
        "ctrl_p95": float(np.percentile(ctrl_d, 95)) if clit.any() else None,
    }


def fit_args(root: str, out_root: str, frames: int, cfg_path: str, device: str, schedule: Sequence[str] = ()):
    """``python -m topo4d_tpu_torch`` arguments of the run."""
    return [
        "--config", cfg_path,
        "-id", root, "-did", root + "_dense", "-s", "seq01",
        "-od", out_root, "-e", "tex8k",
        "-fn", str(frames), "-ion", "7000", "-on", "1100",
        "-t", "-tr", "8192", "-dn", "30", "-dr", "8", "-ddr", "1",
        "-don", "301", "-dlf", "100", "-lf", "500", "-cf", "1",
        "--backend", "pallas", "--no_mask", "--views_per_step", "0",
        "--device", device, *schedule,
    ]


def texture_stats(tex):
    """A baked texture's coverage (texels not black) and the standard
    deviation of its covered texels' values."""
    covered = np.any(tex > 0, axis=-1)
    return float(covered.mean()), float(tex[covered].std())


def verify(seq: str, frames: int):
    """The checks of the module docstring over the run in ``seq`` -> (the
    report, the failed checks). The texture's side is the run's
    ``texture.tex_res`` (8192 under the protocol's arguments)."""
    from topo4d_tpu_torch.pipeline.data import read_image

    with open(os.path.join(seq, "metrics.jsonl")) as fh:
        rows = [json.loads(line) for line in fh]
    with open(os.path.join(seq, "config.json")) as fh:
        cfgj = json.load(fh)
    res = cfgj["texture"]["tex_res"]
    report = {"frames": frames, "per_frame": []}
    fails = []
    fixed_last = {}
    for t in range(1, frames + 1):
        path = os.path.join(seq, "%06d" % t, "face.png")
        if not os.path.exists(path):
            fails.append(f"frame{t}:face_png_missing")
            continue
        tex = read_image(path)
        if tex.shape[:2] != (res, res):
            fails.append(f"frame{t}:face_png_shape")
            continue
        coverage, cstd = texture_stats(tex)
        if not coverage > 0.5:
            fails.append(f"frame{t}:coverage")
        if not cstd > 10.0:
            fails.append(f"frame{t}:covered_std")
        tex_rows = [r for r in rows if r.get("frame") == t - 1 and "tex_psnr_fixed" in r]
        fixed = [r["tex_psnr_fixed"] for r in tex_rows]
        allview = [r.get("tex_psnr_allview") for r in tex_rows]
        rand = [r.get("tex_psnr") for r in tex_rows]
        if len(fixed) < 3:
            fails.append(f"frame{t}:fixed_rows")
            continue
        if t == 1:
            if not fixed[-1] >= fixed[0] + 0.05:
                fails.append("frame1:fixed_trend")
            if not allview[-1] >= allview[0]:
                fails.append("frame1:allview_trend")
        if not all(b >= a - 0.02 for a, b in zip(fixed, fixed[1:])):
            fails.append(f"frame{t}:fixed_monotone")
        if not fixed[-1] > 12.5:
            fails.append(f"frame{t}:fixed_floor")
        fixed_last[t] = fixed[-1]
        # saturation: the all-view PSNR at the log row nearest iteration 150 against the final row
        its = [r["iter"] for r in tex_rows]
        mid_i = min(range(len(its)), key=lambda i: abs(its[i] - 150))
        seam = seam_check(tex)
        if not seam["seam_pairs"] > 100:
            fails.append(f"frame{t}:seam_pairs")
        else:  # no lit control pair: the absolute bounds alone
            if not seam["seam_mean"] <= max(3.0 * (seam["ctrl_mean"] or 0.0), 0.05):
                fails.append(f"frame{t}:seam_mean")
            if not seam["seam_p95"] <= max(3.0 * (seam["ctrl_p95"] or 0.0), 0.10):
                fails.append(f"frame{t}:seam_p95")
        summary = next(r for r in rows if r.get("summary") and r["frame"] == t - 1)
        report["per_frame"].append({
            "frame": t,
            "coverage": coverage,
            "covered_std": cstd,
            "tex_psnr_fixed_first": fixed[0],
            "tex_psnr_fixed_last": fixed[-1],
            "tex_psnr_allview_first": allview[0],
            "tex_psnr_allview_last": allview[-1],
            "allview_gap_after_iter150": allview[-1] - allview[mid_i],
            "tex_psnr_rand_first": rand[0],
            "tex_psnr_rand_last": rand[-1],
            "seam": seam,
            "wall_s": summary["frame_seconds"],
        })
    # tracked frames end at least as good as frame 1 on the same fixed view
    for t in range(2, frames + 1):
        if t in fixed_last and 1 in fixed_last and not fixed_last[t] >= fixed_last[1] - 0.1:
            fails.append(f"frame{t}:tracked_below_frame1")
    with open(os.path.join(seq, "timings.json")) as fh:
        timings = json.load(fh)
    report["timings"] = {k: v for k, v in timings.items() if k in ("geometry", "texture", "export", "checkpoint")}
    report["tex_res"] = res
    report["density"] = cfgj["texture"]["density"]
    report["failed_checks"] = fails
    return report, fails


def main(root: str, out_root: str, frames: int = 3, verify_only: bool = False, device="cuda",
         schedule: Sequence[str] = ()):
    """Run the protocol on the seam dataset at ``root`` (and ``root_dense``)
    into ``out_root`` (``verify_only``: check an existing run), write
    ``<out_root>/verification.json``; raises listing every failed check ->
    the report."""
    from topo4d_tpu_torch import cli
    from topo4d_tpu_torch.config import Config

    cfg = Config()
    cfg.raster.max_span = 2
    # the all-view PSNR at every dense log row: the saturation curve
    cfg.texture.allview_eval = True
    os.makedirs(out_root, exist_ok=True)
    cfg_path = os.path.join(out_root, "tex8k_config.json")
    with open(cfg_path, "w") as fh:
        fh.write(cfg.to_json())
    if not verify_only:
        argv = fit_args(root, out_root, frames, cfg_path, device, schedule)
        print(f"[tex8k] python -m topo4d_tpu_torch {' '.join(argv)}", flush=True)
        cli.main(argv)
    report, fails = verify(os.path.join(out_root, "tex8k", "seq01"), frames)
    with open(os.path.join(out_root, "verification.json"), "w") as fh:
        json.dump(report, fh, indent=2, default=float)
    print(json.dumps(report, indent=2, default=float))
    print(f"[tex8k] report: {os.path.join(out_root, 'verification.json')}", flush=True)
    if fails:
        raise RuntimeError(f"tex8k checks failed: {fails}")
    return report
