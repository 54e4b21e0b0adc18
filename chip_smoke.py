#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port ``topo4d_tpu_torch``.

    python3 chip_smoke.py

Needs one CUDA card (exits non-zero without one) and ``nvcc``. Phases, in
order; any failure raises and exits non-zero:

1. device: card name and power limit, torch and CUDA versions;
2. build: every kernel of ``topo4d_tpu_torch/csrc`` with nvcc, in parallel;
3. kernels vs their plain PyTorch versions at head scale (8,280 Gaussians,
   375x512, one view) at max_span 4 and 2, plus a saturated-window case;
4. the main path: the parity-mode trainer (``Trainer.fit_frame_geometry``)
   fits frame 0 ("init", init_opt_num cut to 100) and frame 1 ("track",
   the full opt_num of 1,100) of a synthetic 24-view sequence; the launch
   counters must equal the step count and the plain blend must not run;
5. five "track" steps on the card against the same five on the CPU;
6. timings: K1, K2 and the plain version at the main path's shapes with
   their bounds, ms per step, s per tracked frame, and a profile of ten
   track steps (device busy share, activities per step, top kernels).

The line before the last is one JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12  # FP32 outside the tensor cores, H100 SXM data sheet
INIT_ITERS = 100  # frame 0 cut from the reference's 7,000 to fit the time limit
DEVICE = "cuda"
CARD = ""


def log(msg: str) -> None:
    print(f"[{CARD}] {msg}", flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device ms per call of ``fn`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def pack_view(params, cam, max_span):
    """Project, bin and pack one view -> (PackedBins, Binning, tiles_x, tiles_y)."""
    from topo4d_tpu_torch.core.gaussian import activate_params, project_gaussians
    from topo4d_tpu_torch.rasterizer.tiles import compute_binning, num_tiles, pack_with_binning

    with torch.no_grad():
        rv = activate_params(params)
        proj = project_gaussians(rv, cam)
        binning = compute_binning(proj, cam.width, cam.height, max_span)
        bins = pack_with_binning(proj, rv.colors, rv.opacities, binning)
    return bins, binning, *num_tiles(cam.width, cam.height)


def pair_counts(packed, start, count, tiles_x):
    """What this input's data needs K1 to do: (pairs evaluated, pairs
    contributing, entries read), the last summed over tiles as the entries
    up to the furthest any pixel of the tile must look."""
    from topo4d_tpu_torch.core.gaussian import TRANSMITTANCE_MIN
    from topo4d_tpu_torch.rasterizer.blend import tile_alpha

    with torch.no_grad():
        alpha, _ = tile_alpha(packed, start, count, tiles_x)
        stop = torch.cumprod(1.0 - alpha, dim=-1) < TRANSMITTANCE_MIN
        full = count[:, None].long().expand(-1, alpha.shape[1])
        # a pixel evaluates entries up to and including its terminating one
        first = torch.minimum(torch.where(stop.any(-1), stop.float().argmax(-1) + 1, full), full)
        evaluated = int(first.sum())
        contributing = int(((alpha > 0) & ~stop).sum())
        entries = int(first.amax(-1).sum())
    return evaluated, contributing, entries


def compare_kernels(bins, binning, tiles_x, tiles_y, label: str, seed: int):
    """K1 and K2 against the plain version on the same inputs; asserts the
    JAX suite's tolerances and returns (K1 max |err| on rows 0-4, K2 max
    |err| of the Gaussian gradients)."""
    from topo4d_tpu_torch.rasterizer.blend import (
        tile_blend_bwd_cuda,
        tile_blend_fwd_cuda,
        tile_blend_plain,
    )
    from topo4d_tpu_torch.rasterizer.tiles import FIELD_ROWS, fold_entry_grads

    packed, start, count = bins.packed, bins.tile_start, bins.tile_count
    out_k = tile_blend_fwd_cuda(packed, start, count, tiles_x, tiles_y)
    packed_p = packed.clone().requires_grad_(True)
    out_p = tile_blend_plain(packed_p, start, count, tiles_x, tiles_y)
    torch.cuda.synchronize()
    fwd_err = float((out_k[:, :5] - out_p[:, :5].detach()).abs().max())
    term_diff = int((out_k[:, 5] != out_p[:, 5].detach()).sum())
    torch.testing.assert_close(out_k[:, :5], out_p[:, :5].detach(), rtol=1e-4, atol=1e-5)

    rng = np.random.default_rng(seed)
    g_np = rng.normal(size=tuple(out_k.shape)).astype(np.float32)
    g_np[:, 5:] = 0.0  # residual rows carry no gradient
    g_out = torch.as_tensor(g_np, device=packed.device)
    dp_k = tile_blend_bwd_cuda(packed, start, count, out_k, g_out, tiles_x, tiles_y)
    (dp_p,) = torch.autograd.grad(out_p, packed_p, g_out)
    rows = list(FIELD_ROWS)
    gk = fold_entry_grads(dp_k[rows, : binning.sorted_gid.shape[0]], binning.entry_valid, binning.inv_positions)
    gp = fold_entry_grads(dp_p[rows, : binning.sorted_gid.shape[0]], binning.entry_valid, binning.inv_positions)
    scale = float(gp.abs().max().clamp(min=1e-8))
    bwd_err = float((gk - gp).abs().max())
    torch.testing.assert_close(gk / scale, gp / scale, rtol=2e-3, atol=2e-5)
    log(
        f"{label}: E_pad {packed.shape[1]}, tiles {tiles_x * tiles_y}, max count "
        f"{int(count.max())}: K1 max|err| {fwd_err:.3e} (rows 0-4), pixels whose "
        f"last contributor differs {term_diff}; K2 max|err| {bwd_err:.3e} of the "
        f"Gaussian gradients, max|grad| {scale:.3e}, ratio {bwd_err / scale:.3e}"
    )
    return fwd_err, bwd_err


def phase_kernels():
    from topo4d_tpu_torch.convert import params_from_numpy
    from topo4d_tpu_torch.testing import make_head_fixture, make_synthetic_camera

    params_np, cams, _ = make_head_fixture(device=DEVICE)
    params = params_from_numpy(params_np, DEVICE)
    errs = {}
    for span in (4, 2):
        bins, binning, tx, ty = pack_view(params, cams[0], span)
        errs[span] = compare_kernels(bins, binning, tx, ty, f"head scale, max_span {span}", seed=span)

    # >80 nats of opacity inside one tile (tests/test_rasterizer_pallas.py:160)
    n = 64
    rng = np.random.default_rng(5)
    sat = {
        "means3D": rng.normal(0, 0.003, (n, 3)).astype(np.float32),
        "rgb_colors": rng.uniform(0.2, 0.8, (n, 3)).astype(np.float32),
        "unnorm_rotations": np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
        "logit_opacities": np.full((n, 1), 8.0, np.float32),
        "log_scales": np.full((n, 3), np.log(0.05), np.float32),
    }
    cam = make_synthetic_camera(width=32, height=32, device=DEVICE)
    bins, binning, tx, ty = pack_view(params_from_numpy(sat, DEVICE), cam, 8)
    compare_kernels(bins, binning, tx, ty, "saturated windows", seed=6)
    return errs


def build_main_path():
    from topo4d_tpu_torch.config import Config
    from topo4d_tpu_torch.pipeline.data import SyntheticSequence
    from topo4d_tpu_torch.pipeline.scene import build_scene
    from topo4d_tpu_torch.pipeline.trainer import Trainer
    from topo4d_tpu_torch.testing import make_grid_mesh, make_head_fixture, make_synthetic_regions
    from topo4d_tpu_torch.topology.obj_io import MeshObj

    rows, cols = 92, 90
    verts, faces = make_grid_mesh(rows, cols, extent=0.5)
    uvs = np.stack(
        np.meshgrid(np.linspace(0.05, 0.95, cols), np.linspace(0.05, 0.95, rows), indexing="xy"), -1
    ).reshape(-1, 2).astype(np.float32)
    mesh = MeshObj(vertices=verts, uvs=uvs, faces=faces, uv_faces=[list(f) for f in faces])
    regions = make_synthetic_regions(verts.shape[0], faces)
    cfg = Config()
    cfg.schedule.init_opt_num = INIT_ITERS
    params_np, statics = build_scene(mesh, regions, cfg, num_views=24)
    # the sequence's ground truth is the head fixture on the same mesh
    # (random colors, other scales and opacities), so the fit has work to do
    gt_params, cams, _ = make_head_fixture(device=DEVICE)
    src = SyntheticSequence(params=gt_params, cameras=cams, num_frames=1)
    trainer = Trainer(cfg, src, params_np, statics, device=DEVICE)
    return cfg, src, trainer


def phase_main_path(cfg, src, trainer):
    from topo4d_tpu_torch.rasterizer.blend import LAUNCHES, reset_launches

    frames = [src.frame(0), src.frame(1)]  # targets rendered before the counted run
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    m0 = trainer.fit_frame_geometry(0, frames[0])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    m1 = trainer.fit_frame_geometry(1, frames[1])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = dict(LAUNCHES)
    steps = cfg.schedule.init_opt_num + cfg.schedule.opt_num
    rows = trainer.metrics_log
    for r in rows:
        for k, v in r.items():
            if not np.isfinite(v):
                raise AssertionError(f"non-finite metric {k}={v} in {r}")
    track = [r for r in rows if r["frame"] == 1]
    log(
        "main path: frame 0 init {} steps {:.3f} s (loss {:.6f} -> {:.6f}), frame 1 track {} steps "
        "{:.3f} s (loss {:.6f} -> {:.6f}, psnr {:.3f}); launches {}".format(
            cfg.schedule.init_opt_num, t1 - t0, rows[0]["loss_total"], m0["loss_total"],
            cfg.schedule.opt_num, t2 - t1, track[0]["loss_total"], m1["loss_total"],
            m1["psnr"], counts,
        )
    )
    if not track[-1]["loss_total"] < track[0]["loss_total"]:
        raise AssertionError(f"tracked frame's loss did not fall: {track[0]} -> {track[-1]}")
    for name in ("tile_blend_fwd", "tile_blend_bwd"):
        if counts[name] != steps:
            raise AssertionError(f"{name} launched {counts[name]} times in {steps} steps")
    if counts["tile_blend_plain"] != 0:
        raise AssertionError("the plain blend ran on the main path")
    return counts, (t2 - t0) / steps, t2 - t1, frames


def phase_card_vs_cpu(cfg, trainer, frames):
    """Five track steps from the same state and view order, card vs CPU."""
    from topo4d_tpu_torch.core.camera import Camera
    from topo4d_tpu_torch.opt.adam import AdamState
    from topo4d_tpu_torch.opt.step import TrainState, make_geometry_step
    from topo4d_tpu_torch.pipeline.data import view_order
    from topo4d_tpu_torch.pipeline.scene import build_constraints
    from topo4d_tpu_torch.pipeline.trainer import make_render_fn

    def to(x, dev):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if isinstance(x, dict):
            return {k: to(v, dev) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(to(v, dev) for v in x))
        return x

    st = trainer.statics
    n = trainer.state.params["means3D"].shape[0]
    cpu_step = make_geometry_step(
        st.quadruples, st.umbrellas, make_render_fn(cfg, "cpu"), n,
        ring_indices=st.ring.indices, device="cpu",
    )
    cams = trainer.source.cameras
    cams_cpu = Camera(
        w2c=cams.w2c.cpu(), fx=cams.fx.cpu(), fy=cams.fy.cpu(), cx=cams.cx.cpu(), cy=cams.cy.cpu(),
        width=cams.width, height=cams.height, near=cams.near, far=cams.far,
    )
    images = torch.as_tensor(frames[1].images)
    runs = {}
    for dev, step, cm, con in (
        (DEVICE, trainer.step, cams, trainer._constraints("track")),
        ("cpu", cpu_step, cams_cpu,
         build_constraints("track", trainer.params0, st.regions, trainer.first_frame_attrs, "cpu")),
    ):
        state = TrainState(
            params=to(trainer.state.params, dev),
            opt=AdamState(dict(trainer.state.opt.step), to(trainer.state.opt.mu, dev), to(trainer.state.opt.nu, dev)),
            max_2d_radius=to(trainer.state.max_2d_radius, dev),
        )
        priors = to(trainer.priors, dev)
        imgs = images.to(dev)
        lr = trainer.lrs_for("track")
        losses = []
        for vid in view_order(24, 5, seed=7):
            state, priors, m = step(
                state, imgs[int(vid)], cm, int(vid), priors, con, lr,
                trainer.weights_for("track"), "track", with_metrics=False,
            )
            losses.append(float(m["loss_total"]))
        runs[dev] = (losses, {k: v.cpu() for k, v in state.params.items()})
    lc, lg = np.array(runs["cpu"][0]), np.array(runs[DEVICE][0])
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    lr = trainer.lrs_for("track")
    worst = []
    for k, pc in runs["cpu"][1].items():
        d = (runs[DEVICE][1][k] - pc).abs()
        bound = 2 * lr[k] * 5
        within = float((d <= 1e-6).float().mean())
        worst.append(f"{k} max|d| {float(d.max()):.2e} (bound {bound:.1e}) {within * 100:.3f}% within 1e-6")
        if float(d.max()) > bound + 1e-6 or within < 0.999:
            raise AssertionError(f"card vs CPU: {worst[-1]}")
    log(f"card vs CPU, 5 track steps: loss rel err {float(np.max(np.abs(lg - lc) / np.abs(lc))):.2e}; " + "; ".join(worst))


def phase_profile(trainer, frames, steps: int = 10):
    """Device busy share and kernel launches of track steps.

    The same ``steps`` views run twice from the same state: once without the
    profiler, for the wall time, and once under ``torch.profiler``, for the
    device time of each kernel (CUPTI's device timestamps, which the
    profiler's host overhead does not stretch). The busy share is the
    profiled device time over the unprofiled wall time.
    """
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from topo4d_tpu_torch.pipeline.data import view_order

    images = torch.as_tensor(frames[1].images, device=DEVICE)
    args = (trainer._constraints("track"), trainer.lrs_for("track"), trainer.weights_for("track"), "track")
    cams = trainer.source.cameras
    order = [int(v) for v in view_order(24, steps + 2, seed=3)]

    def run(views):
        state, priors = trainer.state, trainer.priors
        for vid in views:
            state, priors, _ = trainer.step(state, images[vid], cams, vid, priors, *args, with_metrics=False)

    run(order[:2])  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(order[2:])
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(order[2:])
        torch.cuda.synchronize()
        wall_prof_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = Counter()
    for e in kernels:
        by_name[e.name[:60]] += e.time_range.elapsed_us() / 1e3

    def kernel_ms(symbol):
        return sum(e.time_range.elapsed_us() for e in kernels if symbol in e.name) / 1e3 / steps

    top = ", ".join(f"{n} {t / steps:.3f}" for n, t in by_name.most_common(6))
    k1, k2 = kernel_ms("tile_blend_fwd_kernel"), kernel_ms("tile_blend_bwd_kernel")
    log(
        f"profile of {steps} track steps: {wall_ms / steps:.3f} ms/step wall without the profiler "
        f"({wall_prof_ms / steps:.3f} with it); device busy {busy_ms / steps:.3f} ms/step, "
        f"{100 * busy_ms / wall_ms:.1f}% of the unprofiled wall (idle {100 - 100 * busy_ms / wall_ms:.1f}%); "
        f"{len(kernels) / steps:.0f} device activities/step; K1 {k1:.4f} + K2 {k2:.4f} ms/step "
        f"({100 * (k1 + k2) * steps / busy_ms:.1f}% of busy, {100 * (k1 + k2) * steps / wall_ms:.2f}% of wall); "
        f"top ms/step: {top}"
    )


def phase_timing(trainer, counts, ms_step, s_frame, errs):
    from topo4d_tpu_torch import kernels
    from topo4d_tpu_torch.rasterizer.blend import (
        PX,
        tile_blend_bwd_cuda,
        tile_blend_fwd_cuda,
        tile_blend_plain,
    )

    cam = trainer.source.cameras[0]
    bins, binning, tx, ty = pack_view(trainer.state.params, cam, trainer.cfg.raster.max_span)
    compare_kernels(bins, binning, tx, ty, "main path shapes (view 0, trained params)", seed=9)
    packed, start, count = bins.packed, bins.tile_start, bins.tile_count
    t = tx * ty
    out = tile_blend_fwd_cuda(packed, start, count, tx, ty)
    g_out = torch.randn(out.shape, device=out.device, generator=torch.Generator("cuda").manual_seed(0))
    ms_fwd = cuda_ms(lambda: tile_blend_fwd_cuda(packed, start, count, tx, ty), iters=50)
    # K2 alone, on a dpacked allocated and zeroed once; the wrapper's
    # zero-fill of the whole (16, E_pad) dpacked is timed on its own
    k2 = kernels.kernel("tile_blend_bwd")
    dpacked = torch.zeros_like(packed)
    stream = torch.cuda.current_stream().cuda_stream
    k2_args = (
        packed.data_ptr(), packed.shape[1], start.data_ptr(), count.data_ptr(), tx, t,
        out.data_ptr(), g_out.data_ptr(), dpacked.data_ptr(), stream,
    )
    ms_bwd = cuda_ms(lambda: kernels.check(k2(*k2_args), "tile_blend_bwd"), iters=50)
    ms_zero = cuda_ms(lambda: torch.zeros_like(packed), iters=50)
    ms_bwd_wrapper = cuda_ms(lambda: tile_blend_bwd_cuda(packed, start, count, out, g_out, tx, ty), iters=50)
    packed_p = packed.clone().requires_grad_(True)
    ms_plain_fwd = cuda_ms(lambda: tile_blend_plain(packed, start, count, tx, ty), iters=5, warmup=1)
    out_p = tile_blend_plain(packed_p, start, count, tx, ty)
    ms_plain_bwd = cuda_ms(
        lambda: torch.autograd.grad(out_p, packed_p, g_out, retain_graph=True), iters=5, warmup=1
    )

    # What this run's data needs each kernel to move and compute
    evaluated, contributing, k1_entries = pair_counts(packed, start, count, tx)
    last = out[:, 5].long()  # entries up to each pixel's last contributor
    last_total = int(last.sum())  # pairs K2 visits
    k2_entries = int(last.amax(-1).sum())  # entries K2 reads and writes: per tile, up to its furthest pixel
    f4 = 4
    entry_b = 10 * f4  # the ten field rows (0-5, 8-11) of one entry
    ranges_b = 2 * t * f4
    row_b = t * PX * f4  # one row of a (T, 8, 256) tile buffer
    fwd_bytes = k1_entries * entry_b + ranges_b + 8 * row_b  # writes all 8 rows
    # reads fwd rows 4-5 and g_out rows 0-4, writes the ten rows of the entries it visits
    bwd_bytes = k2_entries * entry_b + ranges_b + (2 + 5) * row_b + k2_entries * entry_b
    # FP32 operations per (pixel, entry) pair, counted from the kernel sources
    fwd_ops = 16 * evaluated + 11 * contributing
    bwd_ops = 16 * (last_total - contributing) + 55 * contributing

    def bound(nbytes, ops):
        tb = nbytes / H100_BYTES_PER_S * 1e3
        to = ops / H100_FP32_OPS_PER_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    bf, byf = bound(fwd_bytes, fwd_ops)
    bb, byb = bound(bwd_bytes, bwd_ops)
    log(
        f"timing at main path shapes (E_pad {packed.shape[1]}, {t} tiles, entries in ranges "
        f"{int(count.sum())}, K1 must read {k1_entries}, K2 visits {k2_entries}; pairs K1 evaluates "
        f"{evaluated}, contributing {contributing}, K2 visits {last_total}; bytes K1 {fwd_bytes}, "
        f"K2 {bwd_bytes}; ops K1 {fwd_ops}, K2 {bwd_ops}): K1 {ms_fwd:.4f} ms (bound {bf:.4f} ms, "
        f"{byf}, {100 * bf / ms_fwd:.1f}%), K2 {ms_bwd:.4f} ms (bound {bb:.4f} ms, {byb}, "
        f"{100 * bb / ms_bwd:.1f}%); K2 wrapper with its dpacked zero-fill {ms_bwd_wrapper:.4f} ms, "
        f"zero-fill alone {ms_zero:.4f} ms; plain fwd {ms_plain_fwd:.3f} ms, plain bwd {ms_plain_bwd:.3f} ms"
    )
    log(f"ms per geometry step {ms_step * 1e3:.3f}; s per tracked frame (1,100 steps) {s_frame:.3f}")
    return [
        {
            "name": "tile_blend_fwd", "route": "cuda",
            "source": "topo4d_tpu_torch/csrc/blend_fwd.cu",
            "replaces": "topo4d_tpu/rasterizer/pallas_blend.py:317",
            "launches": counts["tile_blend_fwd"], "max_abs_err": errs[4][0],
            "ms": ms_fwd, "plain_ms": ms_plain_fwd, "bound_ms": bf, "bound_by": byf,
            "library_ms": None,
        },
        {
            "name": "tile_blend_bwd", "route": "cuda",
            "source": "topo4d_tpu_torch/csrc/blend_bwd.cu",
            "replaces": "topo4d_tpu/rasterizer/pallas_blend.py:942",
            "launches": counts["tile_blend_bwd"], "max_abs_err": errs[4][1],
            "ms": ms_bwd, "plain_ms": ms_plain_bwd, "bound_ms": bb, "bound_by": byb,
            "library_ms": None,
        },
    ]


def main() -> int:
    global CARD
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from topo4d_tpu_torch import kernels  # the package import turns TF32 off

    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(CARD, flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    log(f"kernels built in {kernels.build_all(verbose=True):.2f} s")
    errs = phase_kernels()
    cfg, src, trainer = build_main_path()
    counts, ms_step, s_frame, frames = phase_main_path(cfg, src, trainer)
    phase_card_vs_cpu(cfg, trainer, frames)
    kernel_rows = phase_timing(trainer, counts, ms_step, s_frame, errs)
    phase_profile(trainer, frames)

    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
