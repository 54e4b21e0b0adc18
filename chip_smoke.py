#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port ``topo4d_tpu_torch``.

    python3 chip_smoke.py [--ref NAME=PATH [NAME=PATH ...]] [--log PATH] [--seed N]

``--ref NAME=PATH`` builds PATH, a source of kernel NAME (an earlier
commit's file from ``git show``, or a variant, with the kernel's C
interface), and times it beside the kernel in phase 6, both alone on the
same inputs, in turns: NAME ``tile_blend_fwd`` (K1) and
``tile_blend_v3_fwd`` (K4f, at each tps) must give K1's rows 0-5 bit for
bit, ``uv_bake`` (K6) the kernel's canvas. NAME ``imgdec`` takes an
earlier commit's ``csrc/imgdec.c``, the host library, which phase 13b
times beside this one on the baseline and progressive JPEG and 8-bit PNG
decodes; NAME ``png`` an earlier commit's ``utils/png.py``, whose PNG
reader those PNG decodes then run over the ref library. ``--log PATH`` also appends
every log line to the file PATH. ``--seed N`` (0 by default) makes phase
12's synthetic morphable model and its coefficients. Without arguments only
the phases below run.

Needs one CUDA card (exits non-zero without one) and ``nvcc``. Phases, in
order; any failure raises and exits non-zero:

1. device: card name and power limit, torch and CUDA versions;
2. build: every kernel of ``topo4d_tpu_torch/csrc`` with nvcc, in parallel,
   and the host libraries with the host compilers (``csrc/imgdec.c``, C;
   ``csrc/scanline.cpp``, C++);
   the scene: the head grid and its dense mesh at density 5 (277,780 dense
   Gaussians, 546,028 dense triangles);
3. kernels vs their plain PyTorch versions: K1/K2 at head scale (8,280
   Gaussians, 375x512, one view) at max_span 4, 2 and 8, full canvas and
   compact, plus a saturated-window case in both modes, and at each of these
   shapes (and at the 4K dense view 0 in phase 6) K4f/K4b, the window-span
   pair behind ``variant="v3"``, at 4 and 8 rows per block: two K2
   launches equal bit for bit, K4f's rows 0-5 equal to K1's bit for bit,
   K4b's dpacked equal to K2's bit for bit; K5 at the dense phase's (15, 2160, 3840), the
   geometry phase's (15, 512, 375) and four edge shapes (H and W below the
   window, widths off its strips, a 4K plane one past its runs), forward
   bit for bit and backward; K6, the UV bake, bit for bit, through its
   wrapper and on a canvas pre-filled with NaN, at 8192x8192 on the dense
   mesh's UVs, on coplanar overlapping triangles (first wins), on a
   triangle that spans many tiles and on a tile that holds more entries
   than one staging batch (degenerate triangles among them), with the share
   of (pixel, entry) pairs K6's per-warp cull skips (counted with
   ``bake_warp_cull_plain``) and the entries per occupied tile;
4. the main path, ``Trainer.run(resume=False)`` over 2 frames of a
   synthetic 24-view sequence into a directory under ``build/``, with the
   launch counters set to 0 just before it and read just after, and each
   part's own launches read around it:
   a. frame 0: geometry ("init", init_opt_num cut to 100 steps at 375x512),
      then the dense texture phase (24 views at 3840x2160, the full 301
      iterations, compact tiles), then its checkpoint and export (the OBJ
      and the 8192x8192 bake through K6, on the export worker);
   b. frame 1: geometry ("track", the full opt_num of 1,100), texture (301
      iterations), checkpoint and export;
   K1/K2 run once per step and K5 twice, K6 once per frame, the plain
   versions never. Then the outputs: OBJ topology byte-identical across
   frames, each PNG decoded and equal to K6's bytes for that frame's
   colors, params.npz keys and shapes, resume.pkl at frame 2, and a second
   ``run(resume=True)`` that does nothing;
5. card against CPU: five "track" steps, and three texture steps at
   480x270 on a density-1 dense mesh;
6. timings: K1, K2, K4f/K4b (4 and 8 rows per block) and the plain blend at
   the geometry shapes and at one 4K dense view, there both compact and on
   the full canvas (with ``--ref``, those K1 and K4f builds beside these), with the
   share of visited (entry, warp) pairs in which a lane contributes, for
   three warp shapes and stop rules, and the share K1's bounding-box cull
   skips (counted with ``warp_block_cull_plain``); K5 (through its wrapper, the kernel alone through
   its C entry point beside it), its plain version and cuDNN's depthwise
   convolution at both blur shapes; K6 (with ``--ref``, those K6 builds
   beside it) and its plain version at 8192x8192 and the export's parts
   (host binning, the uint8 conversion and copy to the host, PNG encode,
   OBJ write); each kernel's bound; profiles of ten track steps
   and of ten dense steps, compact and on the full canvas (device busy
   share, activities per step, top kernels);
7. the v3 path: ten geometry steps at 375x512 and ten dense steps on the 4K
   dense view 0 (its frozen compact binning) through ``variant="v3"``, each
   beside the same steps through ``variant="auto"`` in turns (auto, v3, v3,
   auto): losses equal bit for bit, K4 launched and K1/K2 not on the v3 side and the
   reverse on the auto side, ms per step of each;
8. the batched all-views mode, a second ``Trainer.run(resume=False)`` over
   2 frames with ``views_per_step`` 0 and the auto ``track_rebin_freq``
   (25), geometry only (frame 0 cut to 240 init iterations, 10 batched
   steps; frame 1 the full 1,100, 46 batched steps): K1/K2 24 times and K5
   48 times per batched step, no K4, no plain version; the segments and
   frozen binnings; a profile of one 3-step segment; three batched steps on
   the card against the CPU (the CPU's plain blend padded per count bucket);
   then the fused batched mode, a third ``Trainer.run`` as the batched one
   with ``fuse_views``: K1/K2 once per batched step (every view in one
   launch on a tall canvas), K5 48 times, no K4, no plain version, no
   segments; three fused steps against three sequential batched steps on
   the card (loss rtol 1e-4, each leaf within 2 * lr * steps), both timed
   in turns (fused, sequential, sequential, fused), and a profile of the
   fused steps;
9. the CLI on a disk tree: ``write_disk_sequence`` writes the reference
   layout under ``build/`` (24 views named after ``DEFAULT_ROTATE_MASK``'s
   labels on landscape 4096x3000 sensors, so the loader's portrait swap and
   rotation run; the head grid; a component transform; parsing masks with
   skin and inner-mouth labels; the 3000x4096 dense tree; 2 frames); the
   loader is held to it (images and masks bit for bit, cameras within 1e-5,
   ``trans_g``); ``cli.main`` runs ``-t -tr 8192 -dn 5 -fn 2`` with
   ``data.use_mask_dense`` (schedule cut to 100 init, 200 track and 51
   dense steps) with the launch counts set to 0 just before it and read
   just after: K1/K2 per geometry and dense step, K1 per progress render
   and dense eval render, K5 twice per geometry step and never in a masked
   dense step, K6 per frame, no plain version; then the outputs (OBJ
   topology, each face.png decoded by ``utils/png.py`` equal to K6's bytes,
   the progress renders, config.json, the dimmed pixels), a resume through
   ``python -m topo4d_tpu_torch`` and one in process that launches
   nothing, the tiled and oracle renderers on the card against K1/K2; the
   host C library: the PNG unfilter against its NumPy mirror on rows of
   each filter type (s per Mpx of each), the JPEG decoder against the
   committed fixtures' SHA-256 (PIL's decodes); a 24-view JPEG tree of the
   4096x3000 fixture read and turned on the card, each view bit for bit
   against the fixture's decode turned on the host; and the geometry
   loop's ms per step (``SWEEP_STEPS`` track steps per fit) beside a dense
   PNG read and a dense JPEG read at 1, 2 and 4 loader threads;
10. several ranks on the one card: processes started with the spawn start
   method, each on ``cuda:0`` over gloo through ``initialize_multihost``
   (NCCL refuses two ranks on one device), so no time here says anything
   of NCCL across cards:
   a. a view-sharded batched ``Trainer.run`` of 2 ranks (phase 8's
      configuration, 12 views each, no segments): K1/K2 12 times and K5 24
      times per step on each rank, no plain version; both ranks' parameters,
      Adam moments and radii equal after every step (SHA-256); rank 0 alone
      writes (rank 1 is handed a directory of its own, which must not
      appear); three sharded steps from phase 8's final state against three
      single-rank steps (loss rtol 1e-4, each leaf as phase 8's, the
      max-scaled errors logged), timed in turns (one rank, 2 ranks, 2
      ranks, one rank);
   b. three tile-sharded dense steps at 3840x2160 (the frame's frozen
      binnings, compact and full canvas) through ``fit_frame_texture``,
      equal to one rank's in every metric row and parameter, K1 once per
      step and eval render and K2 once per step on each rank; the bytes of
      each all-reduce, each size timed alone, ms per dense step of both;
   c. the sharded 8192x8192 bake on 2 ranks (8 bands) and on 3 ranks (6
      bands), each rank's canvas equal to phase 3's K6 canvas bit for bit
      (SHA-256), K6 once per rank;
   d. NCCL at world size 1 in this process: the sharded loss of the 24
      views, its radii and gradients, and one sharded step, equal to the
      unsharded step's bit for bit;
   e. a 2-rank ``run(resume=True)`` that launches nothing, a rank on
      another ``output_dir`` that makes both raise, and the orbax backend's
      round trip on rank 0 under the initialised group;
11. the rest of the pipeline's options and the entry points, from the
   main path's fitted state:
   a. the dense loop's modes at the 4K dense view, ten steps each through
      ``fit_frame_texture`` in turns (scan mode at ``texture.rebin_freq`` 0
      and 1, loop mode at 5): ms per step, the frozen binnings each built,
      K1/K2 once per step (K1 once more per eval render) and K5 twice; then
      phase 5's card-against-CPU check through ``fit_frame_texture`` (480x270,
      density 1, three steps) at ``rebin_freq`` 1 and in loop mode at 2;
   b. ten 4K dense steps with ``remat_photometric`` off and on from one
      state, in turns: parameters and Adam moments equal bit for bit
      (SHA-256), ms per step, peak device memory, K5 three times per step
      under remat;
   c. a one-frame ``Trainer.run`` (20 init, 11 dense steps) under
      ``device_trace`` and the same run untraced: the trace parses, its
      K1/K2/K5 kernel events equal the launch counters, its size;
   d. ``entry("cuda")``'s loss against its plain version's (rtol 1e-5), K1
      and K5 once per call;
   e. ``dryrun_multichip(1, "cuda")``: a spawned NCCL world of one, every
      loss finite;
12. the face3d library surface and the "xla" bake (``phase_face3d``): a
   synthetic morphable model from ``--seed`` at the Basel Face Model's
   shapes, its generation, pose, lighting and keypoint fit on the card
   against the CPU; the C++ scanline library on the posed head at 256x256
   against ``mesh_numpy``; the banded "xla" bake at 8192x8192 on phase 3's
   dense UV layout against K6's canvas, bit for bit;
13. the image kinds beyond phase 9's and the functions added last
   (``phase_kinds``): a. the fixtures of the other kinds (progressive,
   Adobe-marked, 4:4:0 and 4:1:1 JPEG; arithmetic-coded JPEG, sequential
   and progressive, with DAC conditioning, two of them written by libjpeg;
   progressive files whose scans leave bits unsent, smoothed; an Adam7
   16-bit RGB PNG, an 8-bit RGB PNG) decoded by the C library against the
   manifest's SHA-256 of PIL's decodes; b. a 24-view tree of the progressive 4096x3000
   fixture on phase 9's ``cameras.xml``, read through ``DiskSequence`` and
   turned on the card, each view bit for bit against the fixture's decode
   turned on the host; its dense frame read and its single-thread decode
   timed in turns with a tree of the baseline fixture; with ``--ref
   imgdec=PATH`` (an earlier commit's ``csrc/imgdec.c``) the baseline JPEG,
   progressive JPEG and 8-bit PNG decodes of a dense view through both
   libraries, in turns, bits equal (with ``--ref png=PATH``, an earlier
   commit's ``utils/png.py``, the PNGs through that commit's reader); c. the tensor functions added last
   (the L2 and unfused flatten losses with their gradients,
   ``gather_neighbors``, the quaternion and camera functions,
   ``build_cov3d``, ``bin_gaussians`` and ``bin_gaussians_packed``, the
   merged and sequential constraint writes) on the card against the CPU at
   the head's 8,280 Gaussians; d. every damaged copy of the fixtures
   (``fixtures.DAMAGED``: JPEG cut off, cut off and closed by EOI, a
   restart marker deleted; PNG cut inside IEND, bad CRCs, streams of other
   lengths, IDAT chunks split) read by ``read_image`` against PIL's
   outcome in the manifest: its SHA-256, or a ``ValueError`` naming the
   file;
14. the validation protocols (``topo4d_tpu_torch/validate``, ``phase_validate``)
   at full width and cut depth: a. ``fabricate`` on the card (24 views
   at 375x512 on the head grid, ratio 2, motion 0.004, 2 frames), frame 2
   read back equal to a fresh render bit for bit; b. the headline
   protocol's three modes (parity, batched0, headline) through
   ``cli.main`` at 300 init and 150 track steps, each fit's launches and
   each mode's scoring read around it, the per-frame finals, the 1.2x
   criterion, the frozen-binning drift and the common metric; c. the
   common metric of one frame on the card against the CPU's (rtol 1e-4);
   d. ``long_run.verify_run`` on headline's and batched0's outputs and
   their exported-vertex drift; e. tex8k's reader and ``seam_check`` on
   phase 4's 8192x8192 ``face.png``. The protocols' criteria are logged;
   at this depth they are no verdict.

The line before the last is one JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import shutil
import struct
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12  # FP32 outside the tensor cores, H100 SXM data sheet
INIT_ITERS = 100  # frame 0 cut from the reference's 7,000 to fit the time limit
FRAMES = 2  # frames of the main path's run (the reference's sequences run hundreds)
DENSITY = 5  # dense points per quad edge: 277,780 dense Gaussians on the head grid
FULL_W, FULL_H = 3840, 2160  # the texture phase's full-resolution views
TEX_RES = 8192  # the baked texture's side (the config default)
ROWS_PER_CHUNK = 1024  # the plain blend's rows per call at 4K (memory)
BAKE_OPS_PER_PAIR = 32  # FP32 operations (compares included) per (pixel, entry) pair, from csrc/bake.cu
BAKE_OPS_PER_ENTRY = 30  # the per-entry terms a block stages
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_run")
DEVICE = "cuda"
CARD = ""


LOG_FILE = None  # --log: every log line is appended there too


def log(msg: str) -> None:
    line = f"[{CARD}] {msg}"
    print(line, flush=True)
    if LOG_FILE is not None:
        with open(LOG_FILE, "a") as fh:
            fh.write(line + "\n")


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


def bound(nbytes, ops):
    """(ms, "bytes" | "operations"): the larger of the two floors."""
    tb = nbytes / H100_BYTES_PER_S * 1e3
    to = ops / H100_FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def reset_counts():
    from topo4d_tpu_torch.losses import blur
    from topo4d_tpu_torch.rasterizer import blend
    from topo4d_tpu_torch.texture import bake_tiled

    blend.reset_launches()
    blur.reset_launches()
    bake_tiled.reset_launches()


def read_counts():
    from topo4d_tpu_torch.losses import blur
    from topo4d_tpu_torch.rasterizer import blend
    from topo4d_tpu_torch.texture import bake_tiled

    return {**blend.LAUNCHES, **blur.LAUNCHES, **bake_tiled.LAUNCHES}


def pack_view(rv, cam, max_span, capacity=None, with_static=False):
    """Bin (frozen, optionally compact) and pack one view -> (PackedBins, Binning, tiles_x, tiles_y)."""
    from topo4d_tpu_torch.core.gaussian import project_gaussians
    from topo4d_tpu_torch.rasterizer.render import binning_for
    from topo4d_tpu_torch.rasterizer.tiles import num_tiles, pack_with_binning

    with torch.no_grad():
        binning = binning_for(rv, cam, max_span, with_static=with_static, tile_capacity=capacity)
        proj = project_gaussians(rv, cam)
        bins = pack_with_binning(proj, rv.colors, rv.opacities, binning)
    return bins, binning, *num_tiles(cam.width, cam.height)


def blend_rows(bins, binning, tiles_x, tiles_y, compact: bool):
    """(start, count, tile ids) of the rows K1/K2 blend: the compact list, or
    every tile of the canvas with its id."""
    if compact:
        c = binning.compact
        return c.start, c.count, c.ids
    ids = torch.arange(tiles_x * tiles_y, device=bins.packed.device, dtype=torch.int32)
    return bins.tile_start, bins.tile_count, ids


def plain_blend(packed, start, count, tx, ty, ids, g_out=None):
    """The plain blend over ``ROWS_PER_CHUNK`` rows at a time -> output
    (R, 8, 256), and with ``g_out`` also dpacked from autograd (each entry
    belongs to one tile, so the chunks' gradients add up)."""
    from topo4d_tpu_torch.rasterizer.blend import tile_blend_plain

    outs = []
    dp = None if g_out is None else torch.zeros_like(packed)
    for s in range(0, start.shape[0], ROWS_PER_CHUNK):
        sl = slice(s, s + ROWS_PER_CHUNK)
        if g_out is None:
            with torch.no_grad():
                outs.append(tile_blend_plain(packed, start[sl], count[sl], tx, ty, ids[sl]))
            continue
        pp = packed.detach().requires_grad_(True)
        o = tile_blend_plain(pp, start[sl], count[sl], tx, ty, ids[sl])
        (d,) = torch.autograd.grad(o, pp, g_out[sl])
        dp += d
        outs.append(o.detach())
    return torch.cat(outs), dp


def pair_counts(packed, start, count, tiles_x, ids):
    """What this input's data needs K1 to do: (pairs evaluated, pairs
    contributing, entries read), the last summed over rows as the entries
    up to the furthest any pixel of the tile must look."""
    from topo4d_tpu_torch.core.gaussian import TRANSMITTANCE_MIN
    from topo4d_tpu_torch.rasterizer.blend import tile_alpha

    evaluated = contributing = entries = 0
    with torch.no_grad():
        for s in range(0, start.shape[0], ROWS_PER_CHUNK):
            sl = slice(s, s + ROWS_PER_CHUNK)
            alpha, _ = tile_alpha(packed, start[sl], count[sl], tiles_x, ids[sl])
            stop = torch.cumprod(1.0 - alpha, dim=-1) < TRANSMITTANCE_MIN
            full = count[sl, None].long().expand(-1, alpha.shape[1])
            # a pixel evaluates entries up to and including its terminating one
            first = torch.minimum(torch.where(stop.any(-1), stop.float().argmax(-1) + 1, full), full)
            evaluated += int(first.sum())
            contributing += int(((alpha > 0) & ~stop).sum())
            entries += int(first.amax(-1).sum())
    return evaluated, contributing, entries


def warp_entry_share(packed, start, count, tiles_x, ids, out):
    """How often a warp's per-entry step has work: the visited (entry, warp)
    pairs, those in which at least one lane's pixel contributes (the plain
    alpha, up to each pixel's last contributor as K1 saved it) and, for K1,
    those its bounding-box cull skips (``warp_block_cull_plain``), for
    three warp shapes and stop rules -> {shape: {"visited", "with_a_contributor"
    [, "culled"]}}. Warps of 32 consecutive pixels (two pixel rows: the first
    design of K1 and of K2) visit every entry up to the tile's furthest last
    contributor; the backward's 8 x 8 blocks (K2, two pixels per thread) stop
    at their own furthest last contributor; the forward's 8 x 8 blocks (K1)
    visit entries up to their own pixels' furthest terminating entry, or the
    range end if a pixel never stops."""
    from topo4d_tpu_torch.core.gaussian import TRANSMITTANCE_MIN
    from topo4d_tpu_torch.rasterizer.blend import PX, tile_alpha, warp_block_cull_plain
    from topo4d_tpu_torch.rasterizer.tiles import TILE

    k1 = "8 x 8 blocks, forward stop (K1)"
    shapes = {  # (rows, columns, the warp's own stop)
        "32 consecutive pixels": (2, TILE, False), "8 x 8 blocks, backward stop (K2)": (8, 8, True), k1: (8, 8, True),
    }
    totals = {k: {"visited": 0, "with_a_contributor": 0} for k in shapes}
    totals[k1]["culled"] = 0
    last = out[:, 5].long()
    with torch.no_grad():
        for s in range(0, start.shape[0], ROWS_PER_CHUNK):
            sl = slice(s, s + ROWS_PER_CHUNK)
            alpha, _ = tile_alpha(packed, start[sl], count[sl], tiles_x, ids[sl])
            r, m = alpha.shape[0], alpha.shape[-1]
            j = torch.arange(m, device=alpha.device)
            lst = last[sl]
            contrib = (alpha > 0) & (j < lst[..., None])
            # the forward's per-pixel visit: up to and including its terminating entry
            stop = torch.cumprod(1.0 - alpha, dim=-1) < TRANSMITTANCE_MIN
            full = count[sl, None].long().expand(-1, PX)
            reach = torch.minimum(torch.where(stop.any(-1), stop.float().argmax(-1) + 1, full), full)
            for k, (h, w, own) in shapes.items():
                blocks = (r, TILE // h, h, TILE // w, w)
                per_pixel = reach if k == k1 else lst
                per_warp = per_pixel.view(blocks).amax((2, 4))
                visited = per_warp if own else lst.amax(-1)[:, None, None].expand_as(per_warp)
                totals[k]["visited"] += int(visited.sum())
                totals[k]["with_a_contributor"] += int(contrib.view(*blocks, m).any(4).any(2).sum())
                if k == k1:  # warp w is block (w // 2, w % 2): the view's (block row, block column) order
                    culled = warp_block_cull_plain(packed, start[sl], count[sl], tiles_x, ids[sl])
                    totals[k]["culled"] += int((culled & (j < visited.reshape(r, 4, 1))).sum())
    return totals


V3_TPS = (4, 8)  # K4's rows per block: JAX's default and the other width scripts/probe_dense_v3.py sweeps


def check_forward(out_k, out_p, packed, label: str):
    """A forward kernel's rows 0-4 against the plain version's at the JAX
    suite's tolerance -> (max |err| where both stop at the same entry,
    pixels whose last contributor differs, max |err| on those).

    A pixel whose transmittance lands within rounding of the 1e-4 stop in
    one operation order (the kernel's sequential product, the plain
    version's cumprod scan) stops one entry apart in the two: its last
    contributor differs. Such pixels are counted (at most one per million)
    and the tolerance holds on every other pixel. On them, T_final differs
    by the weight of the entries one side blends and the other does not: at
    most 1e-4 / (1 - 0.99), the largest T at which one entry can cross the
    stop; rgb and depth differ by at most that weight times the largest
    feature, beyond the usual tolerance."""
    from topo4d_tpu_torch.core.gaussian import ALPHA_MAX, TRANSMITTANCE_MIN

    flip = out_k[:, 5] != out_p[:, 5]
    term_diff = int(flip.sum())
    if term_diff > max(1, flip.numel() // 10**6):
        raise AssertionError(f"{label}: {term_diff} of {flip.numel()} pixels stop at another entry")
    same = ~flip[:, None, :]
    diff = (out_k[:, :5] - out_p[:, :5]).abs()
    fwd_err = float(torch.where(same, diff, 0.0).max())
    flip_err = float(torch.where(same, 0.0, diff).max())
    torch.testing.assert_close(
        torch.where(same, out_k[:, :5], 0.0), torch.where(same, out_p[:, :5], 0.0), rtol=1e-4, atol=1e-5
    )
    if term_diff:
        d_t = diff[:, 4][flip]
        feat = float(packed[8:12].abs().max())  # rgb and depth rows of the packed entries
        slack = 1e-5 + 1e-4 * out_p[:, :4].abs().permute(0, 2, 1)[flip]
        d_c = diff[:, :4].permute(0, 2, 1)[flip]
        if float(d_t.max()) > TRANSMITTANCE_MIN / (1 - ALPHA_MAX) * (1 + 1e-3) or bool(
            (d_c > d_t[:, None] * feat + slack).any()
        ):
            raise AssertionError(
                f"{label}: a pixel that stops one entry apart differs by more than that entry's weight: "
                f"T_final {float(d_t.max()):.3e}, rgb/depth {float(d_c.max()):.3e} (max |feature| {feat:.3e})"
            )
    return fwd_err, term_diff, flip_err


def compare_kernels(bins, binning, tiles_x, tiles_y, label: str, seed: int, compact: bool = False):
    """K1 and K2, then K4f and K4b at each of ``V3_TPS``, against the plain
    version on the same inputs (full canvas or the compact rows); asserts
    the JAX suite's tolerances (forward rtol 1e-4 / atol 1e-5, gradients
    max-scaled rtol 2e-3 / atol 2e-5) and that K4f's rows 0-5 equal K1's bit
    for bit, and that two K2 launches on the same input are equal bit for
    bit -> (K1 max |err| on rows 0-4, K2 max |err| of the Gaussian
    gradients, the same two for K4 over its widths). In compact mode also
    checks that the compact rows, scattered onto the canvas, equal the
    full-canvas blend bit for bit, forward and backward."""
    from topo4d_tpu_torch.rasterizer.blend import (
        PX,
        tile_blend_bwd_cuda,
        tile_blend_fwd_cuda,
        tile_blend_v3_bwd_cuda,
        tile_blend_v3_fwd_cuda,
    )
    from topo4d_tpu_torch.rasterizer.tiles import FIELD_ROWS, fold_entry_grads

    packed = bins.packed
    start, count, ids = blend_rows(bins, binning, tiles_x, tiles_y, compact)
    kid = ids if compact else None
    out_k = tile_blend_fwd_cuda(packed, start, count, tiles_x, tiles_y, kid)
    rng = np.random.default_rng(seed)
    g_np = rng.normal(size=tuple(out_k.shape)).astype(np.float32)
    g_np[:, 5:] = 0.0  # residual rows carry no gradient
    g_out = torch.as_tensor(g_np, device=packed.device)
    out_p, dp_p = plain_blend(packed, start, count, tiles_x, tiles_y, ids, g_out)
    torch.cuda.synchronize()
    fwd_err, term_diff, flip_err = check_forward(out_k, out_p, packed, label)

    rows = list(FIELD_ROWS)
    e = binning.sorted_gid.shape[0]

    def gaussian_grads(dp):
        return fold_entry_grads(dp[rows, :e], binning.entry_valid, binning.inv_positions)

    dp_k = tile_blend_bwd_cuda(packed, start, count, out_k, g_out, tiles_x, tiles_y, kid)
    if not torch.equal(tile_blend_bwd_cuda(packed, start, count, out_k, g_out, tiles_x, tiles_y, kid), dp_k):
        raise AssertionError(f"{label}: two K2 launches on the same input differ")
    gk, gp = gaussian_grads(dp_k), gaussian_grads(dp_p)
    scale = float(gp.abs().max().clamp(min=1e-8))
    bwd_err = float((gk - gp).abs().max())
    torch.testing.assert_close(gk / scale, gp / scale, rtol=2e-3, atol=2e-5)
    extra = ""
    if compact:
        t = tiles_x * tiles_y
        full = tile_blend_fwd_cuda(packed, bins.tile_start, bins.tile_count, tiles_x, tiles_y)
        canvas = torch.zeros((t + 1, 8, PX), device=packed.device)
        canvas[:, 4] = 1.0
        canvas.index_copy_(0, ids.long(), out_k)
        if not torch.equal(canvas[:t, :6], full[:, :6]):
            raise AssertionError(f"{label}: compact rows differ from the full-canvas blend")
        g_full = torch.zeros_like(full)
        valid = ids < t
        g_full[ids[valid].long()] = g_out[valid]
        dp_full = tile_blend_bwd_cuda(packed, bins.tile_start, bins.tile_count, full, g_full, tiles_x, tiles_y)
        if not torch.equal(dp_full, dp_k):
            raise AssertionError(f"{label}: compact K2 differs from the full-canvas K2")
        extra = f"; compact == full canvas bit for bit ({int(valid.sum())} of {ids.shape[0]} rows used, {t} tiles)"
    log(
        f"{label}: E_pad {packed.shape[1]}, rows {start.shape[0]}, max count "
        f"{int(count.max())}: K1 max|err| {fwd_err:.3e} (rows 0-4), pixels whose "
        f"last contributor differs {term_diff} (max|err| there {flip_err:.3e}); K2 max|err| {bwd_err:.3e} of the "
        f"Gaussian gradients, max|grad| {scale:.3e}, ratio {bwd_err / scale:.3e}; two K2 launches equal bit for "
        f"bit{extra}"
    )

    v3_fwd_err = v3_bwd_err = 0.0
    for tps in V3_TPS:
        out_v = tile_blend_v3_fwd_cuda(packed, start, count, tiles_x, tiles_y, kid, tps)
        dp_v = tile_blend_v3_bwd_cuda(packed, start, count, out_v, g_out, tiles_x, tiles_y, kid, tps)
        torch.cuda.synchronize()
        differ = int((out_v[:, :6] != out_k[:, :6]).sum())
        if differ:
            raise AssertionError(f"{label}: K4f (tps {tps}) differs from K1 in {differ} values of rows 0-5")
        if out_v[:, 6:].abs().max() != 0:
            raise AssertionError(f"{label}: K4f (tps {tps}) wrote rows 6-7")
        f_err = check_forward(out_v, out_p, packed, f"{label}, K4f tps {tps}")[0]
        gv = gaussian_grads(dp_v)
        b_err = float((gv - gp).abs().max())
        torch.testing.assert_close(gv / scale, gp / scale, rtol=2e-3, atol=2e-5)
        k2_differ = int((dp_v != dp_k).sum())
        if k2_differ:
            raise AssertionError(f"{label}: K4b (tps {tps}) differs from K2 in {k2_differ} of {dp_k.numel()} values")
        log(
            f"{label}, K4 tps {tps}: K4f rows 0-5 equal K1 bit for bit (0 of {out_k[:, :6].numel()} values "
            f"differ), max|err| {f_err:.3e} vs plain; K4b equals K2 bit for bit (0 of {dp_k.numel()} values "
            f"differ), max|err| {b_err:.3e} of the Gaussian gradients, ratio {b_err / scale:.3e}"
        )
        v3_fwd_err, v3_bwd_err = max(v3_fwd_err, f_err), max(v3_bwd_err, b_err)
    return fwd_err, bwd_err, v3_fwd_err, v3_bwd_err


BLUR_EDGE_SHAPES = ((3, 7, 5), (2, 37, 53), (1, 11, 700), (3, 2161, 3843))  # below the window, ragged strips and runs


def compare_blur(shape, seed):
    """K5 forward (bit for bit) and backward (rtol 1e-5 / atol 1e-6)
    against the plain version; returns max |err|."""
    from topo4d_tpu_torch.losses.blur import SelfAdjointBlur, gauss_blur_cuda, gauss_blur_plain

    g = torch.Generator(DEVICE).manual_seed(seed)
    x = torch.rand(shape, device=DEVICE, generator=g).requires_grad_(True)
    cot = torch.randn(shape, device=DEVICE, generator=g)
    yk = SelfAdjointBlur.apply(x, gauss_blur_cuda)
    yp = gauss_blur_plain(x)
    (dk,) = torch.autograd.grad(yk, x, cot)
    (dp,) = torch.autograd.grad(yp, x, cot)
    yk, yp = yk.detach(), yp.detach()
    torch.cuda.synchronize()
    fwd_err = float((yk - yp).abs().max())
    bwd_err = float((dk - dp).abs().max())
    if not torch.equal(yk, yp):
        raise AssertionError(f"K5 {tuple(shape)}: the forward differs from the plain version, max|err| {fwd_err:.3e}")
    torch.testing.assert_close(dk, dp, rtol=1e-5, atol=1e-6)
    log(
        f"K5 {tuple(shape)}: forward bit for bit, "
        f"backward (kernel on the cotangent vs autograd of the plain version) max|err| {bwd_err:.3e}"
    )
    return max(fwd_err, bwd_err)


def bake_bound(binning, colors, height, width):
    """K6's bound from what this input needs it to move and compute -> (ms,
    by, pairs): the entries' ten geometry rows and three corner ids, the
    tile lists, each color row read once, the (H, W, 3) canvas written
    once; the (pixel, entry) pairs of every tile's range on the canvas."""
    e, m = binning.geom.shape[1], binning.tile_ids.shape[0]
    tx = binning.tiles_x
    ids = binning.tile_ids.long()
    on_w = (width - (ids % tx) * 16).clamp(max=16)
    on_h = (height - (ids // tx) * 16).clamp(max=16)
    pairs = int((binning.count.long() * on_w * on_h).sum())
    nbytes = 13 * 4 * e + 3 * 4 * m + 4 * binning.empty_ids.shape[0] + colors.numel() * 4 + height * width * 3 * 4
    return (*bound(nbytes, BAKE_OPS_PER_PAIR * pairs + BAKE_OPS_PER_ENTRY * e), pairs)


def bake_args(binning, colors, height, width, out):
    """K6's C arguments for ``out`` on the current stream."""
    b = binning
    return (b.geom.data_ptr(), b.corner_idx.data_ptr(), b.geom.shape[1], colors.data_ptr(), colors.shape[1],
            b.tile_ids.data_ptr(), b.start.data_ptr(), b.count.data_ptr(), b.tile_ids.shape[0],
            b.empty_ids.data_ptr(), b.empty_ids.shape[0], b.tiles_x, width, height, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)


def bake_into(binning, colors, height, width, out):
    """K6 through its C entry point into ``out``, as the caller allocated
    it (not counted as a launch of the main path)."""
    from topo4d_tpu_torch import kernels

    kernels.check(kernels.kernel("uv_bake")(*bake_args(binning, colors, height, width, out)), "uv_bake")


def compare_bake(binning, colors, height, width, label):
    """K6 against its plain version on the same inputs, bit for bit, through
    its wrapper and on a canvas pre-filled with NaN (the kernel must write
    every pixel) -> (kernel canvas, max |err|)."""
    from topo4d_tpu_torch.texture.bake_tiled import bake_canvas_cuda, bake_canvas_plain

    out_k = bake_canvas_cuda(binning, colors, height, width)
    out_nan = torch.full_like(out_k, float("nan"))
    bake_into(binning, colors, height, width, out_nan)
    out_p = bake_canvas_plain(binning, colors, height, width)
    torch.cuda.synchronize()
    err = max(float((o - out_p).abs().max()) for o in (out_k, out_nan))
    for name, o in (("through its wrapper", out_k), ("on a canvas pre-filled with NaN", out_nan)):
        if not torch.equal(o, out_p):
            differ = int((o != out_p).any(-1).sum())
            raise AssertionError(f"K6 {label}, {name}: {differ} pixels differ from the plain version (max|err| {err:.3e})")
    covered = int((out_p != 0).any(-1).sum())
    log(
        f"K6 {label}: {binning.geom.shape[1]} entries in {binning.tile_ids.shape[0]} occupied tiles of "
        f"{binning.tiles_x * binning.tiles_y} (at most {int(binning.count.max()) if binning.count.numel() else 0} "
        f"in one), {covered} of {height * width} pixels covered; bit for bit against the plain version through its "
        f"wrapper and on a canvas pre-filled with NaN"
    )
    return out_k, err


def bake_cull_counts(binning, height, width):
    """What K6's per-warp cull skips on this input (``bake_warp_cull_plain``)
    and the entries per occupied tile -> {"culled_pairs", "pairs",
    "culled_share", "entries_per_tile_max", "entries_per_tile_mean"}; a
    pair is an on-canvas pixel of a warp block with an entry of its tile."""
    from topo4d_tpu_torch.texture.bake_tiled import bake_warp_cull_plain

    tile = binning.geom[9].long()
    w = torch.arange(4, device=tile.device)
    x0 = (tile % binning.tiles_x)[:, None] * 16 + (w % 2) * 8
    y0 = (tile // binning.tiles_x)[:, None] * 16 + (w // 2) * 8
    on_canvas = (width - x0).clamp(0, 8) * (height - y0).clamp(0, 8)  # (E, 4) pixels of each block
    culled = int((bake_warp_cull_plain(binning) * on_canvas).sum())
    pairs = int(on_canvas.sum())
    count = binning.count.double()
    return {"culled_pairs": culled, "pairs": pairs, "culled_share": culled / max(pairs, 1),
            "entries_per_tile_max": int(count.max()), "entries_per_tile_mean": float(count.mean())}


def read_png(path):
    """An 8-bit RGB PNG with filter type 0 on every row (what the port
    writes) -> (H, W, 3) uint8."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        if zlib.crc32(kind + body) != struct.unpack(">I", data[pos + 8 + n : pos + 12 + n])[0]:
            raise AssertionError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = header
    if (depth, ctype, interlace) != (8, 2, 0):
        raise AssertionError(f"{path}: not 8-bit RGB without interlace: {header}")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    if raw[:, 0].any():
        raise AssertionError(f"{path}: a row uses a filter other than 0")
    return raw[:, 1:].reshape(h, w, 3)


def phase_bake(statics):
    """K6 against its plain version, bit for bit, through its wrapper and on
    a canvas pre-filled with NaN: the 8192^2 bake of the density-5 dense
    mesh's UVs with seeded colors (the main path's shapes), coplanar
    overlapping triangles (the first wins), a triangle over many tiles, a
    tile that holds more entries than one staging batch, and triangles
    partly off a canvas whose sides are no multiple of 16, through the
    wrapper that bins for itself; K6's culled share and entries per tile at
    8192^2 -> (max |err|, the 8K inputs for the timings)."""
    from topo4d_tpu_torch.pipeline.export import build_bake_binning
    from topo4d_tpu_torch.testing import make_crowded_bake_tile
    from topo4d_tpu_torch.texture.bake_tiled import bake_canvas_plain, bake_texture_tiled, compute_bake_binning

    nd = statics.dense.topo.dense_vertices.shape[0]
    t0 = time.perf_counter()
    binning = build_bake_binning(statics, TEX_RES, DEVICE)
    torch.cuda.synchronize()
    binning_s = time.perf_counter() - t0
    colors = torch.rand((nd, 3), device=DEVICE, generator=torch.Generator(DEVICE).manual_seed(21))
    _, err = compare_bake(binning, colors, TEX_RES, TEX_RES, f"{TEX_RES}x{TEX_RES}, density-{DENSITY} dense mesh")
    cull = bake_cull_counts(binning, TEX_RES, TEX_RES)
    log(
        f"K6 {TEX_RES}x{TEX_RES}: the per-warp cull skips {cull['culled_pairs']} of {cull['pairs']} (pixel, entry) "
        f"pairs ({100 * cull['culled_share']:.1f}%); entries per occupied tile: mean "
        f"{cull['entries_per_tile_mean']:.3f}, max {cull['entries_per_tile_max']}"
    )

    # coplanar overlap: the first triangle (red) keeps the tie
    verts = np.array([[2.3, 2.3, 0], [20.3, 2.3, 0], [2.3, 20.3, 0], [3.3, 3.3, 0], [21.3, 3.3, 0], [3.3, 21.3, 0]],
                     np.float32)
    b = compute_bake_binning(verts, np.array([[0, 1, 2], [3, 4, 5]]), 24, 24, device=DEVICE)
    tie_colors = torch.tensor([[1.0, 0, 0]] * 3 + [[0, 1.0, 0]] * 3, device=DEVICE)
    out, e2 = compare_bake(b, tie_colors, 24, 24, "coplanar overlap, 24x24")
    if not torch.equal(out[10, 10], tie_colors[0]):
        raise AssertionError(f"K6: the first of two coplanar triangles did not keep the tie: {out[10, 10]}")
    # one triangle over many 16-pixel tiles
    verts2 = np.array([[1.2, 1.2, 0.5], [61.7, 2.1, 0.5], [2.4, 60.8, 0.5]], np.float32)
    b2 = compute_bake_binning(verts2, np.array([[0, 1, 2]]), 64, 64, device=DEVICE)
    if b2.tile_ids.shape[0] != 16:
        raise AssertionError(f"the big triangle binned into {b2.tile_ids.shape[0]} tiles, not 16")
    _, e3 = compare_bake(b2, torch.tensor([[0.2, 0.4, 0.8]] * 3, device=DEVICE), 64, 64, "one triangle over 16 tiles")
    # more entries in one tile than one staging batch holds
    v4, t4 = make_crowded_bake_tile()
    b4 = compute_bake_binning(v4, t4, 36, 40, device=DEVICE)
    if int(b4.count.max()) <= 64:
        raise AssertionError(f"the crowded tile holds {int(b4.count.max())} entries, not more than two batches")
    c4 = torch.rand((v4.shape[0], 3), device=DEVICE, generator=torch.Generator(DEVICE).manual_seed(4))
    _, e4 = compare_bake(b4, c4, 36, 40, "a crowded tile, degenerate triangles and ties, 40x36")
    # partly off the canvas, through the wrapper that bins for itself, 93x91
    rng = np.random.default_rng(3)
    v3 = np.hstack([rng.uniform(-8, 100, (30, 2)), rng.uniform(-1, 1, (30, 1))]).astype(np.float32)
    t3 = np.arange(30).reshape(10, 3)
    c3 = torch.rand((30, 3), device=DEVICE, generator=torch.Generator(DEVICE).manual_seed(5))
    b3 = compute_bake_binning(v3, t3, 93, 91, device=DEVICE)
    _, e5 = compare_bake(b3, c3, 93, 91, "partly off a 91x93 canvas")
    if not torch.equal(bake_texture_tiled(v3, t3, c3, 93, 91, device=DEVICE), bake_canvas_plain(b3, c3, 93, 91)):
        raise AssertionError("K6 through bake_texture_tiled differs from the plain version")
    return max(err, e2, e3, e4, e5), (binning, binning_s, cull)


def phase_bake_timing(trainer, bake_inputs):
    """K6 and its plain version at 8192^2 on the fitted dense colors, K6's
    bound, each ``--ref`` build of K6 in turns with it, and the export's
    parts on the same canvas: its uint8 conversion and copy to the host,
    the PNG encode, the OBJ write."""
    from topo4d_tpu_torch import kernels
    from topo4d_tpu_torch.texture.bake_tiled import bake_canvas_cuda, bake_canvas_plain
    from topo4d_tpu_torch.topology.obj_io import write_obj_with_uv
    from topo4d_tpu_torch.utils.png import encode_png

    binning, binning_s, cull = bake_inputs
    colors = torch.clamp(trainer.texture_state.params["dense_rgb_colors"], 0.0, 1.0).contiguous()
    canvas = bake_canvas_cuda(binning, colors, TEX_RES, TEX_RES)
    ms_wrapper = cuda_ms(lambda: bake_canvas_cuda(binning, colors, TEX_RES, TEX_RES), iters=10)
    # the kernel alone, on a canvas allocated once (and pre-filled with NaN)
    out = torch.full_like(canvas, float("nan"))
    fn = kernels.kernel("uv_bake")
    args = bake_args(binning, colors, TEX_RES, TEX_RES, out)
    ms = cuda_ms(lambda: kernels.check(fn(*args), "uv_bake"), iters=10)
    if not torch.equal(out, canvas):
        raise AssertionError("K6 through its C entry point differs from its wrapper")
    ms_fill = cuda_ms(lambda: torch.zeros_like(canvas), iters=10)
    refs = {}
    for path, ref in REFS.get("uv_bake", {}).items():
        outs = {"new": torch.full_like(canvas, float("nan")), "ref": torch.full_like(canvas, float("nan"))}
        ref_args = bake_args(binning, colors, TEX_RES, TEX_RES, outs["ref"])

        def run_ref(ref=ref, ref_args=ref_args, path=path):
            kernels.check(ref(*ref_args), path)

        new_args = bake_args(binning, colors, TEX_RES, TEX_RES, outs["new"])
        calls = {"new": lambda: kernels.check(fn(*new_args), "uv_bake"), "ref": run_ref}
        for call in calls.values():
            call()
        torch.cuda.synchronize()
        for name, o in outs.items():
            if not torch.equal(o, canvas):
                raise AssertionError(f"K6: {path if name == 'ref' else 'uv_bake'} differs from K6's wrapper")
        mean, turns = in_turns(calls, 10)
        log(
            f"timing, K6 {TEX_RES}x{TEX_RES}: uv_bake alone {mean['new']:.4f} ms, {path} "
            f"{mean['ref']:.4f} ms ({mean['ref'] / mean['new']:.2f}x; "
            "turns " + ", ".join(f"{n} {t:.4f}" for n, t in turns) + "); canvases equal bit for bit"
        )
        refs[path] = {"ms": mean["ref"], "kernel_ms": mean["new"], "turns": turns}
    ms_plain = cuda_ms(lambda: bake_canvas_plain(binning, colors, TEX_RES, TEX_RES), iters=2, warmup=1)
    b_ms, by, pairs = bake_bound(binning, colors, TEX_RES, TEX_RES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = (canvas * 255).to(torch.uint8).cpu().numpy()
    to_host_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    png = encode_png(img)
    png_s = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    t0 = time.perf_counter()
    st = trainer.statics
    write_obj_with_uv(os.path.join(OUT_DIR, "timing.obj"), trainer.state.params["means3D"].cpu().numpy(), st.faces,
                      st.uvs, st.uv_faces)
    obj_s = time.perf_counter() - t0
    log(
        f"K6 {TEX_RES}x{TEX_RES}: {ms:.4f} ms (bound {b_ms:.4f} ms, {by}, {100 * b_ms / ms:.1f}%; {pairs} pixel-entry "
        f"pairs, {100 * cull['culled_share']:.1f}% of them culled); its wrapper (no fill) {ms_wrapper:.4f} ms; a "
        f"zero-fill of the canvas ({canvas.numel() * 4} B) {ms_fill:.4f} ms; plain {ms_plain:.3f} ms; host binning "
        f"{binning_s:.3f} s (once per sequence); uint8 conversion and copy to the host {to_host_ms:.3f} ms; PNG "
        f"encode {png_s:.3f} s ({len(png)} bytes); OBJ write {obj_s:.4f} s"
    )
    return {"ms": ms, "plain_ms": ms_plain, "bound_ms": b_ms, "bound_by": by, "wrapper_ms": ms_wrapper,
            "zero_fill_ms": ms_fill, "binning_s": binning_s, "to_host_ms": to_host_ms, "png_s": png_s,
            "obj_s": obj_s, "pairs": pairs, "cull": cull, "refs": refs}


def saturated_scene():
    """>80 nats of opacity inside one tile (tests/test_rasterizer_pallas.py:160)."""
    n = 64
    rng = np.random.default_rng(5)
    return {
        "means3D": rng.normal(0, 0.003, (n, 3)).astype(np.float32),
        "rgb_colors": rng.uniform(0.2, 0.8, (n, 3)).astype(np.float32),
        "unnorm_rotations": np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
        "logit_opacities": np.full((n, 1), 8.0, np.float32),
        "log_scales": np.full((n, 3), np.log(0.05), np.float32),
    }


def phase_kernels():
    from topo4d_tpu_torch.convert import params_from_numpy
    from topo4d_tpu_torch.core.gaussian import activate_params
    from topo4d_tpu_torch.testing import make_head_fixture, make_synthetic_camera

    params_np, cams, _ = make_head_fixture(device=DEVICE)
    rv = activate_params(params_from_numpy(params_np, DEVICE))
    errs = {}
    for span in (4, 2, 8):  # 8: several of K4's batches per block (tests/test_rasterizer_pallas.py:302)
        bins, binning, tx, ty = pack_view(rv, cams[0], span)
        errs[span] = compare_kernels(bins, binning, tx, ty, f"head scale, max_span {span}", seed=span)
    counts = pack_view(rv, cams[0], 4)[0].tile_count
    occ = int((counts > 0).sum())
    bins, binning, tx, ty = pack_view(rv, cams[0], 4, capacity=(occ + counts.shape[0]) // 2)  # padded, below the canvas
    errs["compact"] = compare_kernels(bins, binning, tx, ty, "head scale, compact", seed=11, compact=True)

    cam = make_synthetic_camera(width=64, height=48, device=DEVICE)
    rv_sat = activate_params(params_from_numpy(saturated_scene(), DEVICE))
    bins, binning, tx, ty = pack_view(rv_sat, cam, 8)
    errs["saturated"] = compare_kernels(bins, binning, tx, ty, "saturated windows", seed=6)
    bins, binning, tx, ty = pack_view(rv_sat, cam, 8, capacity=int((bins.tile_count > 0).sum()) + 2)
    errs["saturated compact"] = compare_kernels(bins, binning, tx, ty, "saturated windows, compact", seed=7,
                                                compact=True)

    shapes = ((15, FULL_H, FULL_W), (15, 512, 375)) + BLUR_EDGE_SHAPES
    errs["blur"] = max(compare_blur(shape, seed) for seed, shape in enumerate(shapes, start=1))
    return errs


def build_main_path(grid=(92, 90), size=(375, 512)):
    from topo4d_tpu_torch.config import Config
    from topo4d_tpu_torch.pipeline.data import SyntheticSequence
    from topo4d_tpu_torch.pipeline.scene import build_scene
    from topo4d_tpu_torch.pipeline.trainer import Trainer
    from topo4d_tpu_torch.testing import (
        grid_uvs,
        make_camera_ring,
        make_grid_mesh,
        make_head_fixture,
        make_synthetic_regions,
    )
    from topo4d_tpu_torch.topology.obj_io import MeshObj

    rows, cols = grid
    verts, faces = make_grid_mesh(rows, cols, extent=0.5)
    mesh = MeshObj(vertices=verts, uvs=grid_uvs(rows, cols), faces=faces, uv_faces=[list(f) for f in faces])
    regions = make_synthetic_regions(verts.shape[0], faces)
    cfg = Config()
    cfg.data.output_dir = OUT_DIR
    cfg.schedule.frame_num = FRAMES
    cfg.schedule.init_opt_num = INIT_ITERS
    cfg.schedule.ckp_freq = 1
    cfg.texture.gen_tex = True
    cfg.texture.density = DENSITY
    cfg.texture.tex_res = TEX_RES
    t0 = time.perf_counter()
    params_np, statics = build_scene(mesh, regions, cfg, num_views=24)
    nd = statics.dense.topo.dense_vertices.shape[0]
    log(
        f"scene: {verts.shape[0]} Gaussians, dense mesh at density {DENSITY}: {nd} dense Gaussians over "
        f"{statics.dense.topo.quad_faces.shape[0]} frontal quads, {statics.dense.tri_faces.shape[0]} dense "
        f"triangles ({time.perf_counter() - t0:.2f} s on the host)"
    )
    # the sequence's ground truth is the head fixture on the same mesh
    # (random colors, other scales and opacities), so the fit has work to do
    gt_params, cams, _ = make_head_fixture(rows, cols, width=size[0], height=size[1], device=DEVICE)
    cams_full = make_camera_ring(24, width=FULL_W, height=FULL_H, distance=2.0, device=DEVICE)
    src = SyntheticSequence(params=gt_params, cameras=cams, num_frames=FRAMES, cameras_full=cams_full)
    trainer = Trainer(cfg, src, params_np, statics, device=DEVICE)
    return cfg, src, trainer, (mesh, regions, gt_params, params_np)


def check_rows(rows):
    for r in rows:
        for k, v in r.items():
            if isinstance(v, (int, float)) and not np.isfinite(v):
                raise AssertionError(f"non-finite metric {k}={v} in {r}")


def check_counts(counts, name, expected):
    for k, n in expected.items():
        if counts[k] != n:
            raise AssertionError(f"{name}: {k} launched {counts[k]} times, expected {n} ({counts})")


def instrument(trainer):
    """Wrap the trainer's geometry and texture fits so that ``run`` records
    each part: its frame, wall seconds (to a synchronize), its own launches,
    its metric rows and, after a texture fit, a copy of the dense colors
    that frame's export bakes. -> the list the parts are appended to."""
    parts = []
    for kind in ("geometry", "texture"):
        fit = getattr(trainer, f"fit_frame_{kind}")

        def wrapped(t, frame, fit=fit, kind=kind):
            torch.cuda.synchronize()
            before, n_rows = read_counts(), len(trainer.metrics_log)
            t0 = time.perf_counter()
            m = fit(t, frame)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            after = read_counts()
            part = {"kind": kind, "frame": t, "wall": wall, "counts": {k: after[k] - before[k] for k in after},
                    "rows": trainer.metrics_log[n_rows:], "last": m}
            if kind == "texture":
                part["colors"] = trainer.texture_state.params["dense_rgb_colors"].clone()
            parts.append(part)
            return m

        setattr(trainer, f"fit_frame_{kind}", wrapped)
    return parts


def check_geometry_part(cfg, part):
    """A geometry fit: K1/K2 once and K5 twice per step, no plain version; a
    tracked frame's loss falls."""
    t, rows, m, counts = part["frame"], part["rows"], part["last"], part["counts"]
    steps = cfg.schedule.init_opt_num if t == 0 else cfg.schedule.opt_num
    check_rows(rows)
    log(
        f"geometry frame {t} ({'init' if t == 0 else 'track'}, {steps} steps): {part['wall']:.3f} s, "
        f"{part['wall'] / steps * 1e3:.3f} ms/step; loss {rows[0]['loss_total']:.6f} -> {m['loss_total']:.6f}, "
        f"psnr {m['psnr']:.3f}; launches {counts}"
    )
    if t > 0 and not rows[-1]["loss_total"] < rows[0]["loss_total"]:
        raise AssertionError(f"tracked frame's loss did not fall: {rows[0]} -> {rows[-1]}")
    check_counts(counts, f"geometry frame {t}", {
        "tile_blend_fwd": steps, "tile_blend_bwd": steps, "gauss_blur": 2 * steps,
        "tile_blend_plain": 0, "gauss_blur_plain": 0,
    })
    return steps


def check_texture_part(cfg, part):
    """A dense texture fit: K1/K2 once and K5 twice per step, K1 once more
    per eval render, no plain version, no tile dropped; view 0's PSNR
    rises."""
    t, rows, m, counts = part["frame"], part["rows"], part["last"], part["counts"]
    steps = cfg.schedule.dense_opt_num
    if t > 0 and cfg.schedule.dense_opt_num_tracked >= 0:
        steps = cfg.schedule.dense_opt_num_tracked
    check_rows(rows)
    evals = sum("tex_psnr_fixed" in r for r in rows)
    check_counts(counts, f"texture frame {t}", {
        "tile_blend_fwd": steps + evals, "tile_blend_bwd": steps, "gauss_blur": 2 * steps,
        "tile_blend_plain": 0, "gauss_blur_plain": 0,
    })
    overflow = [r["tex_num_tile_overflow"] for r in rows if "tex_num_tile_overflow" in r]
    if any(overflow):
        raise AssertionError(f"texture frame {t}: compact mode dropped tiles: {overflow}")
    log(
        f"texture frame {t}: {steps} steps at {FULL_W}x{FULL_H}: {part['wall']:.3f} s per dense frame, "
        f"{part['wall'] / steps * 1e3:.3f} ms per dense step (the frame's wall over its steps: binnings and {evals} "
        f"eval renders included); tex_psnr_fixed {rows[0]['tex_psnr_fixed']:.3f} -> {m['tex_psnr_fixed']:.3f}, loss "
        f"{rows[0]['tex_loss_total']:.6f} -> {rows[-2]['tex_loss_total']:.6f} (iteration {rows[-2]['iter']}); "
        f"launches {counts}"
    )
    if not m["tex_psnr_fixed"] > rows[0]["tex_psnr_fixed"]:
        raise AssertionError(f"dense fit of frame {t} did not improve view 0: {rows[0]} -> {m}")
    return steps


def phase_run(cfg, src, trainer, scene):
    """The main path: ``Trainer.run(resume=False)`` over ``FRAMES`` frames,
    the launches of the whole run and of each part, then its outputs and a
    second ``run(resume=True)`` that must do nothing."""
    from topo4d_tpu_torch.pipeline.checkpoint import load_params, load_resume
    from topo4d_tpu_torch.pipeline.trainer import Trainer
    from topo4d_tpu_torch.texture.bake_tiled import bake_canvas_cuda

    shutil.rmtree(OUT_DIR, ignore_errors=True)
    parts = instrument(trainer)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    trainer.run(resume=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    out = os.path.join(cfg.data.output_dir, cfg.data.exp, cfg.data.seq)
    with open(os.path.join(out, "timings.json")) as fh:
        timings = json.load(fh)
    steps = {"geometry": [], "texture": []}
    for part in parts:
        check = check_geometry_part if part["kind"] == "geometry" else check_texture_part
        steps[part["kind"]].append(check(cfg, part))
    if [p["frame"] for p in parts] != [t for t in range(FRAMES) for _ in (0, 1)]:
        raise AssertionError(f"the run's parts: {[(p['kind'], p['frame']) for p in parts]}")
    n_steps = sum(steps["geometry"]) + sum(steps["texture"])
    evals = sum("tex_psnr_fixed" in r for p in parts if p["kind"] == "texture" for r in p["rows"])
    check_counts(counts, "Trainer.run", {
        "tile_blend_fwd": n_steps + evals, "tile_blend_bwd": n_steps, "gauss_blur": 2 * n_steps,
        "uv_bake": FRAMES, "tile_blend_v3_fwd": 0, "tile_blend_v3_bwd": 0, "tile_blend_plain": 0,
        "gauss_blur_plain": 0, "uv_bake_plain": 0,
    })
    log(
        f"Trainer.run, {FRAMES} frames: {wall:.3f} s; launches {counts}; timings.json "
        + ", ".join(f"{k} {v['seconds']:.3f} s over {v['count']}" for k, v in timings.items())
    )

    # the outputs
    def f_lines(t):
        with open(os.path.join(out, "%06d" % (t + 1), "face.obj")) as fh:
            return [line for line in fh if line.startswith("f ")]

    topo = [f_lines(t) for t in range(FRAMES)]
    if not topo[0] or any(x != topo[0] for x in topo):
        raise AssertionError("face.obj topology differs between frames")
    texture_parts = [p for p in parts if p["kind"] == "texture"]
    for part in texture_parts:
        t = part["frame"]
        png = read_png(os.path.join(out, "%06d" % (t + 1), "face.png"))
        colors = torch.clamp(part["colors"], 0.0, 1.0)
        want = (bake_canvas_cuda(trainer._bake_binning, colors, TEX_RES, TEX_RES) * 255).to(torch.uint8).cpu().numpy()
        if not np.array_equal(png, want):
            raise AssertionError(f"frame {t}: face.png differs from K6's bytes in {int((png != want).sum())} values")
    params = load_params(os.path.join(out, "params.npz"))
    state = trainer.state.params
    for k, v in state.items():
        shape = ((FRAMES,) if k in ("means3D", "rgb_colors", "unnorm_rotations") else ()) + tuple(v.shape)
        if params[k].shape != shape or params[k].dtype != np.float32:
            raise AssertionError(f"params.npz {k}: {params[k].shape} {params[k].dtype}, expected {shape} float32")
    if set(params) != set(state):
        raise AssertionError(f"params.npz keys {sorted(params)} against {sorted(state)}")
    if load_resume(out)["frame"] != FRAMES:
        raise AssertionError("resume.pkl does not point past the last frame")
    stamps = {f: os.path.getmtime(os.path.join(out, "%06d" % (t + 1), f)) for t in range(FRAMES)
              for f in ("face.obj", "face.png")}

    # a second run resumes past the last frame and does nothing
    _, _, _, params_np = scene
    again = Trainer(cfg, src, params_np, trainer.statics, device=DEVICE)
    reset_counts()
    again.run(resume=True)
    torch.cuda.synchronize()
    if any(read_counts().values()):
        raise AssertionError(f"the resumed run launched kernels: {read_counts()}")
    if {f: os.path.getmtime(os.path.join(out, "%06d" % (t + 1), f)) for t in range(FRAMES)
            for f in ("face.obj", "face.png")} != stamps:
        raise AssertionError("the resumed run rewrote a frame's export")
    if any(not torch.equal(again.state.params[k], v) for k, v in state.items()):
        raise AssertionError("the resumed run's state differs from the checkpointed one")
    log(
        f"outputs: face.obj f-lines identical over {FRAMES} frames ({len(topo[0])} faces); each face.png equals "
        f"K6's bytes for its frame; params.npz keys and shapes as the JAX package writes them; resume.pkl at frame "
        f"{FRAMES}; a second run(resume=True) restored the state and launched nothing"
    )
    geo = [p for p in parts if p["kind"] == "geometry"]
    return {
        "counts": counts, "timings": timings, "wall": wall, "parts": parts,
        "geo_ms_per_step": sum(p["wall"] for p in geo) / sum(steps["geometry"]) * 1e3,
        "tracked_frame_s": geo[-1]["wall"], "dense_frame_s": [p["wall"] for p in texture_parts],
        "psnr_fixed": texture_parts[-1]["last"]["tex_psnr_fixed"],
    }


def to_device(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: to_device(v, dev) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_device(v, dev) for v in x))
    return x


def camera_to(cams, dev):
    from topo4d_tpu_torch.core.camera import Camera

    return Camera(
        w2c=cams.w2c.to(dev), fx=cams.fx.to(dev), fy=cams.fy.to(dev), cx=cams.cx.to(dev), cy=cams.cy.to(dev),
        width=cams.width, height=cams.height, near=cams.near, far=cams.far,
    )


def assert_leaf_close(name, a, b, bound):
    """Every element within ``bound``, 99.9% within 1e-6 -> summary."""
    d = (a - b).abs()
    within = float((d <= 1e-6).float().mean())
    msg = f"{name} max|d| {float(d.max()):.2e} (bound {bound:.1e}) {within * 100:.3f}% within 1e-6"
    if float(d.max()) > bound + 1e-6 or within < 0.999:
        raise AssertionError(f"card vs CPU: {msg}")
    return msg


def phase_card_vs_cpu(cfg, trainer, frame):
    """Five track steps from the same state and view order, card vs CPU."""
    from topo4d_tpu_torch.opt.adam import AdamState
    from topo4d_tpu_torch.opt.step import TrainState, make_geometry_step
    from topo4d_tpu_torch.pipeline.data import view_order
    from topo4d_tpu_torch.pipeline.scene import build_constraints
    from topo4d_tpu_torch.pipeline.trainer import make_render_fn

    st = trainer.statics
    n = trainer.state.params["means3D"].shape[0]
    cpu_step = make_geometry_step(
        st.quadruples, st.umbrellas, make_render_fn(cfg, "cpu"), n,
        ring_indices=st.ring.indices, device="cpu",
    )
    cams = trainer.source.cameras
    images = torch.as_tensor(frame.images)
    runs = {}
    for dev, step, cm, con in (
        (DEVICE, trainer.step, cams, trainer._constraints("track")),
        ("cpu", cpu_step, camera_to(cams, "cpu"),
         build_constraints("track", trainer.params0, st.regions, trainer.first_frame_attrs, "cpu")),
    ):
        state = TrainState(
            params=to_device(trainer.state.params, dev),
            opt=AdamState(dict(trainer.state.opt.step), to_device(trainer.state.opt.mu, dev), to_device(trainer.state.opt.nu, dev)),
            max_2d_radius=to_device(trainer.state.max_2d_radius, dev),
        )
        priors = to_device(trainer.priors, dev)
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
    worst = [assert_leaf_close(k, runs[DEVICE][1][k], pc, 2 * lr[k] * 5) for k, pc in runs["cpu"][1].items()]
    log(f"card vs CPU, 5 track steps: loss rel err {float(np.max(np.abs(lg - lc) / np.abs(lc))):.2e}; " + "; ".join(worst))


def phase_texture_card_vs_cpu(cfg, trainer, scene, steps: int = 3):
    """Three texture steps at 480x270 on a density-1 dense mesh of the same
    head grid, card vs CPU, from the same state and views. Colors: every
    entry within 2 lr steps, 99.9% within 1e-6. The dense Gaussians are
    isotropic, so their rotations' gradients are rounding noise and are
    compared through the conics they give."""
    import copy

    from topo4d_tpu_torch.core.gaussian import activate_params, project_gaussians
    from topo4d_tpu_torch.opt.adam import adam_init
    from topo4d_tpu_torch.pipeline.scene import build_dense_pre_constraints, build_scene, init_dense_params
    from topo4d_tpu_torch.pipeline.trainer import make_dense_render_fn
    from topo4d_tpu_torch.rasterizer.render import attach_compact, binning_for, render_gaussians
    from topo4d_tpu_torch.testing import make_camera_ring
    from topo4d_tpu_torch.texture.dense import TextureState, dense_rendervars, make_texture_step
    from topo4d_tpu_torch.topology.interpolate import interpolate_dense_attribute

    mesh, regions, gt_params, _ = scene
    cfg1 = copy.deepcopy(cfg)
    cfg1.texture.density = 1
    _, st1 = build_scene(mesh, regions, cfg1, num_views=24)
    geo = {k: v.detach().cpu().numpy() for k, v in trainer.state.params.items()}
    dense_np = init_dense_params(geo, st1, 24)
    topo = st1.dense.topo
    views = (0, 1, 2)
    cams = make_camera_ring(24, width=480, height=270, distance=2.0, device=DEVICE)
    with torch.no_grad():
        rv_gt = activate_params({k: torch.as_tensor(v, device=DEVICE) for k, v in gt_params.items()})
        targets = {v: render_gaussians(rv_gt, cams[v], max_span=4).image for v in views}
    cap = None
    runs = {}
    for dev in (DEVICE, "cpu"):
        cm = camera_to(cams, dev)
        params = {k: torch.as_tensor(v, device=dev) for k, v in dense_np.items()}
        means = interpolate_dense_attribute(
            torch.as_tensor(geo["means3D"], device=dev),
            *(torch.as_tensor(a, device=dev) for a in (topo.quad_faces, topo.father_face, topo.weights)),
        )
        rv = dense_rendervars(params, means)
        bs = {v: binning_for(rv, cm[v], cfg.raster.max_span, with_static=True) for v in views}
        if cap is None:  # the trainer's auto capacity (quantum 64 below 8,192 tiles), from the card's binnings
            occ = max(int((b.tile_count > 0).sum()) for b in bs.values())
            cap = -(-int(occ * 1.2) // 64) * 64
        bs = {v: attach_compact(b, cap) for v, b in bs.items()}
        step = make_texture_step(make_dense_render_fn(cfg, dev))
        state = TextureState(params=params, opt=adam_init(params))
        anchor = params["dense_rgb_colors"]
        pre = build_dense_pre_constraints(dense_np, regions, dev)
        losses = []
        for v in views:
            state, m = step(state, means, targets[v].to(dev), cm, v, anchor, pre, dict(cfg.lrs.dense),
                            cfg.dense_weights.as_dict(), bs[v], with_metrics=False)
            losses.append(float(m["loss_total"]))
        runs[dev] = (losses, {k: v.cpu() for k, v in state.params.items()}, means.cpu())
    lc, lg = np.array(runs["cpu"][0]), np.array(runs[DEVICE][0])
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    lr = cfg.lrs.dense
    msgs = [assert_leaf_close(k, runs[DEVICE][1][k], runs["cpu"][1][k], 2 * lr[k] * steps)
            for k in ("dense_rgb_colors", "dense_logit_opacities", "dense_log_scales")]
    cam0 = camera_to(cams, "cpu")[0]
    conics = []
    for dev in (DEVICE, "cpu"):
        with torch.no_grad():
            conics.append(project_gaussians(dense_rendervars(runs[dev][1], runs["cpu"][2]), cam0).conics)
    cerr = float(((conics[0] - conics[1]).abs() / conics[1].abs().clamp(min=1e-3)).max())
    torch.testing.assert_close(conics[0], conics[1], rtol=1e-4, atol=1e-5)
    log(
        f"card vs CPU, {steps} texture steps at 480x270 ({dense_np['dense_rgb_colors'].shape[0]} dense Gaussians, "
        f"views {views}, capacity {cap}): loss rel err {float(np.max(np.abs(lg - lc) / np.abs(lc))):.2e}; "
        + "; ".join(msgs) + f"; conics of the learned rotations max rel err {cerr:.2e}"
    )


REFS = {}  # kernel symbol -> {path: ctypes function}


def load_ref(symbol, path):
    """Build ``path``, a source of kernel ``symbol`` (an earlier commit's
    file, or a variant), with the kernels' nvcc flags and ``csrc/`` on the
    include path into ``build/``, log what ``-Xptxas -v`` says and load it
    -> its ctypes function, which must take the kernel's C interface."""
    import hashlib
    import re

    from topo4d_tpu_torch import kernels

    if symbol not in ("tile_blend_fwd", "tile_blend_v3_fwd", "uv_bake"):
        raise ValueError(f"--ref {symbol}={path}: only tile_blend_fwd, tile_blend_v3_fwd and uv_bake take a reference")
    src = os.path.abspath(path)
    with open(src, "rb") as fh:
        text = fh.read()
    sig = re.search(rb'extern "C" int ' + symbol.encode() + rb"\(([^)]*)\)", text)
    if sig is None:
        raise ValueError(f"--ref {symbol}={path}: the source has no extern \"C\" {symbol}")
    params = sig.group(1).count(b",") + 1
    argtypes = kernels.KERNELS[symbol][1]
    if params != len(argtypes):
        raise ValueError(f"--ref {symbol}={path}: {params} parameters, the kernel takes {len(argtypes)}")
    digest = hashlib.sha256(text + " ".join(kernels.NVCC_FLAGS).encode()).hexdigest()[:12]
    out = kernels.BUILD_DIR / f"ref_{symbol}-{digest}.so"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-Xptxas", "-v", "-o",
                           str(out), src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"--ref {symbol}={path}: build failed:\n{proc.stdout}{proc.stderr}")
    log(f"[nvcc] --ref {symbol}={path}\n{(proc.stdout + proc.stderr).strip()}")
    fn = getattr(ctypes.CDLL(str(out)), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def in_turns(calls, iters: int):
    """Time ``calls["new"]`` and ``calls["ref"]`` in turns (ref, new, new,
    ref) -> ({"new": ms, "ref": ms} means, [(name, ms), ...])."""
    turns = [(name, cuda_ms(calls[name], iters=iters)) for name in ("ref", "new", "new", "ref")]
    return {n: float(np.mean([t for m, t in turns if m == n])) for n in calls}, turns


def time_blend_refs(symbol, want, row_args, stream, label: str, iters: int):
    """K1 or K4f (``symbol``; ``row_args`` its C arguments before the
    output) and each ``--ref`` build of it, each alone on an output
    allocated once, in turns on the same rows; every output's rows 0-5 must
    equal ``want``'s (K1's wrapper) bit for bit -> {path: {"ms", "kernel_ms",
    "turns"}}."""
    from topo4d_tpu_torch import kernels

    new = kernels.kernel(symbol)
    res = {}
    for path, ref in REFS.get(symbol, {}).items():
        outs = {"new": torch.empty_like(want), "ref": torch.empty_like(want)}
        calls = {
            "new": lambda: kernels.check(new(*row_args, outs["new"].data_ptr(), stream), symbol),
            "ref": lambda ref=ref: kernels.check(ref(*row_args, outs["ref"].data_ptr(), stream), path),
        }
        for call in calls.values():
            call()
        torch.cuda.synchronize()
        for name, o in outs.items():
            if not torch.equal(o[:, :6], want[:, :6]):
                raise AssertionError(f"{label}: {path if name == 'ref' else symbol} differs from K1 in rows 0-5")
        mean, turns = in_turns(calls, iters)
        log(
            f"timing, {label}: {symbol} alone {mean['new']:.4f} ms, {path} alone {mean['ref']:.4f} ms "
            f"({mean['ref'] / mean['new']:.2f}x; turns " + ", ".join(f"{n} {t:.4f}" for n, t in turns)
            + "); rows 0-5 equal K1's bit for bit"
        )
        res[path] = {"ms": mean["ref"], "kernel_ms": mean["new"], "turns": turns}
    return res


def time_blend(bins, binning, tx, ty, compact: bool, label: str, iters: int, plain_iters: int, seed: int):
    """K1 and K2 on one view's rows (every tile of the canvas, or the
    compact list): the kernels' times, K2's wrapper with its dpacked
    zero-fill and the fill alone, the plain version's forward and forward
    plus autograd backward, and this run's bounds; then K4f and K4b (the
    same work, so the same bounds) at each of ``V3_TPS``, K4b like K2
    without its wrapper's zero-fill -> {"fwd": ..., "bwd": ..., "v3": {tps:
    {"fwd_ms", "bwd_ms"}}}."""
    from topo4d_tpu_torch import kernels
    from topo4d_tpu_torch.rasterizer.blend import tile_blend_bwd_cuda, tile_blend_fwd_cuda, tile_blend_v3_fwd_cuda

    packed = bins.packed
    start, count, ids = blend_rows(bins, binning, tx, ty, compact)
    kid = ids if compact else None
    out = tile_blend_fwd_cuda(packed, start, count, tx, ty, kid)
    g_out = torch.randn(out.shape, device=out.device, generator=torch.Generator("cuda").manual_seed(seed))
    ms_fwd = cuda_ms(lambda: tile_blend_fwd_cuda(packed, start, count, tx, ty, kid), iters=iters)
    # K2 alone, on a dpacked allocated and zeroed once; the wrapper's
    # zero-fill of the whole (16, E_pad) dpacked is timed on its own
    k2 = kernels.kernel("tile_blend_bwd")
    dpacked = torch.zeros_like(packed)
    stream = torch.cuda.current_stream().cuda_stream
    k2_args = (
        packed.data_ptr(), packed.shape[1], start.data_ptr(), count.data_ptr(),
        None if kid is None else kid.data_ptr(), tx, start.shape[0],
        out.data_ptr(), g_out.data_ptr(), dpacked.data_ptr(), stream,
    )
    ms_bwd = cuda_ms(lambda: kernels.check(k2(*k2_args), "tile_blend_bwd"), iters=iters)
    ms_zero = cuda_ms(lambda: torch.zeros_like(packed), iters=iters)
    ms_bwd_wrapper = cuda_ms(lambda: tile_blend_bwd_cuda(packed, start, count, out, g_out, tx, ty, kid), iters=iters)
    ms_plain_fwd = cuda_ms(lambda: plain_blend(packed, start, count, tx, ty, ids), iters=plain_iters, warmup=1)
    ms_plain_bwd = cuda_ms(lambda: plain_blend(packed, start, count, tx, ty, ids, g_out), iters=plain_iters, warmup=1)
    bf, byf, bb, byb = blend_bounds(packed, start, count, tx, ids, out, compact)
    refs = time_blend_refs("tile_blend_fwd", out, k2_args[:7], stream, label, iters)
    k4b = kernels.kernel("tile_blend_v3_bwd")
    v3 = {}
    for tps in V3_TPS:
        fwd_ms = cuda_ms(lambda: tile_blend_v3_fwd_cuda(packed, start, count, tx, ty, kid, tps), iters=iters)
        k4b_args = k2_args[:7] + (tps,) + k2_args[7:]
        bwd_ms = cuda_ms(lambda: kernels.check(k4b(*k4b_args), "tile_blend_v3_bwd"), iters=iters)
        v3_refs = time_blend_refs("tile_blend_v3_fwd", out, k2_args[:7] + (tps,), stream, f"{label}, K4f tps {tps}",
                                  iters)
        v3[tps] = {"fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "fwd_refs": v3_refs}
    v3_msg = "; ".join(
        f"K4 tps {tps}: K4f {v['fwd_ms']:.4f} ms ({100 * bf / v['fwd_ms']:.1f}% of the bound, {v['fwd_ms'] / ms_fwd:.2f}x "
        f"K1), K4b {v['bwd_ms']:.4f} ms ({100 * bb / v['bwd_ms']:.1f}%, {v['bwd_ms'] / ms_bwd:.2f}x K2)"
        for tps, v in v3.items()
    )
    log(
        f"timing, {label} ({int((count > 0).sum())} non-empty of {start.shape[0]} rows, {tx * ty} tiles; "
        f"E_pad {packed.shape[1]}, entries in ranges {int(count.sum())}): K1 {ms_fwd:.4f} ms (bound {bf:.4f} ms, "
        f"{byf}, {100 * bf / ms_fwd:.1f}%), K2 {ms_bwd:.4f} ms (bound {bb:.4f} ms, {byb}, {100 * bb / ms_bwd:.1f}%); "
        f"K2 wrapper with its dpacked zero-fill {ms_bwd_wrapper:.4f} ms, zero-fill alone ({packed.numel() * 4} B) "
        f"{ms_zero:.4f} ms; plain fwd {ms_plain_fwd:.3f} ms, plain fwd+bwd {ms_plain_bwd:.3f} ms "
        f"({ROWS_PER_CHUNK} rows per call); {v3_msg}"
    )
    return {
        "v3": v3,
        "fwd": {"ms": ms_fwd, "plain_ms": ms_plain_fwd, "bound_ms": bf, "bound_by": byf, "refs": refs},
        "bwd": {"ms": ms_bwd, "plain_ms": ms_plain_bwd, "bound_ms": bb, "bound_by": byb,
                "wrapper_ms": ms_bwd_wrapper, "zero_fill_ms": ms_zero},
    }


def phase_timing(trainer):
    """K1/K2 at the geometry main path's shapes (view 0 of the trained
    state, full canvas)."""
    from topo4d_tpu_torch.core.gaussian import activate_params

    cam = trainer.source.cameras[0]
    bins, binning, tx, ty = pack_view(activate_params(trainer.state.params), cam, trainer.cfg.raster.max_span)
    label = "geometry shapes (view 0, trained params)"
    compare_kernels(bins, binning, tx, ty, label, seed=9)
    return time_blend(bins, binning, tx, ty, False, label, iters=50, plain_iters=5, seed=0)


def blend_bounds(packed, start, count, tx, ids, out, compact: bool):
    """K1's and K2's bounds from what this run's data needs them to move and
    compute -> (K1 ms, by, K2 ms, by)."""
    from topo4d_tpu_torch.rasterizer.blend import PX

    evaluated, contributing, k1_entries = pair_counts(packed, start, count, tx, ids)
    last = out[:, 5].long()  # entries up to each pixel's last contributor
    last_total = int(last.sum())  # pairs K2 visits
    k2_entries = int(last.amax(-1).sum())  # entries K2 reads and writes: per tile, up to its furthest pixel
    rows = start.shape[0]
    f4 = 4
    entry_b = 10 * f4  # the ten field rows (0-5, 8-11) of one entry
    ranges_b = (3 if compact else 2) * rows * f4  # start, count, and the tile map in compact mode
    row_b = rows * PX * f4  # one row of an (R, 8, 256) tile buffer
    fwd_bytes = k1_entries * entry_b + ranges_b + 8 * row_b  # writes all 8 rows
    # reads fwd rows 4-5 and g_out rows 0-4, writes the ten rows of the entries it visits
    bwd_bytes = 2 * k2_entries * entry_b + ranges_b + (2 + 5) * row_b
    # FP32 operations per (pixel, entry) pair, counted from the kernel sources
    fwd_ops = 16 * evaluated + 11 * contributing
    bwd_ops = 16 * (last_total - contributing) + 55 * contributing
    return (*bound(fwd_bytes, fwd_ops), *bound(bwd_bytes, bwd_ops))


def phase_texture_timing(trainer, errs):
    """K1/K2 at one 4K dense view (view 0 of the fitted dense state):
    compact against the plain version, then the times and bounds of the
    compact rows and of the full canvas; K5, its plain version and cuDNN's
    depthwise convolution at both blur shapes."""
    import torch.nn.functional as F

    from topo4d_tpu_torch import kernels
    from topo4d_tpu_torch.losses.blur import _gaussian_1d, gauss_blur_cuda, gauss_blur_plain
    from topo4d_tpu_torch.rasterizer.blend import tile_blend_fwd_cuda
    from topo4d_tpu_torch.texture.dense import dense_rendervars

    rv = dense_rendervars(trainer.texture_state.params, trainer.dense_means3d)
    cam = trainer.source.cameras_full[0]
    bins, binning, tx, ty = pack_view(rv, cam, trainer.cfg.raster.max_span, trainer._auto_tile_cap, with_static=True)
    errs["dense"] = compare_kernels(bins, binning, tx, ty, "4K dense view 0, compact", seed=12, compact=True)
    blend = time_blend(bins, binning, tx, ty, True, "4K dense view 0, compact", iters=20, plain_iters=2, seed=1)
    start, count, ids = blend_rows(bins, binning, tx, ty, True)
    out = tile_blend_fwd_cuda(bins.packed, start, count, tx, ty, ids)
    blend["warp_share"] = warp_entry_share(bins.packed, start, count, tx, ids, out)
    log("4K dense view 0, compact: visited (entry, warp) pairs in which a lane contributes: " + "; ".join(
        f"warps of {k} {v['with_a_contributor']} of {v['visited']} "
        f"({100 * v['with_a_contributor'] / v['visited']:.1f}%"
        + (f"; culled by the bounding box {v['culled']}, {100 * v['culled'] / v['visited']:.1f}%" if "culled" in v
           else "") + ")"
        for k, v in blend["warp_share"].items()))
    time_blend(bins, binning, tx, ty, False, "4K dense view 0, full canvas", iters=20, plain_iters=2, seed=1)

    taps = torch.as_tensor(_gaussian_1d(11, 1.5), device=DEVICE)
    taps_c = (ctypes.c_float * 11)(*_gaussian_1d(11, 1.5).tolist())
    k5 = kernels.kernel("gauss_blur")
    blur = {}
    for shape in ((15, FULL_H, FULL_W), (15, 512, 375)):
        ch = shape[0]
        x = torch.rand(shape, device=DEVICE, generator=torch.Generator(DEVICE).manual_seed(3))
        wv = taps.view(1, 1, 11, 1).expand(ch, 1, 11, 1).contiguous()
        wh = taps.view(1, 1, 1, 11).expand(ch, 1, 1, 11).contiguous()

        def cudnn(x=x, wv=wv, wh=wh, ch=ch):
            return F.conv2d(F.conv2d(x[None], wv, padding=(5, 0), groups=ch), wh, padding=(0, 5), groups=ch)[0]

        torch.testing.assert_close(cudnn(), gauss_blur_plain(x), rtol=1e-5, atol=1e-6)
        ms = cuda_ms(lambda: gauss_blur_cuda(x), iters=20)
        # the kernel alone through its C entry point, on an output allocated
        # once (as K2 and K6 are timed beside their wrappers): at (15, 512,
        # 375) the wrapper's host work per call is as long as the kernel
        out = torch.empty_like(x)
        args = (x.data_ptr(), out.data_ptr(), *shape, ctypes.addressof(taps_c), torch.cuda.current_stream().cuda_stream)
        ms_kernel = cuda_ms(lambda: kernels.check(k5(*args), "gauss_blur"), iters=20)
        if not torch.equal(out, gauss_blur_cuda(x)):
            raise AssertionError("K5 through its C entry point differs from its wrapper")
        ms_plain = cuda_ms(lambda: gauss_blur_plain(x), iters=5, warmup=1)
        ms_lib = cuda_ms(cudnn, iters=20)
        b, by = bound(2 * x.numel() * 4, 42 * x.numel())
        blur[shape] = {"ms": ms, "plain_ms": ms_plain, "library_ms": ms_lib, "bound_ms": b, "bound_by": by,
                       "kernel_ms": ms_kernel}
        log(
            f"K5 {shape}: {ms:.4f} ms through its wrapper (bound {b:.4f} ms, {by}, {100 * b / ms:.1f}%; the kernel "
            f"alone on an output allocated once {ms_kernel:.4f} ms, {100 * b / ms_kernel:.1f}%), plain {ms_plain:.3f} "
            f"ms, cuDNN depthwise conv2d (vertical then horizontal, TF32 off) {ms_lib:.4f} ms"
        )
    return blend, blur


def device_profile(run, steps: int, label: str, symbols):
    """Device busy share and kernel time of ``run()`` (``steps`` steps).

    ``run`` goes twice: once without the profiler, for the wall time, and
    once under ``torch.profiler``, for the device time of each kernel
    (CUPTI's device timestamps, which the profiler's host overhead does not
    stretch). The busy share is the profiled device time over the
    unprofiled wall time.
    """
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_prof_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = Counter()
    for e in kernels:
        by_name[e.name[:60]] += e.time_range.elapsed_us() / 1e3

    def kernel_ms(symbol):
        return sum(e.time_range.elapsed_us() for e in kernels if symbol in e.name) / 1e3 / steps

    top = ", ".join(f"{n} {t / steps:.3f}" for n, t in by_name.most_common(8))
    ks = {s: kernel_ms(s) for s in symbols}
    ours = sum(ks.values())
    log(
        f"profile of {steps} {label} steps: {wall_ms / steps:.3f} ms/step wall without the profiler "
        f"({wall_prof_ms / steps:.3f} with it); device busy {busy_ms / steps:.3f} ms/step, "
        f"{100 * busy_ms / wall_ms:.1f}% of the unprofiled wall (idle {100 - 100 * busy_ms / wall_ms:.1f}%); "
        f"{len(kernels) / steps:.0f} device activities/step; "
        + ", ".join(f"{s} {v:.4f}" for s, v in ks.items())
        + f" ms/step ({100 * ours * steps / busy_ms:.1f}% of busy, {100 * ours * steps / wall_ms:.2f}% of wall); "
        f"top ms/step: {top}"
    )
    return wall_ms / steps, busy_ms / steps


def phase_profile(trainer, frame, steps: int = 10):
    """Ten track steps from the trained state (discarded)."""
    from topo4d_tpu_torch.pipeline.data import view_order

    images = torch.as_tensor(frame.images, device=DEVICE)
    args = (trainer._constraints("track"), trainer.lrs_for("track"), trainer.weights_for("track"), "track")
    cams = trainer.source.cameras
    order = [int(v) for v in view_order(24, steps + 2, seed=3)]

    def run(views):
        state, priors = trainer.state, trainer.priors
        for vid in views:
            state, priors, _ = trainer.step(state, images[vid], cams, vid, priors, *args, with_metrics=False)

    run(order[:2])  # warm
    device_profile(lambda: run(order[2:]), steps, "track",
                   ("tile_blend_fwd_kernel", "tile_blend_bwd_kernel", "gauss_blur_kernel"))


def phase_profile_dense(trainer, frame_full, steps: int = 10):
    """Ten dense steps from the fitted dense state (discarded), with the
    frozen compact tile lists and then with the same binnings on the full
    canvas (what ``texture.tile_capacity = 0`` runs) -> {mode: (wall ms,
    busy ms) per step}."""
    from topo4d_tpu_torch.pipeline.data import view_order

    cfg = trainer.cfg
    images = torch.as_tensor(frame_full.images, device=DEVICE)
    cams = trainer.source.cameras_full
    bs = trainer.dense_binnings(0)
    modes = {"compact": bs, "full canvas": [b._replace(compact=None) for b in bs]}
    order = [int(v) for v in view_order(24, steps + 2, seed=4)]
    lr, w = dict(cfg.lrs.dense), cfg.dense_weights.as_dict()

    def run(views, binnings):
        state = trainer.texture_state
        for v in views:
            state, _ = trainer.texture_step(state, trainer.dense_means3d, images[v], cams, v, trainer.dense_anchor,
                                            trainer._dense_pre, lr, w, binnings[v], with_metrics=False)

    out = {}
    for mode, binnings in modes.items():
        run(order[:2], binnings)  # warm
        out[mode] = device_profile(lambda b=binnings: run(order[2:], b), steps, f"dense ({mode})",
                                   ("tile_blend_fwd_kernel", "tile_blend_bwd_kernel", "gauss_blur_kernel"))
    return out


def phase_v3(trainer, frames, steps: int = 10):
    """The v3 path: ``steps`` geometry steps at 375x512 through a render_fn
    that passes ``variant="v3"``, and ``steps`` dense texture steps on the
    4K dense view 0 through its frozen compact binning
    (scripts/probe_dense_v3.py:79-86), each beside the same steps through
    ``variant="auto"`` from the same state, in turns (auto, v3, v3, auto):
    the losses equal bit for bit; K4 and no K1/K2 launched on the v3
    side, the reverse on the auto side; then a profile of each variant's
    steps -> {path: {variant: ms per step},
    "counts": the first v3 run's launches per path}."""
    from topo4d_tpu_torch.opt.step import make_geometry_step
    from topo4d_tpu_torch.pipeline.data import view_order
    from topo4d_tpu_torch.rasterizer.render import render_gaussians
    from topo4d_tpu_torch.texture.dense import dense_rendervars, make_texture_step

    cfg, st = trainer.cfg, trainer.statics
    span = cfg.raster.max_span
    bg = torch.as_tensor(cfg.raster.bg, dtype=torch.float32, device=DEVICE)
    n = trainer.state.params["means3D"].shape[0]
    last_geo, last_tex = frames[FRAMES]
    geo_images = torch.as_tensor(last_geo.images, device=DEVICE)
    cams, cams_full = trainer.source.cameras, trainer.source.cameras_full
    order = [int(v) for v in view_order(24, steps, seed=5)]
    geo_args = (trainer._constraints("track"), trainer.lrs_for("track"), trainer.weights_for("track"), "track")
    rv = dense_rendervars(trainer.texture_state.params, trainer.dense_means3d)
    binning = pack_view(rv, cams_full[0], span, trainer._auto_tile_cap, with_static=True)[1]
    tex_image = torch.as_tensor(last_tex.images[0], device=DEVICE)
    tex_args = (trainer.dense_anchor, trainer._dense_pre, dict(cfg.lrs.dense), cfg.dense_weights.as_dict(), binning)

    def geo_step(variant):
        def render(rv, cam):
            return render_gaussians(rv, cam, bg=bg, max_span=span, variant=variant)

        step = make_geometry_step(st.quadruples, st.umbrellas, render, n, ring_indices=st.ring.indices, device=DEVICE)

        def run():
            state, priors, losses = trainer.state, trainer.priors, []
            for vid in order:
                state, priors, m = step(state, geo_images[vid], cams, vid, priors, *geo_args, with_metrics=False)
                losses.append(m["loss_total"])
            return losses

        return run

    def tex_step(variant):
        def render(rv, cam, b):
            return render_gaussians(rv, cam, bg=bg, max_span=span, binning=b, variant=variant)

        step = make_texture_step(render)

        def run():
            state, losses = trainer.texture_state, []
            for _ in range(steps):
                state, m = step(state, trainer.dense_means3d, tex_image, cams_full, 0, *tex_args, with_metrics=False)
                losses.append(m["loss_total"])
            return losses

        return run

    kernels_of = {"auto": ("tile_blend_fwd", "tile_blend_bwd"), "v3": ("tile_blend_v3_fwd", "tile_blend_v3_bwd")}
    out = {"counts": {}}
    for path, make in (("geometry", geo_step), (f"dense {FULL_W}x{FULL_H} view 0", tex_step)):
        runs = {v: make(v) for v in ("auto", "v3")}
        losses, ms = {}, {"auto": [], "v3": []}
        for variant in ("auto", "v3", "v3", "auto"):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            got = runs[variant]()
            torch.cuda.synchronize()
            ms[variant].append((time.perf_counter() - t0) / steps * 1e3)
            counts = read_counts()
            other = "v3" if variant == "auto" else "auto"
            check_counts(counts, f"v3 path, {path}, {variant}", {
                kernels_of[variant][0]: steps, kernels_of[variant][1]: steps,
                kernels_of[other][0]: 0, kernels_of[other][1]: 0, "tile_blend_plain": 0, "gauss_blur_plain": 0,
            })
            if variant == "v3" and path not in out["counts"]:
                out["counts"][path] = counts
            got = torch.stack(got).cpu().numpy()
            if variant in losses:
                np.testing.assert_array_equal(got, losses[variant])  # the same variant twice: deterministic
            losses[variant] = got
        np.testing.assert_array_equal(losses["v3"], losses["auto"])  # K4f equals K1 and K4b K2, bit for bit
        rel = float(np.max(np.abs(losses["v3"] - losses["auto"]) / np.abs(losses["auto"])))
        out[path] = {v: float(np.mean(t)) for v, t in ms.items()}
        for variant in ("auto", "v3"):  # where a variant's step time goes
            device_profile(runs[variant], steps, f"v3 path, {path}, {variant}",
                           ("tile_blend_fwd_kernel", "tile_blend_bwd_kernel", "tile_blend_v3_fwd_kernel",
                            "tile_blend_v3_bwd_kernel", "gauss_blur_kernel"))
        log(
            f"v3 path, {steps} {path} steps: auto (K1/K2) {out[path]['auto']:.3f} ms/step "
            f"({', '.join(f'{t:.3f}' for t in ms['auto'])}), v3 (K4f/K4b, tps {V3_TPS[0]}) {out[path]['v3']:.3f} "
            f"ms/step ({', '.join(f'{t:.3f}' for t in ms['v3'])}); losses {losses['auto'][0]:.6f} -> "
            f"{losses['auto'][-1]:.6f}, v3 against auto max rel diff {rel:.2e} (equal: "
            f"{bool(np.array_equal(losses['v3'], losses['auto']))}); launches of a v3 run {out['counts'][path]}"
        )
    return out


BATCHED_INIT_ITERS = 240  # frame 0 of the batched run: 10 batched steps of 24 views
BATCHED_OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_batched")


def phase_batched(cfg, src, trainer, scene, frames):
    """The batched all-views mode at full width: ``Trainer.run(resume=False)``
    over ``FRAMES`` frames with ``views_per_step`` 0 and the auto
    ``track_rebin_freq`` (25), geometry only (the dense phase is the parity
    run's); K1/K2 24 times and K5 48 times per batched step, no K4, no
    plain version, no eval render; then a profile of three batched steps
    (one segment with frozen binnings) and three batched steps on the card
    against the CPU from the trained state."""
    import copy

    from topo4d_tpu_torch.config import effective_track_rebin_freq
    from topo4d_tpu_torch.parallel.batched import make_batched_geometry_step
    from topo4d_tpu_torch.pipeline.scene import build_constraints
    from topo4d_tpu_torch.pipeline.trainer import Trainer, make_render_fn

    bcfg = copy.deepcopy(cfg)
    bcfg.data.output_dir = BATCHED_OUT_DIR
    bcfg.schedule.views_per_step = 0
    bcfg.schedule.init_opt_num = BATCHED_INIT_ITERS
    bcfg.texture.gen_tex = False
    shutil.rmtree(BATCHED_OUT_DIR, ignore_errors=True)
    _, _, _, params_np = scene
    tr = Trainer(bcfg, src, params_np, trainer.statics, device=DEVICE)
    parts = instrument(tr)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    tr.run(resume=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    views = src.num_views
    total = 0
    for part in parts:
        if part["kind"] != "geometry":
            raise AssertionError(f"the batched run without gen_tex ran a {part['kind']} fit")
        t, rows, m = part["frame"], part["rows"], part["last"]
        nb = tr.batched_schedule(t, views)[0]
        total += nb
        check_rows(rows)
        check_counts(part["counts"], f"batched geometry frame {t}", {
            "tile_blend_fwd": views * nb, "tile_blend_bwd": views * nb, "gauss_blur": 2 * views * nb,
            "tile_blend_v3_fwd": 0, "tile_blend_v3_bwd": 0, "tile_blend_plain": 0, "gauss_blur_plain": 0,
        })
        part["steps"] = nb
        log(
            f"batched geometry frame {t} ({'init' if t == 0 else 'track'}, {nb} batched steps of {views} views): "
            f"{part['wall']:.3f} s, {part['wall'] / nb * 1e3:.3f} ms per batched step; loss "
            f"{rows[0]['loss_total']:.6f} -> {m['loss_total']:.6f}, psnr {rows[0]['psnr']:.3f} -> {m['psnr']:.3f}; "
            f"launches {part['counts']}"
        )
        if t > 0 and not rows[-1]["loss_total"] < rows[0]["loss_total"]:
            raise AssertionError(f"batched tracked frame's loss did not fall: {rows[0]} -> {rows[-1]}")
    check_counts(counts, "batched Trainer.run", {
        "tile_blend_fwd": views * total, "tile_blend_bwd": views * total, "gauss_blur": 2 * views * total,
        "tile_blend_v3_fwd": 0, "tile_blend_v3_bwd": 0, "uv_bake": 0, "tile_blend_plain": 0,
        "gauss_blur_plain": 0, "uv_bake_plain": 0,
    })
    segments = len(tr.geo_segments)
    frozen = segments * views if tr._binnings_fn is not None else 0
    geo = parts[-1]
    log(
        f"batched Trainer.run, {FRAMES} frames: {wall:.3f} s; {total} batched steps; {segments} segments (steps "
        f"{[s[2] - s[1] for s in tr.geo_segments]}), {frozen} frozen per-view binnings (track_rebin_freq "
        f"{effective_track_rebin_freq(bcfg)}); eval renders 0; launches {counts}"
    )
    out = {
        "counts": counts, "wall": wall, "parts": parts, "tracked_frame_s": geo["wall"],
        "ms_per_step": geo["wall"] / geo["steps"] * 1e3, "psnr": geo["last"]["psnr"], "segments": segments,
        "frozen_binnings": frozen, "trainer": tr,
    }

    # a profile of one segment of three batched steps with frozen binnings
    last_geo = frames[FRAMES][0]
    images = torch.as_tensor(last_geo.images, device=DEVICE)
    args = (tr._constraints("track"), tr.lrs_for("track"), tr.weights_for("track"), "track")

    def segment():
        tr.batched_multi_step(tr.state, images, src.cameras, tr.priors, *args, 3)

    segment()  # warm
    out["profile"] = device_profile(segment, 3, "batched (one 3-step segment, frozen binnings)",
                                    ("tile_blend_fwd_kernel", "tile_blend_bwd_kernel", "gauss_blur_kernel"))

    # card against CPU: three batched steps from the trained state
    st = tr.statics
    n = tr.state.params["means3D"].shape[0]
    cpu_step = make_batched_geometry_step(
        st.quadruples, st.umbrellas, make_render_fn(bcfg, "cpu"), n, ring_indices=st.ring.indices, device="cpu"
    )
    steps = 3
    res = {}
    t0 = time.perf_counter()
    for dev, step, cm, con in (
        (DEVICE, tr.batched_step, src.cameras, tr._constraints("track")),
        ("cpu", cpu_step, camera_to(src.cameras, "cpu"),
         build_constraints("track", tr.params0, st.regions, tr.first_frame_attrs, "cpu")),
    ):
        state, priors = batched_state(tr, dev)
        imgs = images.to(dev)
        losses = []
        for _ in range(steps):
            state, priors, m = step(state, imgs, cm, priors, con, args[1], args[2], "track")
            losses.append(float(m["loss_total"]))
        res[dev] = (losses, {k: v.cpu() for k, v in state.params.items()})
    lc, lg = np.array(res["cpu"][0]), np.array(res[DEVICE][0])
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    lr = args[1]
    worst = [assert_leaf_close(k, res[DEVICE][1][k], pc, 2 * lr[k] * steps) for k, pc in res["cpu"][1].items()]
    out["cpu_check_s"] = time.perf_counter() - t0
    log(
        f"card vs CPU, {steps} batched track steps of {views} views ({out['cpu_check_s']:.1f} s): loss rel err "
        f"{float(np.max(np.abs(lg - lc) / np.abs(lc))):.2e}; " + "; ".join(worst)
    )
    shutil.rmtree(BATCHED_OUT_DIR, ignore_errors=True)
    return out


FUSED_OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_fused")
FUSED_CHECK_STEPS = 3  # fused batched steps held against sequential ones, and timed in turns with them


def batched_state(tr, dev):
    """A copy of ``tr``'s train state and priors on ``dev``."""
    from topo4d_tpu_torch.opt.adam import AdamState
    from topo4d_tpu_torch.opt.step import TrainState

    state = TrainState(
        params=to_device(tr.state.params, dev),
        opt=AdamState(dict(tr.state.opt.step), to_device(tr.state.opt.mu, dev), to_device(tr.state.opt.nu, dev)),
        max_2d_radius=to_device(tr.state.max_2d_radius, dev),
    )
    return state, to_device(tr.priors, dev)


def phase_fused(cfg, src, trainer, scene, frames, batched):
    """The fused batched mode (``schedule.fuse_views``) at full width: a
    third ``Trainer.run(resume=False)`` over ``FRAMES`` frames, as phase
    8's batched run (geometry only, frame 0 cut to ``BATCHED_INIT_ITERS``),
    with every view of a step in one K1 and one K2 launch: K1 and K2 once
    per batched step, K5 48 times, no K4, no plain version, no segments.
    Then, from the trained state, ``FUSED_CHECK_STEPS`` fused steps against
    as many sequential batched steps on the card (loss rtol 1e-4, leaves as
    phase 8's), both timed in turns (fused, sequential, sequential, fused),
    and a profile of the fused steps."""
    import copy

    from topo4d_tpu_torch.parallel.batched import make_batched_geometry_step
    from topo4d_tpu_torch.pipeline.trainer import Trainer

    fcfg = copy.deepcopy(cfg)
    fcfg.data.output_dir = FUSED_OUT_DIR
    fcfg.schedule.views_per_step = 0
    fcfg.schedule.fuse_views = True
    fcfg.schedule.init_opt_num = BATCHED_INIT_ITERS
    fcfg.texture.gen_tex = False
    shutil.rmtree(FUSED_OUT_DIR, ignore_errors=True)
    _, _, _, params_np = scene
    tr = Trainer(fcfg, src, params_np, trainer.statics, device=DEVICE)
    if tr.batched_multi_step is not None:
        raise AssertionError("the fused trainer built a batched multi-step")
    parts = instrument(tr)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    tr.run(resume=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    views = src.num_views
    total = 0
    for part in parts:
        t, rows, m = part["frame"], part["rows"], part["last"]
        nb = tr.batched_schedule(t, views)[0]
        total += nb
        check_rows(rows)
        check_counts(part["counts"], f"fused geometry frame {t}", {
            "tile_blend_fwd": nb, "tile_blend_bwd": nb, "gauss_blur": 2 * views * nb,
            "tile_blend_v3_fwd": 0, "tile_blend_v3_bwd": 0, "tile_blend_plain": 0, "gauss_blur_plain": 0,
        })
        part["steps"] = nb
        log(
            f"fused geometry frame {t} ({'init' if t == 0 else 'track'}, {nb} batched steps of {views} views in one "
            f"K1 and one K2 launch each): {part['wall']:.3f} s, {part['wall'] / nb * 1e3:.3f} ms per batched step "
            f"(phase 8's sequential, frozen binnings: {batched['parts'][t]['wall'] / nb * 1e3:.3f}); loss "
            f"{rows[0]['loss_total']:.6f} -> {m['loss_total']:.6f}, psnr {rows[0]['psnr']:.3f} -> {m['psnr']:.3f}; "
            f"launches {part['counts']}"
        )
        if t > 0 and not rows[-1]["loss_total"] < rows[0]["loss_total"]:
            raise AssertionError(f"fused tracked frame's loss did not fall: {rows[0]} -> {rows[-1]}")
    check_counts(counts, "fused Trainer.run", {
        "tile_blend_fwd": total, "tile_blend_bwd": total, "gauss_blur": 2 * views * total,
        "tile_blend_v3_fwd": 0, "tile_blend_v3_bwd": 0, "uv_bake": 0, "tile_blend_plain": 0,
        "gauss_blur_plain": 0, "uv_bake_plain": 0,
    })
    if tr.geo_segments:
        raise AssertionError(f"the fused run ran segments: {tr.geo_segments}")
    geo = parts[-1]
    out = {"counts": counts, "wall": wall, "parts": parts, "tracked_frame_s": geo["wall"],
           "ms_per_step": geo["wall"] / geo["steps"] * 1e3, "psnr": geo["last"]["psnr"]}

    # fused against sequential steps on the card, from the trained state, timed in turns
    images = torch.as_tensor(frames[FRAMES][0].images, device=DEVICE)
    st = tr.statics
    seq_step = make_batched_geometry_step(
        st.quadruples, st.umbrellas, tr.render_fn, st.ring.indices.shape[0], ring_indices=st.ring.indices,
        device=DEVICE,
    )
    args = (tr._constraints("track"), tr.lrs_for("track"), tr.weights_for("track"), "track")
    res, times = {}, {"fused": [], "sequential": []}
    for name in ("fused", "sequential", "sequential", "fused"):
        step = tr.batched_step if name == "fused" else seq_step
        state, priors = batched_state(tr, DEVICE)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        losses = []
        for _ in range(FUSED_CHECK_STEPS):
            state, priors, m = step(state, images, src.cameras, priors, *args)
            losses.append(m["loss_total"])
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) / FUSED_CHECK_STEPS * 1e3)
        c = read_counts()
        launches = 1 if name == "fused" else views
        check_counts(c, f"{name} steps", {"tile_blend_fwd": launches * FUSED_CHECK_STEPS,
                                          "tile_blend_bwd": launches * FUSED_CHECK_STEPS, "tile_blend_plain": 0})
        res[name] = ([float(x) for x in losses], {k: v.detach().clone() for k, v in state.params.items()})
    lf, ls = np.array(res["fused"][0]), np.array(res["sequential"][0])
    np.testing.assert_allclose(lf, ls, rtol=1e-4)
    lr = args[1]
    worst = [assert_leaf_close(k, res["fused"][1][k], ps, 2 * lr[k] * FUSED_CHECK_STEPS)
             for k, ps in res["sequential"][1].items()]
    out["turns_ms"] = {k: float(np.mean(v)) for k, v in times.items()}
    log(
        f"fused against sequential, {FUSED_CHECK_STEPS} batched track steps of {views} views on the card (fresh "
        f"binnings both): loss rel err {float(np.max(np.abs(lf - ls) / np.abs(ls))):.2e}; " + "; ".join(worst)
        + "; ms per batched step in turns: fused " + ", ".join(f"{x:.3f}" for x in times["fused"])
        + ", sequential " + ", ".join(f"{x:.3f}" for x in times["sequential"])
    )

    def fused_steps():
        state, priors = batched_state(tr, DEVICE)
        for _ in range(FUSED_CHECK_STEPS):
            state, priors, _ = tr.batched_step(state, images, src.cameras, priors, *args)

    out["profile"] = device_profile(fused_steps, FUSED_CHECK_STEPS, "fused batched",
                                    ("tile_blend_fwd_kernel", "tile_blend_bwd_kernel", "gauss_blur_kernel"))
    shutil.rmtree(FUSED_OUT_DIR, ignore_errors=True)
    return out


CLI_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_cli")
# the CLI's schedule, cut for time: frame 0 from 7,000 to 100 init steps, frame 1 from 1,100 to 200 track
# steps, each dense phase from 301 to 51 steps; log rows every 100 geometry and 50 dense steps
CLI_SCHEDULE = ["-ion", "100", "-on", "200", "-don", "51", "-lf", "100", "-dlf", "50"]
CLI_GRID = (92, 90)  # the head grid: 8,280 vertices
CLI_SIZE = (375, 512)  # the working views (portrait; the sensors are landscape)
CLI_RATIO = 8  # working views at down_ratio 8, the dense tree at dense_down_ratio 1
CLI_COMPONENT = np.array([[0.0, -1.0, 0.0, 0.05], [1.0, 0.0, 0.0, -0.02], [0.0, 0.0, 1.0, 0.1], [0.0, 0.0, 0.0, 1.0]])


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def hold_loader(tree):
    """``DiskSequence`` on the written tree: views, cameras (1e-5 relative),
    ``trans_g`` (exact), and every frame's images and parsing images, working
    and dense, on the card (``frame_tensor``) equal to the written targets
    quantised (``round(x * 255) / 255`` in float32 on the host) bit for bit;
    the loader's seconds per frame, frame 1's PNG decode on one thread, and
    ``frame_tensor``'s transfer, turn and conversion on the card ->
    {(t, full_res): timings}."""
    from topo4d_tpu_torch.config import Config
    from topo4d_tpu_torch.pipeline.data import LOAD_THREADS, DiskSequence, frame_tensor, read_image

    cfg = Config()
    cfg.data.input_dir, cfg.data.dense_input_dir, cfg.data.seq = tree.input_dir, tree.dense_input_dir, tree.seq
    cfg.data.down_ratio = CLI_RATIO
    cfg.data.use_mask_dense = True
    src = DiskSequence(cfg, device=DEVICE)
    if src.view_names != tree.view_names:
        raise AssertionError(f"the loader's views {src.view_names} against {tree.view_names}")
    errs = {}
    for name, got, want in (("cameras", src.cameras, tree.cameras), ("cameras_full", src.cameras_full, tree.cameras_full)):
        if (got.width, got.height) != (want.width, want.height):
            raise AssertionError(f"{name}: {got.width}x{got.height} against {want.width}x{want.height}")
        for f in ("w2c", "fx", "fy", "cx", "cy"):
            errs[f"{name}.{f}"] = rel_err(getattr(got, f), getattr(want, f))
    if max(errs.values()) > 1e-5:
        raise AssertionError(f"loaded cameras against the rig they were written from: {errs}")
    if not np.array_equal(src.trans_g, CLI_COMPONENT):
        raise AssertionError(f"trans_g {src.trans_g} against {CLI_COMPONENT}")
    times = {}
    for t in range(1, FRAMES + 1):
        for full in (False, True):
            t0 = time.perf_counter()
            fd = src.frame(t, full_res=full)
            frame_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            on_card = (frame_tensor(fd.images, DEVICE), frame_tensor(fd.masks, DEVICE))
            torch.cuda.synchronize()
            h2d_s = time.perf_counter() - t0
            for what, got, want in (("images", on_card[0], tree.images[(t, full)]),
                                    ("masks", on_card[1], tree.masks[(t, full)])):
                for v in range(want.shape[0]):
                    if not torch.equal(got[v], torch.from_numpy(want[v].astype(np.float32) / 255.0).to(DEVICE)):
                        raise AssertionError(f"frame {t} {'dense' if full else 'working'} {what} of view {v} differ")
            # frame 1's decodes again on one thread
            base = tree.dense_input_dir if full else tree.input_dir
            t0 = time.perf_counter()
            for name in src.view_names if t == 1 else ():
                read_image(os.path.join(base, tree.seq, "%06d" % t, name + ".png"))
                read_image(os.path.join(base, tree.seq, "mask", "%06d" % t, name + ".png"))
            times[(t, full)] = {"frame_s": frame_s, "decode_s": time.perf_counter() - t0, "h2d_s": h2d_s,
                                "bytes": fd.images.nbytes + fd.masks.nbytes}
            del fd, on_card
    log(
        f"loader: {src.num_views} views, cameras within {max(errs.values()):.2e} relative of the rig written, trans_g "
        "exact; every frame's images and parsing images equal the written targets quantised, bit for bit; "
        + "; ".join(
            f"frame {t} {'dense ' + str(src.cameras_full.width) + 'x' + str(src.cameras_full.height) if full else 'working'}:"
            f" {v['frame_s']:.3f} s per frame on {LOAD_THREADS} threads"
            + (f" (PNG decode on one {v['decode_s']:.3f} s)" if t == 1 else "")
            + f", transfer, turn and conversion on the card {v['h2d_s']:.3f} s ({v['bytes']} B of uint8)"
            for (t, full), v in times.items()
        )
    )
    return times


def filtered_png(img, kind):
    """PNG bytes of (H, W, 3) uint8 ``img`` with filter type ``kind`` (0-4)
    on every row (PNG spec, section 9.2)."""
    from topo4d_tpu_torch.utils.png import SIGNATURE, _chunk

    h, w, _ = img.shape
    x = img.reshape(h, 3 * w).astype(np.int32)
    up = np.concatenate([np.zeros((1, 3 * w), np.int32), x[:-1]])
    left = np.concatenate([np.zeros((h, 3), np.int32), x[:, :-3]], axis=1)
    upleft = np.concatenate([np.zeros((h, 3), np.int32), up[:, :-3]], axis=1)
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    pred = [np.zeros_like(x), left, up, (left + up) // 2,
            np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))][kind]
    raw = np.concatenate([np.full((h, 1), kind, np.uint8), ((x - pred) % 256).astype(np.uint8)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)) + _chunk(b"IEND", b"")


def decode_cost(img):
    """``utils/png.py``'s decode of ``img`` with each filter type on every
    row, on this host: the whole decode (its rows through the C unfilter)
    and the unfilter alone, C and its NumPy mirror (``unfilter_plain``) on
    the same rows -> {kind: (decode s, C unfilter s, NumPy mirror s)}; each
    decode equal to ``img``, the C unfilter equal to the mirror."""
    from topo4d_tpu_torch.utils.png import decode_png, unfilter, unfilter_plain

    h, w, _ = img.shape
    out = {}
    for kind in range(5):
        data = filtered_png(img, kind)
        t0 = time.perf_counter()
        got = decode_png(data)
        decode_s = time.perf_counter() - t0
        if not np.array_equal(got, img):
            raise AssertionError(f"filter {kind}: the decode differs from the image")
        raw = np.frombuffer(zlib.decompress(data[8 + 25 + 8 : -12 - 4]), np.uint8).reshape(h, 1 + 3 * w)
        t0 = time.perf_counter()
        c_rows = unfilter(raw, 3)
        t1 = time.perf_counter()
        plain_rows = unfilter_plain(raw, 3)
        t2 = time.perf_counter()
        if not np.array_equal(c_rows, plain_rows):
            raise AssertionError(f"filter {kind}: the C unfilter differs from its NumPy mirror")
        out[kind] = (decode_s, t1 - t0, t2 - t1)
    return out


def hold_fixtures(names, label="JPEG fixtures"):
    """The loader's decoders on this host (the C library) against the
    committed fixtures ``names``: each decode's shape and SHA-256 as PIL's
    decode of the file (the manifest) -> {name: (s, Mpx)}."""
    from topo4d_tpu_torch import fixtures
    from topo4d_tpu_torch.pipeline.data import read_image

    out = {}
    manifest = fixtures.manifest()
    for name in names:
        entry = manifest[name]
        t0 = time.perf_counter()
        px = read_image(fixtures.path(name))
        secs = time.perf_counter() - t0
        if list(px.shape) != entry["shape"] or fixtures.sha256(px) != entry["sha256"]:
            raise AssertionError(f"{name}: the C decode {px.shape} is not PIL's (manifest {entry['shape']})")
        out[name] = (secs, px.shape[0] * px.shape[1] / 1e6)
    log(f"{label} decoded by the C library, each equal to PIL's decode (SHA-256): "
        + "; ".join(f"{n} {s:.4f} s ({s / mpx:.4f} s per Mpx)" for n, (s, mpx) in out.items()))
    return out


def jpeg_tree(root, calib, fixture=None):
    """A dense tree of JPEG views under ``root``: ``calib`` = (sequence,
    view names, the bytes of its ``cameras.xml``) and, for each view, a copy
    of ``fixture`` (the dense fixture by default: 4096x3000, each view's
    landscape sensor), one frame -> a ``DiskSequence`` on it (no masks), and
    the fixture's pixels."""
    from topo4d_tpu_torch import fixtures
    from topo4d_tpu_torch.config import Config
    from topo4d_tpu_torch.pipeline.data import DiskSequence
    from topo4d_tpu_torch.utils.jpeg import read_jpeg

    seq, view_names, xml = calib
    fixture = fixture or fixtures.DENSE
    fdir = os.path.join(root, seq, "000001")
    os.makedirs(fdir, exist_ok=True)
    with open(os.path.join(root, seq, "cameras.xml"), "wb") as fh:
        fh.write(xml)
    for name in view_names:
        shutil.copyfile(fixtures.path(fixture), os.path.join(fdir, name + ".jpg"))
    cfg = Config()
    cfg.data.input_dir = cfg.data.dense_input_dir = root
    cfg.data.seq = seq
    cfg.data.down_ratio = CLI_RATIO
    cfg.data.use_mask_dense = False
    return DiskSequence(cfg, device=DEVICE), read_jpeg(fixtures.path(fixture))


def hold_jpeg_read(src, pixels, label="JPEG tree"):
    """A dense read of the JPEG tree: every view on the card after
    ``frame_tensor`` equal to the fixture's decode turned by its view's
    quarter turns on the host, bit for bit -> (s per frame on
    ``LOAD_THREADS`` threads, s of transfer, turn and conversion)."""
    from topo4d_tpu_torch.pipeline.data import LOAD_THREADS, frame_tensor

    t0 = time.perf_counter()
    fd = src.frame(1, full_res=True)
    frame_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = frame_tensor(fd.images, DEVICE)
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    turned = {}
    for v, name in enumerate(src.view_names):
        rt = src.cfg.data.rotate_mask.get(name, 0)
        if rt not in turned:
            want = np.ascontiguousarray(np.rot90(pixels, rt, axes=(0, 1)).transpose(2, 0, 1))
            turned[rt] = torch.from_numpy(want).to(DEVICE).to(torch.float32) / torch.tensor(255.0, device=DEVICE)
        if not torch.equal(on_card[v], turned[rt]):
            raise AssertionError(f"{label}: view {name} on the card differs from the fixture's decode turned by {rt}")
    log(f"{label}: a dense frame of {len(src.view_names)} views at {src.cameras_full.width}x"
        f"{src.cameras_full.height} read in {frame_s:.3f} s on {LOAD_THREADS} threads ({fd.images.nbytes} B of "
        f"uint8), transfer, turn and conversion on the card {h2d_s:.3f} s; every view equal on the card to the "
        "fixture's decode after its turn, bit for bit")
    return frame_s, h2d_s


def instrument_cli():
    """Class-level wraps for the CLI's own ``Trainer`` and ``DiskSequence``:
    each fit part (as ``instrument``), ``run``'s wall, each progress render,
    the inner-mouth dimming (the pixels it changed) and each frame read (its
    interval on the read-ahead thread) -> (record, restore)."""
    from topo4d_tpu_torch.pipeline import trainer as trainer_mod
    from topo4d_tpu_torch.pipeline.data import DiskSequence

    rec = {"parts": [], "progress": [], "dimmed": [], "reads": [], "run": []}
    saved = [(trainer_mod.Trainer, "fit_frame_geometry"), (trainer_mod.Trainer, "fit_frame_texture"),
             (trainer_mod.Trainer, "run"), (trainer_mod, "report_progress"), (trainer_mod, "dim_inner_mouth"),
             (DiskSequence, "frame")]
    saved = [(obj, name, getattr(obj, name)) for obj, name in saved]
    originals = {name: fn for _, name, fn in saved}

    def part(kind):
        fit = originals[f"fit_frame_{kind}"]

        def wrapped(self, t, frame):
            torch.cuda.synchronize()
            before, n_rows, n_prog = read_counts(), len(self.metrics_log), len(rec["progress"])
            t0 = time.perf_counter()
            m = fit(self, t, frame)
            torch.cuda.synchronize()
            wall, after = time.perf_counter() - t0, read_counts()
            p = {"kind": kind, "frame": t, "wall": wall, "start": t0, "counts": {k: after[k] - before[k] for k in after},
                 "rows": self.metrics_log[n_rows:], "last": m,
                 "progress_s": sum(x[1] for x in rec["progress"][n_prog:])}
            if kind == "texture":
                p["colors"] = self.texture_state.params["dense_rgb_colors"].clone()
                p["masked"] = self._texture_masked
            rec["parts"].append(p)
            return m

        return wrapped

    def run(self, resume=True):
        t0 = time.perf_counter()
        originals["run"](self, resume)
        torch.cuda.synchronize()
        rec["run"].append(time.perf_counter() - t0)

    def progress(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        psnr = originals["report_progress"](*args, **kwargs)
        torch.cuda.synchronize()
        rec["progress"].append((args[8], time.perf_counter() - t0, psnr))
        return psnr

    def dim(gt, mask_rgb, cmap_index):
        out = originals["dim_inner_mouth"](gt, mask_rgb, cmap_index)
        rec["dimmed"].append(int((out != gt).any(0).sum()))
        return out

    def frame(self, t, full_res=False):
        t0 = time.perf_counter()
        fd = originals["frame"](self, t, full_res)
        rec["reads"].append((t, full_res, t0, time.perf_counter()))
        return fd

    trainer_mod.Trainer.fit_frame_geometry = part("geometry")
    trainer_mod.Trainer.fit_frame_texture = part("texture")
    trainer_mod.Trainer.run = run
    trainer_mod.report_progress = progress
    trainer_mod.dim_inner_mouth = dim
    DiskSequence.frame = frame

    def restore():
        for obj, name, fn in saved:
            setattr(obj, name, fn)

    return rec, restore


def cli_expected(sched):
    """Each part's launches from the schedule: K1/K2 once per geometry and
    dense step, K1 once more per progress render (one log view, every
    logged geometry step) and per dense eval render (every logged dense step
    and one after the last), K5 twice per geometry step and never in a
    masked dense step -> ([(kind, frame, counts)], progress renders)."""
    parts, renders = [], 0
    for t, n in enumerate((sched.init_opt_num, sched.opt_num)):
        logged = len({i for i in range(n) if i % sched.log_freq == 0 or i == n - 1})
        renders += logged
        parts.append(("geometry", t, {"tile_blend_fwd": n + logged, "tile_blend_bwd": n, "gauss_blur": 2 * n}))
        d = sched.dense_opt_num
        evals = len(range(0, d, sched.dense_log_freq)) + 1
        parts.append(("texture", t, {"tile_blend_fwd": d + evals, "tile_blend_bwd": d, "gauss_blur": 0}))
    return parts, renders


def backends_check(trainer, frame):
    """At geometry view 0 of the disk sequence, with the fitted parameters:
    the tiled and oracle renderers on the card against K1 (the tolerances of
    ``tests/test_rasterizer_tiled.py``: image and alpha rtol 1e-4 / atol
    1e-5, depth atol 1e-4, at every pixel), and the gradients of a track
    step's photometric loss through each against K2's (max-scaled rtol 2e-3
    / atol 2e-5)."""
    from topo4d_tpu_torch.core.gaussian import activate_params
    from topo4d_tpu_torch.losses.image import photometric_loss
    from topo4d_tpu_torch.pipeline.data import frame_tensor
    from topo4d_tpu_torch.rasterizer.reference import render_gaussians as oracle
    from topo4d_tpu_torch.rasterizer.render import render_gaussians
    from topo4d_tpu_torch.rasterizer.tiled import render_gaussians_tiled

    cam = trainer.source.cameras[0]
    gt = frame_tensor(frame.images, DEVICE)[0]
    renders = {
        "K1/K2": lambda rv: render_gaussians(rv, cam, max_span=8),
        "tiled": lambda rv: render_gaussians_tiled(rv, cam, max_span=8, capacity=1024),
        "oracle": lambda rv: oracle(rv, cam, remat=True),
    }
    res = {}
    for name, render in renders.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = {k: v.detach().clone().requires_grad_(True) for k, v in trainer.state.params.items()}
        out = render(activate_params(p))
        im = torch.exp(p["cam_m"][0])[:, None, None] * out.image + p["cam_c"][0][:, None, None]
        loss = photometric_loss(im, gt)
        grads = torch.autograd.grad(loss, list(p.values()))
        torch.cuda.synchronize()
        out = type(out)(*(x.detach() if torch.is_tensor(x) else x for x in out))
        res[name] = (out, dict(zip(p, grads)), float(loss.detach()), time.perf_counter() - t0)
    ref, ref_g = res["K1/K2"][0], res["K1/K2"][1]
    if int(ref.num_cropped) != 0:
        raise AssertionError(f"K1 cropped {int(ref.num_cropped)} Gaussians at max_span 8")
    msgs = []
    for name in ("tiled", "oracle"):
        out, g, loss, secs = res[name]
        if name == "tiled" and (int(out.num_overflow) or int(out.num_cropped)):
            raise AssertionError(f"tiled dropped {int(out.num_overflow)} entries, cropped {int(out.num_cropped)}")
        outside = 0
        for field, rtol, atol in (("image", 1e-4, 1e-5), ("depth", 1e-4, 1e-4), ("alpha", 1e-4, 1e-5)):
            a, b = getattr(out, field), getattr(ref, field)
            bad = ((a - b).abs() > atol + rtol * b.abs()).any(0)
            outside = max(outside, int(bad.sum()))
        if outside:
            raise AssertionError(f"{name}: {outside} pixels outside the tolerance against K1")
        worst = {}
        for k, gk in g.items():
            d, scale = float((gk - ref_g[k]).abs().max()), float(ref_g[k].abs().max())
            if d > 2e-3 * scale + 2e-5:
                raise AssertionError(f"{name}: d loss / d {k} differs from K2's by {d:.3e} (max |g| {scale:.3e})")
            worst[k] = d / max(scale, 1e-30)
        msgs.append(
            f"{name}: image max|d| {float((out.image - ref.image).abs().max()):.2e}, loss rel err {abs(loss - res['K1/K2'][2]) / res['K1/K2'][2]:.2e}, gradients max rel err "
            f"{max(worst.values()):.2e} ({max(worst, key=worst.get)}), forward + backward {secs:.3f} s"
        )
    log(f"backends at geometry view 0 ({cam.width}x{cam.height}), against K1/K2 "
        f"({res['K1/K2'][3]:.3f} s): " + "; ".join(msgs))


SWEEP_THREADS = (1, 2, 4)  # loader threads at which the geometry loop is timed beside a frame read
SWEEP_STEPS = 100  # track steps of each timed fit (the CLI run's frames take 200)


def loader_sweep(trainer, read_frame, label):
    """Does a frame read on the host slow the host-bound geometry loop? The
    ms per step of ``trainer.fit_frame_geometry`` on the tracked frame 2
    (``SWEEP_STEPS`` steps) alone, then while another thread runs
    ``read_frame()`` (a dense read) over and over with ``LOAD_THREADS`` at
    each of ``SWEEP_THREADS`` (the fit lies wholly inside the reads), then
    alone again; the seconds per read at each -> [(threads, 0 for none; ms
    per step; s per read or None)]."""
    from concurrent.futures import ThreadPoolExecutor

    from topo4d_tpu_torch.pipeline import data

    src, saved, sched, n = trainer.source, data.LOAD_THREADS, trainer.cfg.schedule, SWEEP_STEPS
    frame = src.frame(2)
    rows = []
    saved_steps, sched.opt_num = sched.opt_num, n
    with ThreadPoolExecutor(max_workers=1) as pool:
        for k in (0, *SWEEP_THREADS, 0):
            data.LOAD_THREADS = k or saved
            stop, reads = [], []

            def read():
                while not stop:
                    t0 = time.perf_counter()
                    read_frame()
                    reads.append(time.perf_counter() - t0)

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reader = pool.submit(read) if k else None
            try:
                trainer.fit_frame_geometry(1, frame)
                torch.cuda.synchronize()
            finally:  # the reader stops whether or not the fit raised
                stop.append(True)
            wall = time.perf_counter() - t0
            if reader is not None:
                reader.result()
            rows.append((k, wall / n * 1e3, sum(reads) / len(reads) if reads else None))
    data.LOAD_THREADS, sched.opt_num = saved, saved_steps
    alone = (rows[0][1] + rows[-1][1]) / 2
    log(f"the geometry loop beside {label} ({n} track steps, progress renders included): "
        f"{rows[0][1]:.3f} and {rows[-1][1]:.3f} ms per step alone, before and after; "
        + "; ".join(f"{ms:.3f} ms per step ({ms / alone - 1:+.1%} on the mean alone) while {k} loader threads run, "
                    f"{read_s:.3f} s per read" for k, ms, read_s in rows[1:-1])
        + f"; LOAD_THREADS is {saved}")
    return rows


def memory_load(nbytes: int, count: int):
    """A stand-in for a dense read that opens no file and takes no
    interpreter lock: ``count`` buffers of ``nbytes`` each allocated,
    written by ``memset`` through ctypes and freed, on ``LOAD_THREADS``
    threads: what a read does to the host's memory, without its decode."""
    from concurrent.futures import ThreadPoolExecutor

    from topo4d_tpu_torch.pipeline import data

    libc = ctypes.CDLL(None)
    libc.memset.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t]
    libc.memset.restype = ctypes.c_void_p

    def one(_):
        buf = np.empty(nbytes, np.uint8)
        libc.memset(buf.ctypes.data, 1, nbytes)

    def load():
        with ThreadPoolExecutor(max_workers=data.LOAD_THREADS) as pool:
            list(pool.map(one, range(count)))

    return load


def phase_cli(run4):
    """Phase 9: the CLI on a disk tree. Writes the reference layout with
    ``write_disk_sequence`` (24 views named after ``DEFAULT_ROTATE_MASK``'s
    labels on landscape 4096x3000 sensors, the 8,280-vertex head, a
    component transform, parsing masks, the 3000x4096 dense tree, 2 frames),
    holds the loader, runs ``cli.main`` in process with the launch counters
    set to 0 just before it and read just after (and per part), checks the
    outputs, runs ``python -m topo4d_tpu_torch`` again as a subprocess (it
    resumes and writes nothing) and ``cli.main`` once more in process (it
    launches nothing), holds the tiled and oracle renderers to K1/K2, holds
    the C unfilter and JPEG decoder (``decode_cost``, ``hold_fixtures``),
    reads a JPEG tree (``jpeg_tree``, ``hold_jpeg_read``), and times the
    geometry loop beside a dense PNG and a dense JPEG read at 1, 2 and 4
    loader threads."""
    from topo4d_tpu_torch import cli
    from topo4d_tpu_torch.config import DEFAULT_ROTATE_MASK, Config
    from topo4d_tpu_torch.texture.bake_tiled import bake_canvas_cuda
    from topo4d_tpu_torch.testing import write_disk_sequence
    from topo4d_tpu_torch.utils.png import read_png

    t_phase = time.perf_counter()
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    tree = write_disk_sequence(
        os.path.join(CLI_DIR, "tree"), num_views=len(DEFAULT_ROTATE_MASK), num_frames=FRAMES, rows=CLI_GRID[0],
        cols=CLI_GRID[1], width=CLI_SIZE[0], height=CLI_SIZE[1], ratio=CLI_RATIO, view_names=sorted(DEFAULT_ROTATE_MASK),
        component=CLI_COMPONENT, level=1, device=DEVICE,
    )
    log(f"disk tree: {len(tree.view_names)} views x {FRAMES} frames at {tree.cameras.width}x{tree.cameras.height} and "
        f"{tree.cameras_full.width}x{tree.cameras_full.height} with parsing masks, written in "
        f"{time.perf_counter() - t0:.3f} s")
    loader = hold_loader(tree)
    img = tree.images[(1, False)][0].transpose(1, 2, 0)
    cost = decode_cost(np.ascontiguousarray(img))
    mpx = img.shape[0] * img.shape[1] / 1e6
    log(f"PNG decode of a {img.shape[1]}x{img.shape[0]} RGB view (utils/png.py) with every row of filter type "
        + ", ".join(f"{k}: {d:.4f} s" for k, (d, _, _) in cost.items())
        + "; the unfilter alone, C against its NumPy mirror (equal), s per Mpx: "
        + ", ".join(f"{k}: {c / mpx:.5f} against {p / mpx:.3f}" for k, (_, c, p) in cost.items()))
    from topo4d_tpu_torch import fixtures

    with open(os.path.join(tree.input_dir, tree.seq, "cameras.xml"), "rb") as fh:
        calib = (tree.seq, list(tree.view_names), fh.read())
    jpeg = {"fixtures": hold_fixtures(fixtures.BASELINE), "calib": calib}
    jsrc, jpixels = jpeg_tree(os.path.join(CLI_DIR, "jpeg"), calib)
    jpeg["frame_s"], jpeg["h2d_s"] = hold_jpeg_read(jsrc, jpixels)
    del jpixels
    tree.images.clear()  # host memory: the CLI run holds two frames of its own
    tree.masks.clear()

    config_path = os.path.join(CLI_DIR, "config.json")
    with open(config_path, "w") as fh:
        json.dump({"data": {"use_mask_dense": True}}, fh)
    argv = ["-id", tree.input_dir, "-did", tree.dense_input_dir, "-s", tree.seq, "-od", os.path.join(CLI_DIR, "out"),
            "-e", "cli", "--config", config_path, "-fn", str(FRAMES), "-t", "-tr", str(TEX_RES), "-dn", str(DENSITY),
            "-cf", "1", "-dr", str(CLI_RATIO), "-ddr", "1", "-lv", "K98707293", "--device", DEVICE] + CLI_SCHEDULE
    rec, restore = instrument_cli()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    trainer = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    restore()
    cfg = trainer.cfg
    out = os.path.join(cfg.data.output_dir, cfg.data.exp, cfg.data.seq)

    expected, renders = cli_expected(cfg.schedule)
    got_parts = [(p["kind"], p["frame"]) for p in rec["parts"]]
    if got_parts != [(k, t) for k, t, _ in expected]:
        raise AssertionError(f"the CLI run's parts: {got_parts}")
    plain = {"tile_blend_plain": 0, "gauss_blur_plain": 0, "tile_blend_v3_fwd": 0, "tile_blend_v3_bwd": 0}
    for p, (kind, t, want) in zip(rec["parts"], expected):
        check_rows(p["rows"])
        check_counts(p["counts"], f"CLI {kind} frame {t}", {**want, **plain})
    total = {k: sum(w[k] for _, _, w in expected) for k in ("tile_blend_fwd", "tile_blend_bwd", "gauss_blur")}
    check_counts(counts, "the CLI run", {**total, **plain, "uv_bake": FRAMES, "uv_bake_plain": 0})
    if len(rec["progress"]) != renders:
        raise AssertionError(f"{len(rec['progress'])} progress renders, expected {renders}")

    # the outputs
    def f_lines(t):
        with open(os.path.join(out, "%06d" % (t + 1), "face.obj")) as fh:
            return [line for line in fh if line.startswith("f ")]

    topo = [f_lines(t) for t in range(FRAMES)]
    if not topo[0] or any(x != topo[0] for x in topo):
        raise AssertionError("CLI: face.obj topology differs between frames")
    for p in rec["parts"]:
        if p["kind"] != "texture":
            continue
        t = p["frame"]
        png = read_png(os.path.join(out, "%06d" % (t + 1), "face.png"))
        want = (bake_canvas_cuda(trainer._bake_binning, torch.clamp(p["colors"], 0.0, 1.0), TEX_RES, TEX_RES) * 255)
        if not np.array_equal(png, want.to(torch.uint8).cpu().numpy()):
            raise AssertionError(f"CLI frame {t}: face.png differs from K6's bytes")
        if p["masked"] is not True:
            raise AssertionError(f"CLI frame {t}: the dense phase did not take the masked step")
    for t in range(FRAMES):
        n = cfg.schedule.init_opt_num if t == 0 else cfg.schedule.opt_num
        for i in sorted({i for i in range(n) if i % cfg.schedule.log_freq == 0 or i == n - 1}):
            img = read_png(os.path.join(out, "%06d" % (t + 1), f"visK98707293_{i}.png"))
            if img.shape != (CLI_SIZE[1], CLI_SIZE[0], 3):
                raise AssertionError(f"visK98707293_{i}.png is {img.shape}")
    with open(os.path.join(out, "config.json")) as fh:
        if Config.from_json(fh.read()) != cfg:
            raise AssertionError("config.json does not read back to the effective config")
    with open(os.path.join(out, "timings.json")) as fh:
        timings = json.load(fh)
    if set(timings) != {"geometry", "texture", "checkpoint", "export"}:
        raise AssertionError(f"timings.json phases {sorted(timings)}")
    if not (rec["dimmed"] and sum(rec["dimmed"]) > 0):
        raise AssertionError(f"the tracked frame's inner mouth was not dimmed: {rec['dimmed']}")
    if len(rec["dimmed"]) != len(tree.view_names) * (FRAMES - 1):
        raise AssertionError(f"{len(rec['dimmed'])} views dimmed, expected each view of each tracked frame")

    # the read-ahead: frame 2's reads run while frame 0 fits
    geo = [p for p in rec["parts"] if p["kind"] == "geometry"]
    reads = {(t, f): (a, b) for t, f, a, b in rec["reads"]}
    frame0_end = max(p["start"] + p["wall"] for p in rec["parts"] if p["frame"] == 0)
    ahead_end = max(b for (t, _), (_, b) in reads.items() if t == 2)
    wait = geo[1]["start"] - frame0_end
    geo_ms = [(p["wall"] - p["progress_s"]) / n * 1e3 for p, n in zip(geo, (cfg.schedule.init_opt_num, cfg.schedule.opt_num))]
    p4 = [p for p in run4["parts"] if p["kind"] == "geometry"]
    p4_ms = [p["wall"] / n * 1e3 for p, n in zip(p4, (INIT_ITERS, Config().schedule.opt_num))]
    tex = [p for p in rec["parts"] if p["kind"] == "texture"]
    log(
        f"CLI run: {wall:.3f} s in cli.main ({wall - rec['run'][0]:.3f} s before run: the loader's cameras, the OBJ, "
        f"the scene, the trainer); {rec['run'][0] / FRAMES:.3f} s per frame through run; launches {counts}; geometry "
        f"ms per step {geo_ms[0]:.3f} (frame 0, {cfg.schedule.init_opt_num} init steps, while the read-ahead decodes "
        f"frame 2) and {geo_ms[1]:.3f} (frame 1, {cfg.schedule.opt_num} track steps), phase 4's in this call "
        f"{p4_ms[0]:.3f} (init) and {p4_ms[1]:.3f} (track); the read-ahead of frame 2 (working and dense) ended "
        f"{ahead_end - rec['parts'][0]['start']:.3f} s after frame 0's fit began, which took "
        f"{frame0_end - rec['parts'][0]['start']:.3f} s; the main thread then waited {wait:.3f} s before frame 1 "
        f"({'hidden' if ahead_end <= frame0_end else 'not hidden'}); dense s per frame "
        + ", ".join(f"{p['wall']:.3f}" for p in tex)
        + f" ({cfg.schedule.dense_opt_num} masked steps at {tree.cameras_full.width}x{tree.cameras_full.height}); "
        f"progress renders {len(rec['progress'])}, "
        f"{sum(x[1] for x in rec['progress']) / len(rec['progress']):.4f} s each (psnr "
        + ", ".join(f"{x[2]:.3f}" for x in rec["progress"])
        + f"); inner-mouth pixels dimmed in frame 1: {sum(rec['dimmed'])} over {len(rec['dimmed'])} views; timings "
        + ", ".join(f"{k} {v['seconds']:.3f} s over {v['count']}" for k, v in timings.items())
    )

    # resume through the module entry point, then in process
    stamps = {f: os.path.getmtime(os.path.join(out, "%06d" % (t + 1), f)) for t in range(FRAMES)
              for f in ("face.obj", "face.png")}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "topo4d_tpu_torch", *argv], capture_output=True, text=True,
                          cwd=os.path.dirname(os.path.abspath(__file__)), timeout=600)
    sub_s = time.perf_counter() - t0
    if proc.returncode != 0 or "frame " in proc.stdout:
        raise AssertionError(f"python -m topo4d_tpu_torch (resume): rc {proc.returncode}\n{proc.stdout}\n{proc.stderr}")
    reset_counts()
    again = cli.main(argv)
    torch.cuda.synchronize()
    if any(read_counts().values()):
        raise AssertionError(f"the resumed CLI run launched kernels: {read_counts()}")
    if {f: os.path.getmtime(os.path.join(out, "%06d" % (t + 1), f)) for t in range(FRAMES)
            for f in ("face.obj", "face.png")} != stamps:
        raise AssertionError("a resumed CLI run rewrote a frame's export")
    log(f"resume: python -m topo4d_tpu_torch exited 0 in {sub_s:.3f} s and wrote no frame; cli.main again launched "
        "nothing")

    frame1 = again.source.frame(1)
    backends_check(trainer, frame1)
    del frame1, again
    src = trainer.source
    sweep = loader_sweep(trainer, lambda: src.frame(2, full_res=True), "a dense read of PNG views and masks")
    jpeg["sweep"] = loader_sweep(trainer, lambda: jsrc.frame(1, full_res=True), "a dense read of JPEG views")
    # the PNG read's memory traffic alone: 48 dense-view buffers of 36.9 MB (24 views and 24 masks)
    jpeg["memory_sweep"] = loader_sweep(trainer, memory_load(4096 * 3000 * 3, 48),
                                        "48 buffers of 36.9 MB allocated and written in C (no file, no lock)")
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    log(f"phase 9 (the CLI on a disk tree): {time.perf_counter() - t_phase:.1f} s")
    return {"counts": counts, "parts": rec["parts"], "wall": wall, "loader": loader, "decode": cost, "sweep": sweep,
            "jpeg": jpeg}


MULTI_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_multi")
MULTI_TIMEOUT = 420  # seconds one spawned world may take
MULTI_CHECK_STEPS = 3  # sharded batched steps held against single-rank ones, and timed in turns with them
DENSE_SHARD_STEPS = 3  # tile-sharded dense steps held against single-rank ones
MULTI_BANDS = {2: 8, 3: 6}  # the sharded bake's row bands per world size
MULTI_MAIN_PATH = {}  # build_main_path's arguments in the ranks (its defaults: the head grid at 375x512)
# the settings a rank takes from the parent, so that a smaller run (a rehearsal on the CPU) is smaller there too
MULTI_SETTINGS = ("DEVICE", "FULL_W", "FULL_H", "TEX_RES", "DENSITY", "INIT_ITERS", "FRAMES", "BATCHED_INIT_ITERS",
                  "OUT_DIR", "MULTI_DIR", "MULTI_MAIN_PATH")


def free_port() -> int:
    from topo4d_tpu_torch.parallel.multihost import free_port as port

    return port()


def spawn_world(world: int, task: str, args) -> list:
    """``world`` processes of ``multi_rank`` (spawn start method: this one has
    initialised CUDA), ranks on ``cuda:0`` over gloo; fails if a rank raises
    or the world outlives ``MULTI_TIMEOUT`` -> each rank's report."""
    import torch.multiprocessing as mp

    path = os.path.join(MULTI_DIR, f"{task}_{world}")
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    t0 = time.perf_counter()
    settings = {k: globals()[k] for k in MULTI_SETTINGS}
    ctx = mp.start_processes(multi_rank, args=(world, free_port(), path, task, CARD, settings, args), nprocs=world,
                             join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > MULTI_TIMEOUT:
                raise AssertionError(f"phase 10: the {world}-rank world ({task}) did not end in {MULTI_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(10)
    log(f"phase 10: the {world}-rank world ({task}) ran {time.perf_counter() - t0:.1f} s")
    return [torch.load(os.path.join(path, f"rank{r}.pt"), weights_only=False) for r in range(world)]


def multi_rank(rank: int, world: int, port: int, path: str, task: str, card: str, settings, args) -> None:
    """One rank of a phase-10 world: joins the group through the port's
    ``initialize_multihost`` (the JAX launch arguments; ``cuda:0`` and gloo
    named, since the ranks share one card), runs ``task`` and writes its
    report to ``path/rank<r>.pt``."""
    global CARD
    CARD = card
    globals().update(settings)
    import torch.distributed as dist

    from topo4d_tpu_torch.parallel.multihost import initialize_multihost, rank_device

    if DEVICE == "cpu":  # a rehearsal on the CPU
        torch.cuda.synchronize = lambda *a, **k: None
    dev = "cuda:0" if DEVICE == "cuda" else DEVICE
    if not initialize_multihost(f"localhost:{port}", world, rank, device=dev, backend="gloo"):
        raise AssertionError(f"rank {rank}: initialize_multihost did not join a world of {world}")
    try:
        report = {"device": str(rank_device()), "backend": dist.get_backend()}
        report.update(MULTI_TASKS[task](rank, world, args))
        torch.save(report, os.path.join(path, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def state_digest(state) -> str:
    """SHA-256 of a train or texture state's parameters, Adam moments, step
    counts and (a train state's) radii."""
    import hashlib

    h = hashlib.sha256()
    for tree in (state.params, state.opt.mu, state.opt.nu):
        for k in sorted(tree):
            h.update(tree[k].detach().contiguous().cpu().numpy().tobytes())
    if hasattr(state, "max_2d_radius"):
        h.update(state.max_2d_radius.cpu().numpy().tobytes())
    h.update(json.dumps(state.opt.step, sort_keys=True).encode())
    return h.hexdigest()


def canvas_digest(canvas) -> str:
    import hashlib

    return hashlib.sha256(canvas.contiguous().cpu().numpy().tobytes()).hexdigest()


def timed_steps(step, steps: int, state, priors, images, cams, *args):
    """``steps`` calls of a batched ``step`` -> (losses, final params on the
    host, ms per step, the state's digest after each step)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, states = [], []
    for _ in range(steps):
        state, priors, m = step(state, images, cams, priors, *args)
        losses.append(m["loss_total"])
        states.append(state)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    return ([float(x) for x in losses], {k: v.detach().cpu() for k, v in state.params.items()}, ms,
            [state_digest(s) for s in states])


def time_texture_steps(tr, frame, steps: int) -> float:
    """ms per dense step: ``steps`` more steps of ``tr``'s texture step from
    its state, on the frame's frozen binnings (every rank in step)."""
    from topo4d_tpu_torch.pipeline.data import frame_tensor, view_order

    cfg = tr.cfg
    images = frame_tensor(frame.images, tr.device)
    binnings = tr.dense_binnings(0)
    order = view_order(images.shape[0], steps, seed=10_000)
    state = tr.texture_state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        v = int(order[i])
        state, _ = tr.texture_step(state, tr.dense_means3d, images[v], tr.source.cameras_full, v, tr.dense_anchor,
                                   tr._dense_pre, dict(cfg.lrs.dense), cfg.dense_weights.as_dict(), binnings[v],
                                   with_metrics=False)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def rank_batched(rank, world, args, cfg, src, params_np, statics):
    """Phase 10a and 10e on one rank: the view-sharded batched run (each
    step's state digest), a resume that does nothing, a rank on another
    output directory, the orbax round trip on rank 0; then the sharded
    steps of the check against one rank, in two turns."""
    import copy

    import torch.distributed as dist

    from topo4d_tpu_torch.parallel.mesh import shard_view_batch
    from topo4d_tpu_torch.pipeline import checkpoint as ckpt
    from topo4d_tpu_torch.pipeline.scene import build_constraints
    from topo4d_tpu_torch.pipeline.trainer import Trainer

    out = {}
    bcfg = copy.deepcopy(cfg)
    bcfg.schedule.views_per_step = 0
    bcfg.schedule.init_opt_num = BATCHED_INIT_ITERS
    bcfg.texture.gen_tex = False
    run_dir = os.path.join(MULTI_DIR, "run")
    # rank 1 gets a directory of its own: a file it wrote would show there
    bcfg.data.output_dir = run_dir if rank == 0 else os.path.join(MULTI_DIR, "rank1_run")
    tr = Trainer(bcfg, src, params_np, statics, device=DEVICE)
    if tr.mesh is None or tr.mesh.size != world or tr.batched_multi_step is not None:
        raise AssertionError(f"rank {rank}: view mesh {tr.mesh}, batched multi-step {tr.batched_multi_step}")
    digests = []
    sharded_step = tr.batched_step

    def step(*a, **k):
        r = sharded_step(*a, **k)
        digests.append(state_digest(r[0]))  # a read back: the run's wall includes it
        return r

    tr.batched_step = step
    parts = instrument(tr)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    tr.run(resume=False)
    torch.cuda.synchronize()
    out["run_wall"] = time.perf_counter() - t0
    out["run_counts"] = read_counts()
    out["run_parts"] = [{k: p[k] for k in ("kind", "frame", "wall", "counts", "rows")} for p in parts]
    out["steps"] = [tr.batched_schedule(p["frame"], src.num_views)[0] for p in parts]
    out["digests"] = digests
    out["local_views"] = tr.mesh.block(src.num_views)[1]

    # 10e: a second run resumes and does nothing; a rank on another directory makes every rank raise
    rcfg = copy.deepcopy(bcfg)
    rcfg.data.output_dir = run_dir
    again = Trainer(rcfg, src, params_np, statics, device=DEVICE)
    torch.cuda.synchronize()
    reset_counts()
    again.run(resume=True)
    torch.cuda.synchronize()
    out["resume_counts"] = read_counts()
    out["resume_equal"] = all(torch.equal(again.state.params[k], tr.state.params[k]) for k in tr.state.params)
    mcfg = copy.deepcopy(bcfg)
    mcfg.data.output_dir = run_dir if rank == 0 else os.path.join(MULTI_DIR, "elsewhere")
    try:
        Trainer(mcfg, src, params_np, statics, device=DEVICE).run(resume=True)
        out["mismatch"] = ""
    except RuntimeError as exc:
        out["mismatch"] = str(exc)
    if rank == 0:  # the orbax backend on the card, host 0 alone under an initialised group
        odir = os.path.join(MULTI_DIR, "orbax")
        ckpt.save_resume_orbax(odir, 2, tr.state, tr.priors, tr.first_frame_attrs, tr.output_params, None)
        p = ckpt.load_resume_orbax(odir)
        same = p["frame"] == 2 and len(p["output_params"]) == len(tr.output_params)
        same = same and p["state"].opt.step == tr.state.opt.step and p["texture_state"] is None
        for a, b in ((p["state"].params, tr.state.params), (p["state"].opt.mu, tr.state.opt.mu),
                     (p["state"].opt.nu, tr.state.opt.nu)):
            same = same and all(np.array_equal(a[k], b[k].cpu().numpy()) for k in b)
        same = same and np.array_equal(p["priors"].cos_init, tr.priors.cos_init.cpu().numpy())
        out["orbax_equal"] = bool(same)
    dist.barrier()

    # 10a: the sharded steps of the check, from the single-rank run's state, in two turns
    ref = torch.load(args["check_state"], weights_only=False)
    cons = build_constraints("track", tr.params0, statics.regions, ref["first_frame_attrs"], DEVICE)
    images = shard_view_batch(tr.mesh, torch.as_tensor(ref["images"], device=DEVICE))
    cams = shard_view_batch(tr.mesh, src.cameras)
    out["check"] = []
    for _ in range(2):
        state, priors = to_device(ref["state"], DEVICE), to_device(ref["priors"], DEVICE)
        out["check"].append(timed_steps(sharded_step, MULTI_CHECK_STEPS, state, priors, images, cams, cons,
                                        ref["lr"], ref["weights"], "track"))
    return out


def rank_dense(rank, world, cfg, src, params_np, statics):
    """Phase 10b on one rank: ``DENSE_SHARD_STEPS`` tile-sharded dense steps
    through ``fit_frame_texture`` (the frame's frozen binnings; compact, then
    the full canvas) with the bytes of each all-reduce, and on rank 0 the same
    steps on one rank while rank 1 waits; ms per step of both; then each
    all-reduce size alone, every rank in step."""
    import copy

    import torch.distributed as dist

    from topo4d_tpu_torch.pipeline.trainer import Trainer

    tex_frame = src.frame(1, full_res=True)
    sizes = []
    real_all_reduce = dist.all_reduce

    def recording(t, *a, **k):
        sizes.append(t.numel() * t.element_size())
        return real_all_reduce(t, *a, **k)

    out = {}
    for mode, cap in (("compact", -1), ("full canvas", 0)):
        res = {}
        for shard in (True, False) if rank == 0 else (True,):
            dcfg = copy.deepcopy(cfg)
            dcfg.texture.tile_shard = shard
            dcfg.texture.tile_capacity = cap
            dcfg.schedule.dense_opt_num = DENSE_SHARD_STEPS
            dcfg.schedule.dense_log_freq = 1
            tr = Trainer(dcfg, src, params_np, statics, device=DEVICE)
            sizes.clear()
            torch.cuda.synchronize()
            reset_counts()
            dist.all_reduce = recording
            try:
                t0 = time.perf_counter()
                tr.fit_frame_texture(0, tex_frame)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                dist.all_reduce = real_all_reduce
            res[shard] = {
                "rows": list(tr.metrics_log), "wall": wall, "counts": read_counts(), "all_reduce": list(sizes),
                "params": {k: v.detach().cpu() for k, v in tr.texture_state.params.items()},
                "step_ms": time_texture_steps(tr, tex_frame, DENSE_SHARD_STEPS),
            }
            del tr
        dist.barrier()  # rank 1 waits here while rank 0 runs the single-rank steps
        out[mode] = res
    ar = {}
    for nbytes in sorted(set(out["compact"][True]["all_reduce"] + out["full canvas"][True]["all_reduce"])):
        t = torch.zeros(nbytes // 4, dtype=torch.float32, device=DEVICE)
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            real_all_reduce(t)
        torch.cuda.synchronize()
        ar[nbytes] = (time.perf_counter() - t0) / 3 * 1e3
    return {"dense": out, "all_reduce_ms": ar}


def rank_bake(rank, world, statics):
    """Phase 10c on one rank: the sharded 8192^2 bake of phase 3's inputs
    (``MULTI_BANDS[world]`` row bands) -> its digest, ms and launches."""
    from topo4d_tpu_torch.pipeline.export import build_bake_binning
    from topo4d_tpu_torch.texture.bake_tiled import bake_texture_sharded

    nd = statics.dense.topo.dense_vertices.shape[0]
    binning = build_bake_binning(statics, TEX_RES, DEVICE)
    colors = torch.rand((nd, 3), device=DEVICE, generator=torch.Generator(DEVICE).manual_seed(21))  # phase 3's
    times = []
    for i in range(2):
        torch.cuda.synchronize()
        if i == 0:
            reset_counts()
        t0 = time.perf_counter()
        canvas = bake_texture_sharded(None, None, colors, TEX_RES, TEX_RES, bands=MULTI_BANDS[world],
                                      binning=binning, device=DEVICE)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            counts = read_counts()
    return {"bake_digest": canvas_digest(canvas), "bake_ms": times, "bake_counts": counts}


def task_pair(rank, world, args):
    cfg, src, trainer, scene = build_main_path(**MULTI_MAIN_PATH)
    params_np, statics = scene[3], trainer.statics
    for t in range(1, FRAMES + 1):  # the targets, rendered here: the run's read-ahead launches nothing
        src.frame(t)
    out = rank_batched(rank, world, args, cfg, src, params_np, statics)
    out.update(rank_dense(rank, world, cfg, src, params_np, statics))
    out.update(rank_bake(rank, world, statics))
    return out


def task_bake(rank, world, args):
    _, _, trainer, _ = build_main_path(**MULTI_MAIN_PATH)
    return rank_bake(rank, world, trainer.statics)


MULTI_TASKS = {"pair": task_pair, "bake": task_bake}


def max_scaled_err(a, b) -> float:
    """max |a - b| / max |b| over a leaf."""
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-8))


def nccl_world_of_one(tr, images, cams):
    """Phase 10d: one process, NCCL on ``cuda:0``; the sharded loss of the
    24 views and its gradient, and one sharded step, against the unsharded
    step's bit for bit (a one-rank all-reduce is the identity)."""
    import torch.distributed as dist

    from topo4d_tpu_torch.core.gaussian import activate_params
    from topo4d_tpu_torch.parallel.batched import make_batched_geometry_step
    from topo4d_tpu_torch.parallel.mesh import make_view_mesh
    from topo4d_tpu_torch.parallel.sharded import local_view_sums, make_sharded_view_loss

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    try:
        backend = dist.get_backend()
        mesh = make_view_mesh(1, device=DEVICE)
        sharded = make_sharded_view_loss(tr.render_fn, mesh)
        res = {}
        for name in ("sharded", "unsharded"):
            params = {k: v.detach().clone().requires_grad_(True) for k, v in tr.state.params.items()}
            rv = activate_params(params)
            if name == "sharded":
                loss, _, radii = sharded(params, rv, images, cams)
            else:
                photo, _, radii = local_view_sums(tr.render_fn, params, rv, images, cams)
                loss = photo / torch.tensor(float(images.shape[0]), device=images.device)
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            res[name] = (loss.detach(), radii, {k: g for k, g in zip(params, grads) if g is not None})
        (ls, rs, gs), (lu, ru, gu) = res["sharded"], res["unsharded"]
        if not (torch.equal(ls, lu) and torch.equal(rs, ru) and gs.keys() == gu.keys()
                and all(torch.equal(gs[k], gu[k]) for k in gu)):
            raise AssertionError(f"phase 10d: the sharded loss on a NCCL world of one differs from the unsharded: "
                                 f"{float(ls)} vs {float(lu)}; grads " + ", ".join(
                                     f"{k} {float((gs[k] - gu[k]).abs().max()):.2e}" for k in gu))
        st = tr.statics
        step = make_batched_geometry_step(st.quadruples, st.umbrellas, tr.render_fn, st.ring.indices.shape[0],
                                          ring_indices=st.ring.indices, device=DEVICE, mesh=mesh)
        args = (tr._constraints("track"), tr.lrs_for("track"), tr.weights_for("track"), "track")
        states = []
        for fn in (step, tr.batched_step):
            state, priors = batched_state(tr, DEVICE)
            states.append(fn(state, images, cams, priors, *args))
        (s1, _, m1), (s2, _, m2) = states
        if not (torch.equal(m1["loss_total"], m2["loss_total"]) and state_digest(s1) == state_digest(s2)):
            raise AssertionError("phase 10d: a sharded step on a NCCL world of one differs from the unsharded step")
    finally:
        dist.destroy_process_group()
    log(f"phase 10d: backend {backend}, one rank on cuda:0: the sharded loss of {images.shape[0]} views "
        f"({float(ls):.6f}), its radii and the gradients of {len(gu)} leaves, and one sharded batched step, equal "
        "to the unsharded step's bit for bit")


def phase_multi(cfg, src, frames, batched, bake_inputs):
    """Phase 10, several ranks on the one card (gloo; two processes share
    ``cuda:0``, so no number here says anything of NCCL across cards): the
    view-sharded batched run of 2 ranks with per-step bit identity, the
    check of three sharded steps against three single-rank ones, resume and
    mismatch, the orbax backend; tile-sharded dense steps against one
    rank's; the sharded bake on 2 and 3 ranks against phase 3's canvas; a
    NCCL world of one."""
    from topo4d_tpu_torch.texture.bake_tiled import bake_canvas_cuda

    shutil.rmtree(MULTI_DIR, ignore_errors=True)
    os.makedirs(MULTI_DIR)
    tr = batched["trainer"]
    views = src.num_views
    images = torch.as_tensor(frames[FRAMES][0].images, device=DEVICE)
    ref = {"state": to_device(tr.state, "cpu"), "priors": to_device(tr.priors, "cpu"),
           "first_frame_attrs": tr.first_frame_attrs, "images": images.cpu(), "lr": tr.lrs_for("track"),
           "weights": tr.weights_for("track")}
    check_path = os.path.join(MULTI_DIR, "check_state.pt")
    torch.save(ref, check_path)
    cons = tr._constraints("track")

    def single_turn():
        state, priors = batched_state(tr, DEVICE)
        return timed_steps(tr.batched_step, MULTI_CHECK_STEPS, state, priors, images, src.cameras, cons,
                           ref["lr"], ref["weights"], "track")

    single = [single_turn()]
    binning = bake_inputs[0]
    nd = tr.statics.dense.topo.dense_vertices.shape[0]
    colors = torch.rand((nd, 3), device=DEVICE, generator=torch.Generator(DEVICE).manual_seed(21))
    want_bake = canvas_digest(bake_canvas_cuda(binning, colors, TEX_RES, TEX_RES))
    del colors
    torch.cuda.empty_cache()

    pair = spawn_world(2, "pair", {"check_state": check_path})
    single.append(single_turn())
    trio = spawn_world(3, "bake", {})
    for r, rep in enumerate(pair + trio):
        log(f"phase 10 rank report: backend {rep['backend']}, device {rep['device']}")

    # 10a: the view-sharded run
    total = sum(pair[0]["steps"])
    for r, rep in enumerate(pair):
        check_counts(rep["run_counts"], f"phase 10a rank {r}", {
            "tile_blend_fwd": rep["local_views"] * total, "tile_blend_bwd": rep["local_views"] * total,
            "gauss_blur": 2 * rep["local_views"] * total, "tile_blend_v3_fwd": 0, "tile_blend_v3_bwd": 0,
            "uv_bake": 0, "tile_blend_plain": 0, "gauss_blur_plain": 0, "uv_bake_plain": 0,
        })
        if rep["local_views"] != views // 2 or len(rep["digests"]) != total:
            raise AssertionError(f"phase 10a rank {r}: {rep['local_views']} views, {len(rep['digests'])} steps")
        for part in rep["run_parts"]:
            check_rows(part["rows"])
    if pair[0]["digests"] != pair[1]["digests"]:
        first = next(i for i, (a, b) in enumerate(zip(pair[0]["digests"], pair[1]["digests"])) if a != b)
        raise AssertionError(f"phase 10a: the ranks' parameters or Adam state differ after step {first}")
    tracked = [p["rows"] for p in pair[0]["run_parts"] if p["frame"] > 0][-1]
    if not tracked[-1]["loss_total"] < tracked[0]["loss_total"]:
        raise AssertionError(f"phase 10a: the tracked frame's loss did not fall: {tracked[0]} -> {tracked[-1]}")
    out_tree = os.path.join(MULTI_DIR, "run", cfg.data.exp, cfg.data.seq)
    for f in ("resume.pkl", "params.npz", "metrics.jsonl", "timings.json", "loss.json", "000001/face.obj",
              "000002/face.obj"):
        if not os.path.exists(os.path.join(out_tree, f)):
            raise AssertionError(f"phase 10a: rank 0 did not write {f}")
    for d in ("rank1_run", "elsewhere"):
        if os.path.exists(os.path.join(MULTI_DIR, d)):
            raise AssertionError(f"phase 10a: rank 1 created {d}/")
    geo = pair[0]["run_parts"][-1]
    nb = pair[0]["steps"][-1]
    log(
        f"phase 10a: view-sharded Trainer.run, 2 ranks x {views // 2} views on cuda:0 (gloo), {FRAMES} frames, "
        f"{total} batched steps: {pair[0]['run_wall']:.3f} s (each step's state read back for its digest); "
        f"tracked frame {geo['wall']:.3f} s, {geo['wall'] / nb * 1e3:.3f} ms per batched step (phase 8, one rank: "
        f"{batched['ms_per_step']:.3f}); loss {tracked[0]['loss_total']:.6f} -> {tracked[-1]['loss_total']:.6f}; "
        f"parameters, Adam moments and radii equal on both ranks after each of the {total} steps; launches per rank "
        f"{pair[0]['run_counts']}; rank 0 alone wrote {out_tree}"
    )
    # 10a: three sharded steps against three single-rank steps, from one state
    ls, ps, _, _ = pair[0]["check"][0]
    lu, pu, _, _ = single[0]
    np.testing.assert_allclose(np.array(ls), np.array(lu), rtol=1e-4)
    for r in range(2):
        if pair[r]["check"][0][3] != pair[0]["check"][0][3] or pair[r]["check"][1][3] != pair[0]["check"][0][3]:
            raise AssertionError(f"phase 10a: rank {r}'s check steps differ from rank 0's")
    lr = ref["lr"]
    worst = [assert_leaf_close(k, ps[k], pu[k], 2 * lr[k] * MULTI_CHECK_STEPS) for k in pu]
    scaled = {k: max_scaled_err(ps[k], pu[k]) for k in pu}
    turns = {"single": [single[0][2], single[1][2]], "sharded": [pair[0]["check"][0][2], pair[0]["check"][1][2]]}
    log(
        f"phase 10a: {MULTI_CHECK_STEPS} sharded track steps against one rank's (fresh binnings both): loss rel err "
        f"{float(np.max(np.abs(np.array(ls) - np.array(lu)) / np.abs(np.array(lu)))):.2e}; " + "; ".join(worst)
        + "; max-scaled errors " + ", ".join(f"{k} {v:.2e}" for k, v in scaled.items())
        + f" (within rtol 1e-4 / atol 1e-6: {all(v <= 1e-6 + 1e-4 for v in scaled.values())})"
        + "; ms per batched step in turns: single " + ", ".join(f"{x:.3f}" for x in turns["single"])
        + ", 2 ranks " + ", ".join(f"{x:.3f}" for x in turns["sharded"])
    )

    # 10e: resume, mismatch, orbax
    for r, rep in enumerate(pair):
        if any(rep["resume_counts"].values()) or not rep["resume_equal"]:
            raise AssertionError(f"phase 10e rank {r}: the resumed run launched {rep['resume_counts']}")
        if "resume checkpoint mismatch" not in rep["mismatch"] or "shared filesystem" not in rep["mismatch"]:
            raise AssertionError(f"phase 10e rank {r}: a mismatched output_dir gave {rep['mismatch']!r}")
    if not pair[0]["orbax_equal"]:
        raise AssertionError("phase 10e: the orbax backend did not round-trip the state on the card")
    log(f"phase 10e: a 2-rank run(resume=True) launched nothing; a rank on another output_dir made both raise "
        f"({pair[1]['mismatch'][:120]}...); the orbax backend round-tripped the run's state on rank 0")

    # 10b: tile-sharded dense steps
    dense = {}
    for mode in ("compact", "full canvas"):
        sh, one = pair[0]["dense"][mode][True], pair[0]["dense"][mode][False]
        evals = sum("tex_psnr_fixed" in r for r in sh["rows"])
        for r, rep in enumerate(pair):
            check_counts(rep["dense"][mode][True]["counts"], f"phase 10b {mode} rank {r}", {
                "tile_blend_fwd": DENSE_SHARD_STEPS + evals, "tile_blend_bwd": DENSE_SHARD_STEPS,
                "gauss_blur": 2 * DENSE_SHARD_STEPS, "tile_blend_plain": 0, "gauss_blur_plain": 0,
            })
            if not all(torch.equal(rep["dense"][mode][True]["params"][k], sh["params"][k]) for k in sh["params"]):
                raise AssertionError(f"phase 10b {mode}: rank {r}'s dense parameters differ from rank 0's")
        if len(sh["rows"]) != len(one["rows"]) or any(a != b for a, b in zip(sh["rows"], one["rows"])):
            raise AssertionError(f"phase 10b {mode}: tile-sharded rows differ from one rank's: {sh['rows']} vs "
                                 f"{one['rows']}")
        if not all(torch.equal(sh["params"][k], one["params"][k]) for k in one["params"]):
            raise AssertionError(f"phase 10b {mode}: tile-sharded dense parameters differ from one rank's")
        dense[mode] = {"sharded_ms": sh["step_ms"], "single_ms": one["step_ms"], "bytes": sh["all_reduce"],
                       "counts": sh["counts"]}
        log(
            f"phase 10b {mode}: {DENSE_SHARD_STEPS} tile-sharded dense steps at {FULL_W}x{FULL_H} on 2 ranks (and "
            f"{evals} eval renders) equal one rank's in every row and parameter; launches per rank {sh['counts']}; "
            f"all-reduces {len(sh['all_reduce'])} (one per render, one per backward), bytes "
            + ", ".join(str(b) for b in sorted(set(sh["all_reduce"])))
            + f"; ms per dense step: 2 ranks {sh['step_ms']:.3f}, one rank {one['step_ms']:.3f}; fit wall 2 ranks "
            f"{sh['wall']:.3f} s, one rank {one['wall']:.3f} s"
        )
    log("phase 10b: all-reduce alone on cuda:0 over gloo (2 ranks), ms: "
        + ", ".join(f"{b} B {ms:.3f}" for b, ms in sorted(pair[0]["all_reduce_ms"].items())))

    # 10c: the sharded bake
    for rep in pair + trio:
        if rep["bake_digest"] != want_bake:
            raise AssertionError("phase 10c: a sharded bake differs from phase 3's single-rank K6 canvas")
        check_counts(rep["bake_counts"], "phase 10c", {"uv_bake": 1, "uv_bake_plain": 0})
    log(
        f"phase 10c: the sharded {TEX_RES}x{TEX_RES} bake on 2 ranks ({MULTI_BANDS[2]} bands) and 3 ranks "
        f"({MULTI_BANDS[3]} bands) equals phase 3's K6 canvas bit for bit on every rank; ms (second call) "
        f"2 ranks {pair[0]['bake_ms'][1]:.3f}, 3 ranks {trio[0]['bake_ms'][1]:.3f}; K6 once per rank"
    )

    nccl_world_of_one(tr, images, src.cameras)

    def launches(reps, key):
        return {k: sum(rep[key][k] for rep in reps) for k in reps[0][key]}

    out = {
        "view_sharded": launches(pair, "run_counts"),
        "tile_sharded": {k: sum(rep["dense"][m][True]["counts"][k] for rep in pair for m in rep["dense"])
                         for k in pair[0]["run_counts"]},
        "bake": launches(pair + trio, "bake_counts"),
        "turns_ms": {k: float(np.mean(v)) for k, v in turns.items()}, "dense": dense,
        "all_reduce_ms": pair[0]["all_reduce_ms"], "bake_ms": {2: pair[0]["bake_ms"][1], 3: trio[0]["bake_ms"][1]},
        "tracked_ms_per_step": geo["wall"] / nb * 1e3,
    }
    shutil.rmtree(MULTI_DIR, ignore_errors=True)
    return out


MODE_STEPS = 10  # dense steps per run of phase 11a and 11b
TRACE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_trace")


def fit_mode(trainer, frame, mode, steps: int):
    """``trainer.fit_frame_texture`` of a tracked frame on ``frame`` (its
    images already on the card) with ``steps`` iterations under ``mode``'s
    texture and schedule fields, from the trainer's texture state, which is
    restored after -> (wall s, launch counts, metric rows, frozen binnings
    built, their seconds: each timed to a synchronize)."""
    import copy

    cfg0, state0, rows0, cap0 = trainer.cfg, trainer.texture_state, len(trainer.metrics_log), trainer._auto_tile_cap
    cfg = copy.deepcopy(cfg0)
    cfg.schedule.dense_opt_num_tracked = steps
    cfg.schedule.dense_log_freq = 1000  # one log row (iteration 0) and the terminal row
    for section, fields in mode.items():
        for k, v in fields.items():
            setattr(getattr(cfg, section), k, v)
    built = [0, 0.0]
    fresh = trainer._fresh_dense_binning

    def counted(v):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = fresh(v)
        torch.cuda.synchronize()
        built[0] += 1
        built[1] += time.perf_counter() - t0
        return b

    trainer.cfg, trainer._fresh_dense_binning = cfg, counted
    try:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        # the class's method: the main path's instrumented one would record this fit as a part of its run
        type(trainer).fit_frame_texture(trainer, 1, frame)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, rows = read_counts(), trainer.metrics_log[rows0:]
    finally:
        trainer.cfg, trainer.texture_state, trainer._auto_tile_cap = cfg0, state0, cap0
        del trainer._fresh_dense_binning
        del trainer.metrics_log[rows0:]
    return wall, counts, rows, built[0], built[1]


def modes_card_vs_cpu(cfg, trainer, scene, steps: int = 3):
    """Phase 11a's card-against-CPU check: ``fit_frame_texture`` of
    ``steps`` iterations at 480x270 on a density-1 dense mesh of the head
    grid, through a trainer on the card and one on the CPU, from the main
    path's geometry and one set of targets, at ``texture.rebin_freq`` 1
    (scan mode, fresh binnings) and in loop mode at 2: every row's loss at
    rtol 1e-4, the colors within 2 lr steps, 99.9% within 1e-6."""
    import copy

    from topo4d_tpu_torch.core.gaussian import activate_params
    from topo4d_tpu_torch.pipeline.data import FrameData, SyntheticSequence
    from topo4d_tpu_torch.pipeline.scene import build_scene
    from topo4d_tpu_torch.pipeline.trainer import Trainer
    from topo4d_tpu_torch.rasterizer.render import render_gaussians
    from topo4d_tpu_torch.testing import make_camera_ring

    mesh, regions, gt_params, params_np = scene
    cfg1 = copy.deepcopy(cfg)
    cfg1.texture.density = 1
    cfg1.schedule.dense_opt_num_tracked = steps
    cfg1.schedule.dense_log_freq = 1
    _, st1 = build_scene(mesh, regions, cfg1, num_views=24)
    cams = make_camera_ring(24, width=480, height=270, distance=2.0, device=DEVICE)
    with torch.no_grad():
        rv_gt = activate_params({k: torch.as_tensor(v, device=DEVICE) for k, v in gt_params.items()})
        targets = np.stack([render_gaussians(rv_gt, cams[v], max_span=4).image.cpu().numpy() for v in range(24)])
    frame = FrameData(images=targets, masks=None, view_names=[f"view{i:02d}" for i in range(24)])
    out = {}
    for name, fields in (("rebin_freq 1", {"rebin_freq": 1}), ("loop mode, rebin_freq 2", {"rebin_freq": 2})):
        cfg_m = copy.deepcopy(cfg1)
        for k, v in fields.items():
            setattr(cfg_m.texture, k, v)
        runs = {}
        for dev in (DEVICE, "cpu"):
            cm = camera_to(cams, dev)
            src = SyntheticSequence(params=gt_params, cameras=cm, num_frames=1, cameras_full=cm)
            tr = Trainer(cfg_m, src, params_np, st1, device=dev)
            tr.state = tr.state._replace(params={k: v.detach().to(dev) for k, v in trainer.state.params.items()})
            tr.fit_frame_texture(1, frame)
            runs[dev] = (tr.metrics_log, tr.texture_state.params["dense_rgb_colors"].cpu())
        rows_c, rows_g = runs["cpu"][0], runs[DEVICE][0]
        if len(rows_c) != len(rows_g):
            raise AssertionError(f"phase 11a {name}: {len(rows_g)} rows on the card, {len(rows_c)} on the CPU")
        lc = np.array([r["tex_loss_total"] for r in rows_c if "tex_loss_total" in r])
        lg = np.array([r["tex_loss_total"] for r in rows_g if "tex_loss_total" in r])
        np.testing.assert_allclose(lg, lc, rtol=1e-4)
        msg = assert_leaf_close("dense_rgb_colors", runs[DEVICE][1], runs["cpu"][1],
                                2 * cfg.lrs.dense["dense_rgb_colors"] * steps)
        out[name] = float(np.max(np.abs(lg - lc) / np.abs(lc)))
        log(f"phase 11a card vs CPU, {name}: {steps} texture steps at 480x270 through fit_frame_texture, loss rel "
            f"err {out[name]:.2e}; {msg}")
    return out


def phase_modes(cfg, src, trainer, scene, frames):
    """Phase 11: the dense-loop modes, remat, the profiler trace and the
    entry points, from the main path's fitted state."""
    import copy

    from topo4d_tpu_torch.entry import dryrun_multichip, entry
    from topo4d_tpu_torch.pipeline.data import frame_tensor, view_order
    from topo4d_tpu_torch.pipeline.trainer import Trainer, make_dense_render_fn
    from topo4d_tpu_torch.texture.dense import make_texture_step
    from topo4d_tpu_torch.utils.profiling import device_trace

    from topo4d_tpu_torch.pipeline.data import FrameData

    t_phase = time.perf_counter()
    last_tex = frames[FRAMES][1]
    # the frame's targets on the card once: a fit then moves no image from the host
    on_card = FrameData(images=frame_tensor(last_tex.images, DEVICE), masks=None, view_names=last_tex.view_names)
    out = {"counts": {}}
    no_plain = {"tile_blend_plain": 0, "gauss_blur_plain": 0, "tile_blend_v3_fwd": 0, "tile_blend_v3_bwd": 0}

    # 11a: the dense loop's modes, in turns
    modes = {
        "scan, rebin_freq 0": {},
        "scan, rebin_freq 1": {"texture": {"rebin_freq": 1}},
        "loop, rebin_freq 5": {"texture": {"rebin_freq": 5}},
    }
    ms, built, counts_a = {m: [] for m in modes}, {}, {}
    for name in list(modes) + list(modes)[::-1]:
        wall, counts, rows, n_bins, bin_s = fit_mode(trainer, on_card, modes[name], MODE_STEPS)
        evals = sum("tex_psnr_fixed" in r for r in rows)
        check_rows(rows)
        check_counts(counts, f"phase 11a {name}", {
            "tile_blend_fwd": MODE_STEPS + evals, "tile_blend_bwd": MODE_STEPS, "gauss_blur": 2 * MODE_STEPS,
            **no_plain,
        })
        ms[name].append(wall / MODE_STEPS * 1e3)
        built[name] = (n_bins, bin_s * 1e3)
        counts_a = {k: counts_a.get(k, 0) + c for k, c in counts.items()}
    out["counts"]["phase 11a dense modes"] = counts_a
    out["modes_ms"] = {m: float(np.mean(v)) for m, v in ms.items()}
    out["binnings"] = {m: {"count": b[0], "ms": b[1]} for m, b in built.items()}
    log(f"phase 11a: {MODE_STEPS} dense steps at {FULL_W}x{FULL_H} through fit_frame_texture per mode, in turns, ms "
        "per step (the fit's wall over its steps: its frozen binnings and 2 eval renders included): "
        + "; ".join(f"{m} {', '.join(f'{x:.3f}' for x in v)} ({built[m][0]} frozen binnings, {built[m][1]:.1f} ms "
                    "in the last run)" for m, v in ms.items())
        + "; K1/K2 once per step (K1 once more per eval render), K5 twice")
    out["modes_card_vs_cpu"] = modes_card_vs_cpu(cfg, trainer, scene)

    # 11b: remat on and off, in turns, from one state
    images = on_card.images
    binnings = trainer.dense_binnings(1)
    order = [int(v) for v in view_order(24, MODE_STEPS, seed=11)]
    render = make_dense_render_fn(cfg, DEVICE)
    steps = {r: make_texture_step(render, remat=r) for r in (False, True)}
    args = (trainer.dense_anchor, trainer._dense_pre, dict(cfg.lrs.dense), cfg.dense_weights.as_dict())
    remat = {r: {"ms": [], "peak": [], "digest": set()} for r in (False, True)}
    counts_b = {}
    for r in (False, True):  # warm: the first checkpointed step sets up the checkpoint's machinery
        steps[r](trainer.texture_state, trainer.dense_means3d, images[order[0]], src.cameras_full, order[0], *args,
                 binnings[order[0]], with_metrics=False)
    for r in (False, True, True, False):
        state = trainer.texture_state
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        for v in order:
            state, _ = steps[r](state, trainer.dense_means3d, images[v], src.cameras_full, v, *args, binnings[v],
                                with_metrics=False)
        torch.cuda.synchronize()
        remat[r]["ms"].append((time.perf_counter() - t0) / MODE_STEPS * 1e3)
        remat[r]["peak"].append(torch.cuda.max_memory_allocated() - base)
        counts = read_counts()
        check_counts(counts, f"phase 11b remat {r}", {
            "tile_blend_fwd": MODE_STEPS, "tile_blend_bwd": MODE_STEPS, "gauss_blur": (3 if r else 2) * MODE_STEPS,
            **no_plain,
        })
        counts_b = {k: counts_b.get(k, 0) + c for k, c in counts.items()}
        remat[r]["digest"].add(state_digest(state))
        del state
    if len(remat[False]["digest"] | remat[True]["digest"]) != 1:
        raise AssertionError("phase 11b: the dense state after the remat steps differs from the steps without")
    del images, on_card
    out["counts"]["phase 11b remat"] = counts_b
    out["remat"] = {("on" if r else "off"): {"ms": float(np.mean(v["ms"])), "peak_bytes": int(max(v["peak"]))}
                    for r, v in remat.items()}
    log(f"phase 11b: {MODE_STEPS} dense steps at {FULL_W}x{FULL_H}, remat_photometric off / on in turns: ms per step "
        f"{', '.join(f'{x:.3f}' for x in remat[False]['ms'])} / {', '.join(f'{x:.3f}' for x in remat[True]['ms'])}; "
        f"peak device memory above the state, MiB {', '.join(f'{x / 2**20:.1f}' for x in remat[False]['peak'])} / "
        f"{', '.join(f'{x / 2**20:.1f}' for x in remat[True]['peak'])}; parameters and Adam moments equal bit for bit "
        "(SHA-256); K5 three times per step under remat, twice without")

    # 11c: a one-frame Trainer.run traced, and the same run untraced
    _, _, _, params_np = scene
    cfg_t = copy.deepcopy(cfg)
    cfg_t.schedule.frame_num = 1
    cfg_t.schedule.init_opt_num = 20
    cfg_t.schedule.dense_opt_num = 11
    cfg_t.schedule.dense_log_freq = 10
    cfg_t.texture.tex_res = min(1024, TEX_RES)  # the export's bake is not what this run measures
    runs = {}
    for traced in (False, True):
        cfg_t.data.output_dir = os.path.join(TRACE_DIR, "traced" if traced else "plain")
        tr = Trainer(cfg_t, src, params_np, trainer.statics, device=DEVICE)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with device_trace(os.path.join(TRACE_DIR, "trace") if traced else None, device=DEVICE) as tracing:
            if tracing != traced:
                raise AssertionError("phase 11c: device_trace did not trace as asked")
            tr.run(resume=False)
            torch.cuda.synchronize()
        runs[traced] = (time.perf_counter() - t0, read_counts())
    path = os.path.join(TRACE_DIR, "trace", "trace_rank0.json")
    size = os.path.getsize(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    kernels_in = {name: sum(1 for e in events if e.get("cat") == "kernel" and f"{name}_kernel" in e.get("name", ""))
                  for name in ("tile_blend_fwd", "tile_blend_bwd", "gauss_blur")}
    counts = runs[True][1]
    for name, n in kernels_in.items():
        if n != counts[name]:
            raise AssertionError(f"phase 11c: the trace holds {n} {name} kernels, the counter {counts[name]}")
    n_steps = cfg_t.schedule.init_opt_num + cfg_t.schedule.dense_opt_num
    out["counts"]["phase 11c traced run"] = counts
    out["trace"] = {"bytes": size, "bytes_per_step": size / n_steps, "events": len(events),
                    "s_per_frame": {"traced": runs[True][0], "untraced": runs[False][0]}}
    log(f"phase 11c: a one-frame Trainer.run ({cfg_t.schedule.init_opt_num} init and {cfg_t.schedule.dense_opt_num} "
        f"dense steps, export at {cfg_t.texture.tex_res}^2) under device_trace: {runs[True][0]:.3f} s, untraced "
        f"{runs[False][0]:.3f} s; the trace {size} bytes ({size / n_steps:.0f} per step, {len(events)} events); its "
        f"kernel events {kernels_in} equal the counters")
    shutil.rmtree(TRACE_DIR, ignore_errors=True)

    # 11d: entry on the card against its plain version
    fn, args_e = entry(DEVICE)
    torch.cuda.synchronize()
    reset_counts()
    loss = float(fn(*args_e))
    counts = read_counts()
    check_counts(counts, "phase 11d entry", {"tile_blend_fwd": 1, "gauss_blur": 1, "tile_blend_bwd": 0, **no_plain})
    out["counts"]["phase 11d entry"] = counts
    fn_c, args_c = entry("cpu")
    loss_c = float(fn_c(*args_c))
    np.testing.assert_allclose(loss, loss_c, rtol=1e-5)
    out["entry"] = {"loss": loss, "plain_loss": loss_c}
    log(f"phase 11d: entry('cuda') loss {loss:.8f} against its plain version {loss_c:.8f} (rel err "
        f"{abs(loss - loss_c) / abs(loss_c):.2e}); K1 and K5 once per call")

    # 11e: the dryrun on a NCCL world of one
    t0 = time.perf_counter()
    dry = dryrun_multichip(1, DEVICE)
    if not all(np.isfinite(v) for v in dry.values()):
        raise AssertionError(f"phase 11e: non-finite dryrun results {dry}")
    out["dryrun"] = dry
    log(f"phase 11e: dryrun_multichip(1, 'cuda') on NCCL, {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {v:.5f}" for k, v in dry.items()))
    out["wall"] = time.perf_counter() - t_phase
    log(f"phase 11: {out['wall']:.1f} s")
    return out


FACE3D_RENDER = 256  # the scanline renders' side
FACE3D_CROP_RINGS = (54, 90)  # the rings whose triangles the NumPy oracle renders: a quarter of the head
FACE3D_ANGLES = [10.0, -20.0, 5.0]  # the pose of the rendered head (degrees), at scale 1.1 px per unit
FACE3D_BANDS = 64  # the "xla" bake's row bands at 8192^2: ~1e8 (pixel, triangle) pairs in each
SEED = 0  # --seed: phase 12's synthetic morphable model and its coefficients


def held(name, got, want, rtol, atol, phase="12a"):
    """``got`` (on the card) against ``want`` (on the CPU) -> max |err|;
    raises past rtol / atol."""
    got = got.detach().cpu()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"phase {phase}: {name} on the card differs from the CPU: max|err| {err:.3e} "
                             f"(rtol {rtol:g}, atol {atol:g})")
    return err


def phase_face3d(statics, bake_inputs):
    """Phase 12: the face3d library surface (``mesh3d``) and the "xla" bake.

    a. a synthetic morphable model from ``--seed`` at the Basel Face Model's
       shapes (53,215 vertices, 105,840 triangles, 199 / 29 / 199
       components, 68 keypoints) on the card: ``generate_vertices``,
       ``generate_colors``, ``transform``, ``get_normal``, ``add_light``,
       ``add_light_sh``, ``fit_light_sh`` and ``fit_points`` (4 iterations on
       the keypoints), each against the same call on the CPU on the same
       inputs (the tests' tolerances: rtol 1e-5 with atol 1e-6, of the
       largest magnitude for the generated coordinates and colors; the SH
       fit atol 1e-5; the keypoint fit's s, R, t and reprojection within
       1e-4 relative), ms per call;
    b. the C++ scanline library built by the host compiler: the posed head
       through ``to_image`` at 256x256, ``render_colors``,
       ``rasterize_triangles`` and ``render_texture`` (bilinear) against
       ``mesh_numpy`` on the triangles of rings 54-89 (the NumPy loop over
       all of them takes ~8 s a function): triangle ids equal, colors rtol
       1e-5 / atol 1e-6, depth rtol 1e-5 / atol 1e-5, barycentrics rtol 1e-4
       / atol 1e-5; ms per render of the whole head;
    c. the "xla" bake (``texture/bake.py``) at 8192^2 on phase 3's dense UV
       layout and seeded colors, its window sized from the layout (printed;
       too small a window raises), against K6's canvas: bit for bit, or the
       differing pixels counted and bounded at 1e-4 of the canvas; ms of
       both.
    -> the numbers."""
    from topo4d_tpu_torch.mesh3d import bfm, light, mesh_numpy, scanline, transform
    from topo4d_tpu_torch.pipeline.export import uv_to_vertex
    from topo4d_tpu_torch.testing import make_synthetic_bfm
    from topo4d_tpu_torch.texture.bake import bake_texture
    from topo4d_tpu_torch.texture.bake_tiled import bake_canvas_cuda, process_uv

    t_phase = time.perf_counter()
    out = {"ms": {}, "err": {}}

    # 12a: the mesh3d surface on the card against the CPU
    t0 = time.perf_counter()
    model = make_synthetic_bfm(SEED, device=DEVICE)
    host = model.to("cpu")
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in model if t is not None)
    log(f"phase 12a: synthetic morphable model (seed {SEED}): {model.nver} vertices, {model.triangles.shape[0]} "
        f"triangles, {model.n_shape_para} / {model.n_exp_para} / {model.tex_pc.shape[1]} components, "
        f"{model.kpt_ind.shape[0]} keypoints, {nbytes / 2**20:.1f} MiB on the card, made in "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(SEED)
    sp = (rng.standard_normal(model.n_shape_para) * host.shape_ev.numpy()).astype(np.float32)
    ep = (rng.standard_normal(model.n_exp_para) * host.exp_ev.numpy()).astype(np.float32)
    tp = rng.standard_normal(host.tex_pc.shape[1]).astype(np.float32)
    coeff = rng.normal(size=9).astype(np.float32)
    light_pos = np.array([[0.0, 50.0, 400.0], [-300.0, 200.0, 300.0]], np.float32)
    light_int = np.array([[1.0, 0.9, 0.8], [0.4, 0.4, 0.6]], np.float32)
    # the inputs of each call, made on the CPU: both sides see the same ones
    v = bfm.generate_vertices(host, sp, ep)
    colors = bfm.generate_colors(host, tp)
    posed = bfm.transform(host, v, 1.1, FACE3D_ANGLES, [0.0, 0.0, 0.0])
    normals = light.get_normal(posed, host.triangles)
    lit_sh = light.add_light_sh(posed, host.triangles, colors, coeff)
    cpu_in = {"v": v, "colors": colors, "posed": posed, "normals": normals, "lit_sh": lit_sh,
              "x2d": posed[host.kpt_ind, :2].contiguous()}
    dev_in = {k: x.to(DEVICE) for k, x in cpu_in.items()}
    scaled = lambda ref: dict(rtol=1e-5, atol=1e-6 * float(ref.abs().max()))  # noqa: E731
    calls = {
        "generate_vertices": (lambda m, i: bfm.generate_vertices(m, sp, ep), scaled(v)),
        "generate_colors": (lambda m, i: bfm.generate_colors(m, tp), scaled(colors)),
        "transform": (lambda m, i: bfm.transform(m, i["v"], 1.1, FACE3D_ANGLES, [0.0, 0.0, 0.0]), scaled(posed)),
        "get_normal": (lambda m, i: light.get_normal(i["posed"], m.triangles), dict(rtol=1e-5, atol=1e-6)),
        "add_light": (lambda m, i: light.add_light(i["posed"], m.triangles, i["colors"], light_pos, light_int),
                      dict(rtol=1e-5, atol=1e-6)),
        "add_light_sh": (lambda m, i: light.add_light_sh(i["posed"], m.triangles, i["colors"], coeff),
                         dict(rtol=1e-5, atol=1e-6)),
        "fit_light_sh": (lambda m, i: light.fit_light_sh(i["lit_sh"], i["colors"], i["normals"]),
                         dict(rtol=1e-5, atol=1e-5)),
    }
    for name, (fn, tol) in calls.items():
        out["err"][name] = held(name, fn(model, dev_in), fn(host, cpu_in), **tol)
        out["ms"][name] = cuda_ms(lambda: fn(model, dev_in), iters=10, warmup=2)
    fit = lambda m, i: bfm.fit_points(i["x2d"], m.kpt_ind, m, max_iter=4)  # noqa: E731
    got, want = fit(model, dev_in), fit(host, cpu_in)

    def reprojection(sp_, ep_, s, r, t):
        return s * bfm.generate_vertices(host, sp_, ep_)[host.kpt_ind] @ r[:2].T + t[:2]

    got = [x.cpu() for x in got]
    fit_err = {k: float((g - w).abs().max() / w.abs().max()) for k, g, w in zip("srt", got[2:], want[2:])}
    rp, rp_want = reprojection(*got), reprojection(*want)
    fit_err["reprojection"] = float((rp - rp_want).abs().max() / rp_want.abs().max())
    fit_err["to_keypoints"] = float((rp_want - cpu_in["x2d"]).abs().max() / cpu_in["x2d"].abs().max())
    if max(fit_err[k] for k in ("s", "r", "t", "reprojection")) > 1e-4:
        raise AssertionError(f"phase 12a: fit_points on the card differs from the CPU by more than 1e-4: {fit_err}")
    out["err"]["fit_points"] = fit_err
    out["ms"]["fit_points"] = cuda_ms(lambda: fit(model, dev_in), iters=5, warmup=1)
    log("phase 12a: on the card against the CPU, max|err| " + ", ".join(
        f"{k} {e:.2e}" for k, e in out["err"].items() if k != "fit_points")
        + "; fit_points relative " + ", ".join(f"{k} {e:.2e}" for k, e in fit_err.items())
        + f" (s {float(want[2]):.5f}); ms per call on the card " + ", ".join(
        f"{k} {t:.3f}" for k, t in out["ms"].items()))

    # 12b: the C++ scanline library against the NumPy tier
    res = FACE3D_RENDER
    img_v = transform.to_image(posed, res, res).numpy()
    tris = host.triangles.numpy()
    cols = colors.numpy()
    around = 367  # make_synthetic_bfm's vertices per ring; ring r's quads are triangles 2 r around ..
    ring, col = np.divmod(np.arange(model.nver), around)
    tex_coords = np.stack([col / (around - 1), ring / ring.max()], 1).astype(np.float32) * (res - 1)
    texture = rng.uniform(0.0, 1.0, (res, res, 3)).astype(np.float32)
    lo, hi = FACE3D_CROP_RINGS
    crop = tris[2 * lo * around : 2 * hi * around]
    renders = {
        "render_colors": lambda tr, mod: mod.render_colors(img_v, tr, cols, res, res),
        "rasterize_triangles": lambda tr, mod: mod.rasterize_triangles(img_v, tr, res, res),
        "render_texture": lambda tr, mod: mod.render_texture(img_v, tr, texture, tex_coords, tr, res, res, True),
    }
    out["scanline_ms"], out["numpy_s"] = {}, {}
    for name, fn in renders.items():
        t0 = time.perf_counter()
        for _ in range(5):
            full = fn(tris, scanline)
        out["scanline_ms"][name] = (time.perf_counter() - t0) / 5 * 1e3
        t0 = time.perf_counter()
        oracle = fn(crop, mesh_numpy)
        out["numpy_s"][name] = time.perf_counter() - t0
        got = fn(crop, scanline)
        if name == "rasterize_triangles":
            np.testing.assert_array_equal(got[1], oracle[1], err_msg="phase 12b: triangle ids")
            np.testing.assert_allclose(got[0], oracle[0], rtol=1e-5, atol=1e-5, err_msg="phase 12b: depth")
            np.testing.assert_allclose(got[2], oracle[2], rtol=1e-4, atol=1e-5, err_msg="phase 12b: barycentrics")
            covered = float((got[1] >= 0).mean())
            out["covered"] = (covered, float((full[1] >= 0).mean()))
        else:
            np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-6, err_msg=f"phase 12b: {name}")
    log(f"phase 12b: the library {scanline._lib()._name} on {crop.shape[0]} triangles (rings {lo}-{hi - 1}) at "
        f"{res}x{res} equal to mesh_numpy's (ids "
        f"bit for bit, {100 * out['covered'][0]:.1f}% of the pixels covered; the whole head "
        f"{100 * out['covered'][1]:.1f}%); ms per render of all {tris.shape[0]} triangles in the library: "
        + ", ".join(f"{k} {t:.2f}" for k, t in out["scanline_ms"].items())
        + "; s of mesh_numpy on the crop: " + ", ".join(f"{k} {t:.2f}" for k, t in out["numpy_s"].items()))

    # 12c: the "xla" bake at TEX_RES against K6
    binning = bake_inputs[0]
    nd = statics.dense.topo.dense_vertices.shape[0]
    bake_colors = torch.rand((nd, 3), device=DEVICE, generator=torch.Generator(DEVICE).manual_seed(21))
    uv_px = process_uv(statics.dense.topo.dense_uvs.copy(), TEX_RES, TEX_RES)
    uv_tris = statics.dense.tri_uv_faces
    uv32 = uv_px.astype(np.float32)  # the corners the bake checks and rasterizes
    tx, ty = uv32[:, 0][uv_tris], uv32[:, 1][uv_tris]
    span = max(float((tx.max(1) - tx.min(1)).max()), float((ty.max(1) - ty.min(1)).max()))
    window = int(np.floor(span)) + 1
    uv_colors = bake_colors[torch.as_tensor(uv_to_vertex(statics), device=DEVICE)]
    bake = lambda: bake_texture(uv_px, uv_tris, uv_colors, TEX_RES, TEX_RES, window=window,  # noqa: E731
                                bands=FACE3D_BANDS, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    xla = bake()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    k6 = bake_canvas_cuda(binning, bake_colors, TEX_RES, TEX_RES)
    torch.cuda.synchronize()
    differ = int((xla != k6).any(-1).sum())
    out["bake"] = {"window": window, "span": span, "bands": FACE3D_BANDS, "differ": differ, "first_s": first_s,
                   "peak_bytes": peak}
    if differ:
        where = torch.nonzero((xla != k6).any(-1))[:5].tolist()
        log(f"phase 12c: {differ} pixels differ from K6, e.g. {where}: xla {xla[tuple(zip(*where))].tolist()} "
            f"K6 {k6[tuple(zip(*where))].tolist()}")
        if differ > 1e-4 * TEX_RES * TEX_RES:
            raise AssertionError(f"phase 12c: the xla bake differs from K6 in {differ} pixels, over 1e-4 of the canvas")
    out["bake"]["xla_ms"] = cuda_ms(bake, iters=2, warmup=0)
    out["bake"]["k6_ms"] = cuda_ms(lambda: bake_canvas_cuda(binning, bake_colors, TEX_RES, TEX_RES), iters=20)
    del xla, k6
    log(f"phase 12c: the xla bake at {TEX_RES}x{TEX_RES}, {uv_tris.shape[0]} triangles: the largest bbox spans "
        f"{span:.2f} px, so window {window} (the default bake_window 16 {'would raise' if span >= 16 else 'suffices'}), "
        f"{FACE3D_BANDS} bands, peak "
        f"{peak / 2**30:.2f} GiB; " + ("bit for bit equal to K6's canvas" if not differ else f"{differ} pixels differ")
        + f"; {out['bake']['xla_ms']:.3f} ms per bake (first call {first_s * 1e3:.1f} ms) against K6's "
        f"{out['bake']['k6_ms']:.4f} ms")
    out["wall"] = time.perf_counter() - t_phase
    log(f"phase 12: {out['wall']:.1f} s")
    return out


def kernel_rows(run, batched, fused, v3, cli, multi, modes, validate, errs, geo_timing, blend4k, blur, bake):
    """The ``kernels`` line: times, bounds and plain times at the shapes the
    main path gives each kernel (the largest: the 4K dense view, the 8K
    bake), the geometry shapes' numbers beside them; launches over each
    path's run with the counts set to 0 just before it: the parity
    ``Trainer.run`` (K1/K2, K5, K6), by part, the batched one and the CLI's
    (``launches_cli``, and by part), phase 10's over its ranks
    (``launches_multi_rank``), phase 11's and phase 14's by part; K4's over
    the v3 path (the first v3 run of its geometry and dense steps)."""
    counts = run["counts"]
    by_part = {f"{p['kind']} frame {p['frame']}": p["counts"] for p in run["parts"]}
    by_part.update({f"batched geometry frame {p['frame']}": p["counts"] for p in batched["parts"]})
    by_part.update({f"fused batched geometry frame {p['frame']}": p["counts"] for p in fused["parts"]})
    by_part.update({f"cli {p['kind']} frame {p['frame']}": p["counts"] for p in cli["parts"]})
    by_part.update({
        "phase 10 view-sharded run, 2 ranks": multi["view_sharded"],
        "phase 10 tile-sharded dense steps, 2 ranks": multi["tile_sharded"],
        "phase 10 sharded bake, 2 and 3 ranks": multi["bake"],
    })
    by_part.update(modes["counts"])
    by_part.update(validate["counts"])
    multi_total = {k: sum(multi[p].get(k, 0) for p in ("view_sharded", "tile_sharded", "bake"))
                   for k in counts}

    def by_path(name):
        return {part: c[name] for part, c in by_part.items()}

    def max_err(i):  # over every K1/K2/K4 comparison (the 4-tuples of compare_kernels)
        return max(e[i] for e in errs.values() if isinstance(e, tuple))

    big, small = blur[(15, FULL_H, FULL_W)], blur[(15, 512, 375)]
    rows = []
    for name, key, src, tpu in (
        ("tile_blend_fwd", "fwd", "blend_fwd.cu", "topo4d_tpu/rasterizer/pallas_blend.py:317"),
        ("tile_blend_bwd", "bwd", "blend_bwd.cu", "topo4d_tpu/rasterizer/pallas_blend.py:942"),
    ):
        t = blend4k[key]
        rows.append({
            "name": name, "route": "cuda", "source": f"topo4d_tpu_torch/csrc/{src}", "replaces": tpu,
            "launches": counts[name], "launches_by_path": by_path(name),
            "max_abs_err": max_err(0 if key == "fwd" else 1),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "shape": "4K dense view 0, compact", "geometry_shape": geo_timing[key],
            "launches_cli": cli["counts"][name],
        })
    for row in rows:  # K1 and K2
        row["redesigned"] = True
    rows[0].update(warp_entry_share=blend4k["warp_share"], refs=blend4k["fwd"]["refs"])
    tps0 = V3_TPS[0]
    for name, key, src, tpu in (
        ("tile_blend_v3_fwd", "fwd", "blend_v3_fwd.cu", "topo4d_tpu/rasterizer/pallas_blend.py:543"),
        ("tile_blend_v3_bwd", "bwd", "blend_v3_bwd.cu", "topo4d_tpu/rasterizer/pallas_blend.py:683"),
    ):
        t = blend4k[key]  # the same work as K1/K2: their bounds and plain version
        rows.append({
            "name": name, "route": "cuda", "source": f"topo4d_tpu_torch/csrc/{src}", "replaces": tpu,
            "launches": sum(c[name] for c in v3["counts"].values()), "launches_cli": cli["counts"][name],
            "launches_by_path": {f"v3 path, {path}": c[name] for path, c in v3["counts"].items()},
            "max_abs_err": max_err(2 if key == "fwd" else 3),
            "ms": blend4k["v3"][tps0][f"{key}_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None, "shape": f"4K dense view 0, compact, tps {tps0}",
            "ms_by_tps": {str(tps): v[f"{key}_ms"] for tps, v in blend4k["v3"].items()},
            "geometry_shape": {"bound_ms": geo_timing[key]["bound_ms"], "bound_by": geo_timing[key]["bound_by"],
                               "ms_by_tps": {str(tps): v[f"{key}_ms"] for tps, v in geo_timing["v3"].items()}},
            "redesigned": True,
        })
    rows[-2]["refs_by_tps"] = {str(tps): v["fwd_refs"] for tps, v in blend4k["v3"].items()}  # K4f
    rows.append({
        "name": "gauss_blur", "route": "cuda", "source": "topo4d_tpu_torch/csrc/blur.cu",
        "replaces": "topo4d_tpu/losses/blur_pallas.py:52",
        "launches": counts["gauss_blur"], "launches_by_path": by_path("gauss_blur"),
        "max_abs_err": errs["blur"], "ms": big["ms"], "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"], "library_ms": big["library_ms"], "shape": [15, FULL_H, FULL_W],
        "kernel_ms": big["kernel_ms"], "geometry_shape": small, "redesigned": True,
        "launches_cli": cli["counts"]["gauss_blur"],
    })
    rows.append({
        "name": "uv_bake", "route": "cuda", "source": "topo4d_tpu_torch/csrc/bake.cu",
        "replaces": "topo4d_tpu/texture/bake_pallas.py:216",
        "launches": counts["uv_bake"], "launches_by_path": {
            "export": counts["uv_bake"], "cli export": cli["counts"]["uv_bake"],
            "phase 10 sharded bake, 2 and 3 ranks": multi["bake"]["uv_bake"],
            "phase 11 traced run": modes["counts"]["phase 11c traced run"]["uv_bake"],
        },
        "launches_cli": cli["counts"]["uv_bake"],
        "max_abs_err": errs["bake"], "ms": bake["ms"], "plain_ms": bake["plain_ms"], "bound_ms": bake["bound_ms"],
        "bound_by": bake["bound_by"], "library_ms": None, "shape": [TEX_RES, TEX_RES, 3],
        "wrapper_ms": bake["wrapper_ms"], "culled_share": bake["cull"]["culled_share"],
        "entries_per_tile": {"max": bake["cull"]["entries_per_tile_max"], "mean": bake["cull"]["entries_per_tile_mean"]},
        "refs": bake["refs"], "redesigned": True,
    })
    for row in rows:
        row["launches_multi_rank"] = multi_total[row["name"]]
    return rows


KINDS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_kinds")
KINDS_TURNS = 4  # rounds of phase 13b's reads and decodes in turns (baseline, progressive, progressive, baseline)
REF_IMGDEC = {}  # --ref imgdec=PATH: path -> the host library built from it
REF_PNG = None  # --ref png=PATH: (PATH, an earlier commit's utils/png.py loaded as a module)


def load_ref_imgdec(path):
    """Build ``path``, a copy of ``csrc/imgdec.c`` (an earlier commit's), as
    ``native.py`` builds the host library, into ``build/`` -> the loaded
    library, with the same C interface."""
    import hashlib

    from topo4d_tpu_torch import native

    spec = native.LIBRARIES["imgdec"]
    src = os.path.abspath(path)
    with open(src, "rb") as fh:
        text = fh.read()
    out = native.BUILD_DIR / f"ref_imgdec-{hashlib.sha256(text + ' '.join(spec.flags).encode()).hexdigest()[:12]}.so"
    native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([native._compiler(spec), *spec.flags, "-o", str(out), src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"--ref imgdec={path}: build failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    for symbol, (argtypes, restype) in spec.functions.items():
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = restype
    lib.imgdec_init()
    return lib


def load_ref_png(path):
    """``path``, an earlier commit's ``utils/png.py``, loaded as a module of
    its own (it imports this package's ``native``, and so decodes over
    whichever host library ``native.library`` gives)."""
    import hashlib
    import importlib.util

    with open(path, "rb") as fh:
        name = "ref_png_" + hashlib.sha256(fh.read()).hexdigest()[:12]
    spec = importlib.util.spec_from_file_location(name, os.path.abspath(path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def decoders_against_ref(path, lib):
    """The existing paths against an earlier commit's host library: the
    dense baseline and progressive JPEG fixtures and two 8-bit PNGs of the
    baseline's pixels (every row Sub, every row Paeth) decoded by this
    commit's Python over this library and over ``lib`` (the PNGs by the
    ``--ref png=PATH`` module's ``decode_png`` over ``lib``, if one was
    given: that commit's whole PNG reader), in turns (ref, new, new,
    ref) x KINDS_TURNS, the bits equal -> {input: {"new": s, "ref": s}}."""
    from unittest import mock

    from topo4d_tpu_torch import fixtures, native
    from topo4d_tpu_torch.utils.jpeg import decode_jpeg
    from topo4d_tpu_torch.utils.png import decode_png

    with open(fixtures.path(fixtures.DENSE), "rb") as fh:
        jpg = fh.read()
    with open(fixtures.path(fixtures.DENSE_PROGRESSIVE), "rb") as fh:
        progressive = fh.read()
    img = decode_jpeg(jpg)
    ref_png = REF_PNG[1].decode_png if REF_PNG else decode_png
    inputs = {"baseline JPEG": (decode_jpeg, decode_jpeg, jpg),
              "progressive JPEG": (decode_jpeg, decode_jpeg, progressive),
              "PNG, Sub rows": (decode_png, ref_png, filtered_png(img, 1)),
              "PNG, Paeth rows": (decode_png, ref_png, filtered_png(img, 4))}
    out = {}
    for label, (decode, ref_decode, data) in inputs.items():
        times, got = {"new": [], "ref": []}, {}
        for _ in range(KINDS_TURNS):
            for which in ("ref", "new", "new", "ref"):
                patch = mock.patch.object(native, "library", lambda name="imgdec": lib)
                with patch if which == "ref" else contextlib.nullcontext():
                    t0 = time.perf_counter()
                    px = (ref_decode if which == "ref" else decode)(data)
                    times[which].append(time.perf_counter() - t0)
                got[which] = px
        if not np.array_equal(got["new"], got["ref"]):
            raise AssertionError(f"phase 13b: {label} decodes to other bits than with --ref imgdec={path}")
        out[label] = {k: float(np.mean(v)) for k, v in times.items()}
    log(f"phase 13b: decodes of a 4096x3000 view against --ref imgdec={path}"
        + (f" (PNG: --ref png={REF_PNG[0]})" if REF_PNG else "")
        + f", in turns x {KINDS_TURNS}, bits equal: "
        + "; ".join(f"{k} {v['new']:.4f} s against {v['ref']:.4f} s ({v['new'] / v['ref'] - 1:+.1%})"
                    for k, v in out.items()))
    return out


def hold_damaged():
    """Phase 13d: every damaged copy of the fixtures (``fixtures.DAMAGED``:
    JPEG cut off, cut off and closed by EOI, a restart marker deleted; PNG
    cut inside IEND, bad CRCs, inflated streams of other lengths, IDAT
    chunks split), written under ``KINDS_DIR`` and read by ``read_image``,
    against PIL's outcome in the manifest: the shape and SHA-256 of the
    decode, or a ``ValueError`` naming the file -> {"reads": n, "raises": n,
    "s": seconds}."""
    from topo4d_tpu_torch import fixtures
    from topo4d_tpu_torch.pipeline.data import read_image

    manifest = fixtures.manifest()
    ddir = os.path.join(KINDS_DIR, "damaged")
    os.makedirs(ddir, exist_ok=True)
    out = {"reads": 0, "raises": 0}
    t0 = time.perf_counter()
    for name, cases in fixtures.DAMAGED.items():
        stem, ext = os.path.splitext(name)
        for case in cases:
            want = manifest[name]["damaged"][case]
            path = os.path.join(ddir, f"{stem}.{case}{ext}")
            with open(path, "wb") as fh:
                fh.write(fixtures.damaged(name, case))
            if want == "raises":
                try:
                    read_image(path)
                except ValueError as e:
                    err = str(e)
                else:
                    raise AssertionError(f"phase 13d: {name}, {case}: read, where PIL raises")
                if not err.startswith(path + ": "):
                    raise AssertionError(f"phase 13d: {name}, {case}: the error does not name the file: {err}")
                out["raises"] += 1
            else:
                px = read_image(path)
                if fixtures.damaged_outcome(px) != want:
                    raise AssertionError(f"phase 13d: {name}, {case}: the decode {px.shape} is not PIL's ({want})")
                out["reads"] += 1
            os.remove(path)
    out["s"] = time.perf_counter() - t0
    log(f"phase 13d: {out['reads'] + out['raises']} damaged copies of {len(fixtures.DAMAGED)} fixtures held to PIL's "
        f"outcomes (manifest): {out['reads']} decoded to PIL's SHA-256, {out['raises']} refused with the file named, "
        f"{out['s']:.2f} s")
    return out


def surface_card_vs_cpu(statics, params_np, cams):
    """Phase 13c: the public functions the port added last, on the card
    against the CPU at the head fixture's size (8,280 Gaussians, the
    24-view ring at 375x512) -> {name: max |err|}. Values rtol 1e-5, atol
    1e-6 (sums rtol 1e-4); gradients rtol 1e-4, atol 1e-6 of their largest;
    binnings and constraint writes bit for bit."""
    from topo4d_tpu_torch.core import camera as C
    from topo4d_tpu_torch.core import gaussian as G
    from topo4d_tpu_torch.core import quaternion as Q
    from topo4d_tpu_torch.losses import flatten as F
    from topo4d_tpu_torch.losses import image as I
    from topo4d_tpu_torch.losses.neighbors import gather_neighbors
    from topo4d_tpu_torch.opt.constraints import apply_constraints, constant_constraint
    from topo4d_tpu_torch.pipeline.scene import build_constraints, cache_first_frame_attrs
    from topo4d_tpu_torch.rasterizer import tiles as T
    from topo4d_tpu_torch.topology.adjacency import inverse_slots

    rng = np.random.default_rng(SEED + 13)
    errs = {}
    devs = (DEVICE, "cpu")

    def on(x, dev, grad=False):
        return torch.tensor(np.asarray(x), device=dev, requires_grad=grad)

    def value(name, fn, *args, rtol=1e-5, atol=1e-6):
        card, cpu = (fn(*[on(a, d) for a in args]) for d in devs)
        errs[name] = held(name, card, cpu, rtol, atol, "13c")

    def value_grad(name, fn, x):
        outs = []
        for d in devs:
            xt = on(x, d, grad=True)
            v = fn(xt)
            v.backward()
            outs.append((v.detach(), xt.grad))
        (vc, gc), (vh, gh) = outs
        errs[name] = held(name, vc, vh, 1e-4, 1e-6, "13c")
        errs[name + " grad"] = held(name + " grad", gc, gh, 1e-4, 1e-6 * float(gh.abs().max()), "13c")

    a, b = rng.uniform(0, 1, (2, 3, 512, 375)).astype(np.float32)
    w3, w2 = rng.uniform(0, 1, (3, 512, 375)).astype(np.float32), rng.uniform(0, 1, (3, 512)).astype(np.float32)
    value("l2_loss", I.l2_loss, a, b, rtol=1e-4)
    value("weighted_l2_loss_v1", I.weighted_l2_loss_v1, a, b, w3, rtol=1e-4)
    value("weighted_l2_loss_v2", I.weighted_l2_loss_v2, a, b, w2, rtol=1e-4)

    verts = (params_np["means3D"] + rng.normal(0, 2e-3, params_np["means3D"].shape)).astype(np.float32)
    quads, umbrella = statics.quadruples["flat"], statics.umbrellas["flat_eye"]
    cos0 = F.dihedral_cos(on(params_np["means3D"], "cpu"), quads).numpy()
    value_grad("flatten_loss", lambda v: F.flatten_loss(v, quads), verts)
    value_grad("soft_flatten_loss", lambda v: F.soft_flatten_loss(v, quads, torch.as_tensor(cos0, device=v.device))[0],
               verts)
    value_grad("umbrella_flatten_loss", lambda v: F.umbrella_flatten_loss(v, umbrella), verts)
    idx = statics.ring.indices.astype(np.int64)
    inv = inverse_slots(idx).astype(np.int64)
    cot = rng.normal(size=idx.shape + (3,)).astype(np.float32)
    value_grad("gather_neighbors", lambda v: (gather_neighbors(v, torch.as_tensor(idx, device=v.device),
                                                               torch.as_tensor(inv, device=v.device))
                                              * torch.as_tensor(cot, device=v.device)).sum(), verts)

    q1, q2 = rng.normal(size=(2, verts.shape[0], 4)).astype(np.float32)
    u1, u2 = (q / np.linalg.norm(q, axis=-1, keepdims=True) for q in (q1, q2))
    value("quat_mult", Q.quat_mult, q1, q2)
    value("quat_conjugate", Q.quat_conjugate, q1)
    value("normal_to_quat", Q.normal_to_quat, rng.normal(size=(verts.shape[0], 3)).astype(np.float32))
    value("quaternion_similarity", Q.quaternion_similarity, u1, u2, rtol=1e-4, atol=1e-3)
    value("build_cov3d", G.build_cov3d, q1, np.exp(params_np["log_scales"]))
    cpu_cams = camera_to(cams, "cpu")
    errs["cam_center"] = held("cam_center", cams.cam_center, cpu_cams.cam_center, 1e-5, 1e-6, "13c")
    for name, fn in (("world_to_view", C.world_to_view), ("project_points", C.project_points)):
        card, cpu = fn(cams, on(verts, DEVICE)), fn(cpu_cams, on(verts, "cpu"))
        for i, (x, y) in enumerate(zip(card if isinstance(card, tuple) else (card,),
                                       cpu if isinstance(cpu, tuple) else (cpu,))):
            errs[f"{name} {i}"] = held(f"{name} {i}", x, y, 1e-5, 1e-3 if name == "project_points" else 1e-6, "13c")

    # binnings: one view's projection made on the CPU, binned on both
    prv = G.activate_params({k: on(v, "cpu") for k, v in params_np.items() if k not in ("cam_m", "cam_c")})
    proj = G.project_gaussians(prv, cpu_cams[0])
    for name, fn in (("bin_gaussians", lambda p, c, o: T.bin_gaussians(p, cams.width, cams.height)),
                     ("bin_gaussians_packed", lambda p, c, o: T.bin_gaussians_packed(p, c, o, cams.width, cams.height))):
        card = fn(to_device(proj, DEVICE), prv.colors.to(DEVICE), prv.opacities.to(DEVICE))
        cpu = fn(proj, prv.colors, prv.opacities)
        for f, x, y in zip(card._fields, card, cpu):
            if not torch.equal(x.cpu(), y):
                raise AssertionError(f"phase 13c: {name}'s {f} on the card differs from the CPU's")
        errs[name] = 0.0

    # the constraint forms: the merged and the sequential scatters and a
    # constant write, applied on both, bit for bit
    ffa = cache_first_frame_attrs(params_np, statics.regions)
    start = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params_np.items()}
    for merge in (True, False):
        outs = []
        for d in devs:
            cons = build_constraints("track", params_np, statics.regions, ffa, d, merge=merge, dense=False)
            cons.append(constant_constraint("log_scales", np.arange(0, verts.shape[0], 7), -3.0,
                                            on(params_np["log_scales"], d)))
            outs.append(apply_constraints({k: on(v, d) for k, v in start.items()}, cons))
        for k in start:
            if not torch.equal(outs[0][k].cpu(), outs[1][k]):
                raise AssertionError(f"phase 13c: build_constraints(merge={merge}, dense=False) writes {k} otherwise "
                                     "on the card")
        errs[f"build_constraints merge={merge}"] = 0.0
    log(f"phase 13c: the added functions on the card against the CPU at {verts.shape[0]} Gaussians, max|err| "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    return errs


def phase_kinds(calib, statics, params_np, cams):
    """Phase 13: the image kinds the loader reads beyond phase 9's and the
    functions the port added last. 13a: the new fixtures (progressive,
    Adobe-marked, 4:4:0 and 4:1:1 JPEG; arithmetic-coded JPEG, unsent bits
    smoothed; an Adam7 16-bit PNG, an 8-bit PNG) decoded here against the manifest's
    SHA-256 of PIL's decodes. 13b: a 24-view dense tree of the progressive
    4096x3000 fixture (phase 9's ``cameras.xml``), read through
    ``DiskSequence`` and turned on the card, each view bit for bit against
    the fixture's decode turned on the host; its dense frame read on
    ``LOAD_THREADS`` threads and its single-thread decode timed in turns
    with a tree of the baseline fixture; with ``--ref imgdec=PATH`` the
    baseline and progressive JPEG and 8-bit PNG decodes against that
    library (and ``--ref png=PATH``'s PNG reader). 13c:
    ``surface_card_vs_cpu``. 13d: ``hold_damaged``."""
    from topo4d_tpu_torch import fixtures
    from topo4d_tpu_torch.pipeline.data import LOAD_THREADS
    from topo4d_tpu_torch.utils.jpeg import read_jpeg

    t_phase = time.perf_counter()
    shutil.rmtree(KINDS_DIR, ignore_errors=True)
    out = {"fixtures": hold_fixtures(fixtures.KINDS, "phase 13a: the other image kinds")}
    out["damaged"] = hold_damaged()
    srcs, paths = {}, {"baseline": fixtures.DENSE, "progressive": fixtures.DENSE_PROGRESSIVE}
    for kind, name in paths.items():
        srcs[kind], pixels = jpeg_tree(os.path.join(KINDS_DIR, kind), calib, name)
    out["frame_s"], out["h2d_s"] = hold_jpeg_read(srcs["progressive"], pixels, "phase 13b: the progressive JPEG tree")
    del pixels
    reads, decodes = {k: [] for k in paths}, {k: [] for k in paths}
    for _ in range(KINDS_TURNS):
        for kind in ("baseline", "progressive", "progressive", "baseline"):
            t0 = time.perf_counter()
            srcs[kind].frame(1, full_res=True)
            reads[kind].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            read_jpeg(fixtures.path(paths[kind]))
            decodes[kind].append(time.perf_counter() - t0)
    mpx = 4096 * 3000 / 1e6
    out["read_s"] = {k: float(np.mean(v)) for k, v in reads.items()}
    out["decode_s_per_mpx"] = {k: float(np.mean(v)) / mpx for k, v in decodes.items()}
    log(f"phase 13b: in turns (baseline, progressive, progressive, baseline) x {KINDS_TURNS}: a dense frame of "
        f"{len(calib[1])} views read on {LOAD_THREADS} threads, s " + ", ".join(
            f"{k} {out['read_s'][k]:.3f} ({', '.join(f'{x:.3f}' for x in reads[k])})" for k in paths)
        + f", progressive / baseline {out['read_s']['progressive'] / out['read_s']['baseline']:.3f}; one 4096x3000 "
        "view decoded on one thread, s per Mpx " + ", ".join(
            f"{k} {out['decode_s_per_mpx'][k]:.5f} ({', '.join(f'{x:.4f}' for x in decodes[k])} s)" for k in paths)
        + f", progressive / baseline {out['decode_s_per_mpx']['progressive'] / out['decode_s_per_mpx']['baseline']:.3f}")
    out["ref"] = {path: decoders_against_ref(path, lib) for path, lib in REF_IMGDEC.items()}
    srcs.clear()
    shutil.rmtree(KINDS_DIR, ignore_errors=True)
    out["functions"] = surface_card_vs_cpu(statics, params_np, cams)
    log(f"phase 13 (image kinds, the added functions): {time.perf_counter() - t_phase:.1f} s")
    return out


VALIDATE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_validate")
VALIDATE_VIEWS = 24  # phase 14's dataset: the protocols' rig, grid and working views
VALIDATE_GRID = (92, 90)
VALIDATE_SIZE = (375, 512)
VALIDATE_FRAMES = 2  # frames of phase 14's dataset and fits (the protocols run 3, 21 and 800)
# cut from the protocols' 7,000 and 1,100 steps; a tracked frame's last 100 are polish steps (means3D frozen)
VALIDATE_SCHEDULE = ("-ion", "300", "-on", "150", "-lf", "50")
VALIDATE_MOTION = 0.004  # the protocols' per-frame motion amplitude


def phase_validate(face_png):
    """Phase 14: the validation protocols (``topo4d_tpu_torch/validate``) at
    full width and cut depth. a: ``fabricate`` on the card (24 views at
    375x512, the head grid, ratio 2, ``VALIDATE_FRAMES`` frames), frame 2
    read back by ``DiskSequence`` equal bit for bit to a fresh render on
    the card; b: ``headline.main``'s three modes through ``cli.main``
    (``VALIDATE_SCHEDULE`` appended), each fit's launches and the common
    metric's read around it (K1/K2 per view-step and K5 twice, no plain
    version; the scoring K1 and K5 once per view and frame); c: the
    common metric of one frame on the card against its CPU run (rtol
    1e-4); d: ``long_run.verify_run`` on headline's and batched0's outputs
    and their drift; e: tex8k's reader and ``seam_check`` on phase 4's
    8192x8192 ``face.png``. The protocols' criteria are logged (at this
    depth they are no verdict); a fault in a path or a launch count
    raises."""
    from topo4d_tpu_torch.pipeline.data import SyntheticSequence, read_image
    from topo4d_tpu_torch.testing import grid_scene, make_grid_mesh
    from topo4d_tpu_torch.validate import fabricate, headline, long_run, score, tex8k

    t_phase = time.perf_counter()
    shutil.rmtree(VALIDATE_DIR, ignore_errors=True)
    root, out = os.path.join(VALIDATE_DIR, "fab"), os.path.join(VALIDATE_DIR, "headline")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fabricate.fabricate(root, VALIDATE_VIEWS, VALIDATE_FRAMES, *VALIDATE_GRID, *VALIDATE_SIZE, 2, VALIDATE_MOTION,
                        dense_tree=False, device=DEVICE)
    fab_s = time.perf_counter() - t0
    src = score.open_source(root, 2, DEVICE)
    verts, _ = make_grid_mesh(*VALIDATE_GRID, extent=0.5)
    scene = grid_scene(verts, *VALIDATE_GRID)
    wobble = SyntheticSequence(params=scene, cameras=src.cameras, num_frames=VALIDATE_FRAMES,
                               motion_scale=VALIDATE_MOTION)
    want = fabricate.render_frame(scene, wobble.vertices_at(2).astype(np.float32), src.cameras)
    if not np.array_equal(np.stack(src.frame(2).images.pixels), want):
        raise AssertionError("phase 14a: the fabricated frame 2 differs from its render on the card")
    log(f"phase 14a: the fabricator on the card, {VALIDATE_VIEWS} views x {VALIDATE_FRAMES} frames at "
        f"{VALIDATE_SIZE[0]}x{VALIDATE_SIZE[1]} ({verts.shape[0]} Gaussians, motion {VALIDATE_MOTION}) in {fab_s:.3f} "
        "s; frame 2 read back equal to a fresh render, bit for bit")

    counts, walls = {}, {}
    run_mode, score_params = headline.run_mode, score.score_params

    def counted_fit(name, *args, **kwargs):
        torch.cuda.synchronize()
        reset_counts()
        r = run_mode(name, *args, **kwargs)
        torch.cuda.synchronize()
        counts[f"phase 14 {name} fit"] = read_counts()
        return r

    def counted_score(*args, **kwargs):  # headline.main scores score.MODES in order
        part = f"phase 14 scoring {score.MODES[len(walls)]}"
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        r = score_params(*args, **kwargs)
        torch.cuda.synchronize()
        walls[part] = time.perf_counter() - t0
        counts[part] = read_counts()
        return r

    headline.run_mode, score.score_params = counted_fit, counted_score
    try:
        report = headline.main(root, out, VALIDATE_FRAMES, DEVICE, VALIDATE_SCHEDULE)
    finally:
        headline.run_mode, score.score_params = run_mode, score_params
    ion, on = int(VALIDATE_SCHEDULE[1]), int(VALIDATE_SCHEDULE[3])
    for name, spec in headline.MODES.items():
        if spec["views_per_step"] == 1:
            renders = ion + (VALIDATE_FRAMES - 1) * on
        else:
            v = VALIDATE_VIEWS
            renders = v * (-(-ion // v) + (VALIDATE_FRAMES - 1) * -(-on // v))
        check_counts(counts[f"phase 14 {name} fit"], f"phase 14b {name} fit", {
            "tile_blend_fwd": renders, "tile_blend_bwd": renders, "gauss_blur": 2 * renders,
            "tile_blend_v3_fwd": 0, "tile_blend_v3_bwd": 0, "tile_blend_plain": 0, "gauss_blur_plain": 0,
            "uv_bake": 0, "uv_bake_plain": 0,
        })
    for part, c in counts.items():
        if part.startswith("phase 14 scoring"):
            check_counts(c, f"phase 14b {part}", {
                "tile_blend_fwd": VALIDATE_VIEWS * VALIDATE_FRAMES, "tile_blend_bwd": 0,
                "gauss_blur": VALIDATE_VIEWS * VALIDATE_FRAMES,
                "tile_blend_plain": 0, "gauss_blur_plain": 0,
            })
    common = report["common_metric"]
    for name, rows in common.items():
        for t, r in rows.items():
            if not (np.isfinite(r["photometric_mean"]) and np.isfinite(r["psnr_mean"])):
                raise AssertionError(f"phase 14b: {name} frame {t} scored {r}")
    log("phase 14b: the headline protocol (" + " ".join(VALIDATE_SCHEDULE) + f" over {VALIDATE_FRAMES} frames): "
        + "; ".join(
            f"{name} {report['wall_s'][name]:.3f} s, final loss_total "
            + ", ".join(f"{v:.5f}" for v in report["modes"][name]["final_loss_per_frame"].values())
            + ", photometric " + ", ".join(f"{r['photometric_mean']:.5f}" for r in common[name].values())
            + ", psnr " + ", ".join(f"{r['psnr_mean']:.3f}" for r in common[name].values())
            for name in headline.MODES)
        + f"; headline <= 1.2x parity {report['headline_within_1p2x_parity']}; headline / parity photometric "
        + ", ".join(f"{v:.4f}" for v in report["headline_over_parity_photometric"].values())
        + "; frozen-binning drift " + ", ".join(f"{v:.3e}" for v in report["frozen_binning_means_drift"].values())
        + f"; scoring {', '.join(f'{v:.3f}' for v in walls.values())} s; launches per part "
        + "; ".join(f"{part.removeprefix('phase 14 ')} {c}" for part, c in counts.items()))

    t0 = time.perf_counter()
    cpu = score.score_params(score.open_source(root, 2, "cpu"), score.run_params(out, "headline"), 1)[0]
    card = common["headline"][0]
    for k in ("photometric_mean", "psnr_mean"):
        if not np.isclose(card[k], cpu[k], rtol=1e-4, atol=0.0):
            raise AssertionError(f"phase 14c: {k} on the card {card[k]} against the CPU's {cpu[k]}")
    log(f"phase 14c: headline's frame 0 scored on the card against the CPU ({time.perf_counter() - t0:.3f} s): "
        f"photometric rel err {abs(card['photometric_mean'] / cpu['photometric_mean'] - 1):.2e}, psnr rel err "
        f"{abs(card['psnr_mean'] / cpu['psnr_mean'] - 1):.2e} (rtol 1e-4)")

    seqs = {name: os.path.join(out, name, "val", "seq01") for name in long_run.MODES}
    verified = {name: long_run.verify_run(name, seq, VALIDATE_FRAMES, VALIDATE_MOTION) for name, seq in seqs.items()}
    drift, _ = long_run.drift_report(seqs, VALIDATE_FRAMES, VALIDATE_FRAMES, VALIDATE_MOTION)
    for name, v in verified.items():
        if not all(np.isfinite(x) for x in v["max_dmeans3d"].values()) or not v["topology_byte_stable"]:
            raise AssertionError(f"phase 14d: {name} {v}")
    log("phase 14d: verify_run on the headline protocol's outputs (" + "; ".join(
        f"{name}: max_dmeans3d max {v['max_dmeans3d']['max']:.3e}, topology byte-stable "
        f"{v['topology_byte_stable']}, failed checks {v['failed_checks']}" for name, v in verified.items())
        + f"); exported-vertex drift headline against batched0: max {drift['per_frame_max']:.3e}, p99 "
        f"{drift['p99_max']:.3e}, failed bounds {drift.get('failed', [])}")

    t0 = time.perf_counter()
    tex = read_image(face_png)
    read_s = time.perf_counter() - t0
    if tex.shape != (TEX_RES, TEX_RES, 3):
        raise AssertionError(f"phase 14e: {face_png} read as {tex.shape}")
    t0 = time.perf_counter()
    coverage, cstd = tex8k.texture_stats(tex)
    seam = tex8k.seam_check(tex)
    if not (0.0 < coverage <= 1.0 and np.isfinite(cstd)):
        raise AssertionError(f"phase 14e: coverage {coverage}, covered std {cstd}")
    log(f"phase 14e: tex8k's reader on phase 4's {TEX_RES}x{TEX_RES} face.png: read in {read_s:.3f} s, coverage "
        f"{coverage:.4f}, covered std {cstd:.3f}, seam_check (grid UVs, no seam: the lines sample one island) {seam} "
        f"in {time.perf_counter() - t0:.3f} s")
    del tex
    shutil.rmtree(VALIDATE_DIR, ignore_errors=True)
    log(f"phase 14 (the validation protocols): {time.perf_counter() - t_phase:.1f} s")
    return {"counts": counts, "report": report}


def main() -> int:
    global CARD, LOG_FILE, REF_PNG, SEED
    import argparse

    parser = argparse.ArgumentParser(description="On-card smoke run of topo4d_tpu_torch.")
    parser.add_argument("--ref", metavar="NAME=PATH", nargs="+", default=[],
                        help="sources of kernel NAME (tile_blend_fwd, tile_blend_v3_fwd or uv_bake: an earlier "
                        "commit's file, or a variant) to time beside the kernel in phase 6, each alone, in turns; "
                        "imgdec=PATH: an earlier commit's csrc/imgdec.c, timed beside the host library in phase 13b; "
                        "png=PATH: an earlier commit's topo4d_tpu_torch/utils/png.py, whose PNG reader phase 13b "
                        "times over the imgdec refs")
    parser.add_argument("--log", metavar="PATH", default=None,
                        help="also append every log line to the file PATH")
    parser.add_argument("--seed", type=int, default=SEED,
                        help="the seed of phase 12's synthetic morphable model and its coefficients")
    args = parser.parse_args()
    SEED = args.seed
    if args.log:
        os.makedirs(os.path.dirname(os.path.abspath(args.log)), exist_ok=True)
        open(args.log, "w").close()
        LOG_FILE = args.log
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from topo4d_tpu_torch import kernels, native  # the package import turns TF32 off

    t_start = time.perf_counter()
    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(CARD, flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    log(f"kernels built in {kernels.build_all(verbose=True):.2f} s")
    t0 = time.perf_counter()
    log(f"host libraries {native.library()._name} (C: PNG unfilter, JPEG decoder) and "
        f"{native.library('scanline')._name} (C++: the scanline renderer) built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    for spec in args.ref:
        symbol, _, path = spec.partition("=")
        if symbol == "imgdec":
            REF_IMGDEC[path] = load_ref_imgdec(path)
        elif symbol == "png":
            REF_PNG = (path, load_ref_png(path))
        else:
            REFS.setdefault(symbol, {})[path] = load_ref(symbol, path)
    cfg, src, trainer, scene = build_main_path()
    errs = phase_kernels()
    errs["bake"], bake_inputs = phase_bake(trainer.statics)
    t0 = time.perf_counter()
    # the run's frame t reads the source's frame t + 1; rendered here, so the
    # run's read-ahead finds them and launches nothing
    frames = {t: (src.frame(t), src.frame(t, full_res=True)) for t in range(1, FRAMES + 1)}
    torch.cuda.synchronize()
    log(f"targets: {FRAMES} frames x 24 views at 375x512 and at {FULL_W}x{FULL_H} ({time.perf_counter() - t0:.2f} s)")

    run = phase_run(cfg, src, trainer, scene)
    tm = run["timings"]
    log(
        f"ms per geometry step {run['geo_ms_per_step']:.3f}; s per tracked frame ({cfg.schedule.opt_num} steps) "
        f"{run['tracked_frame_s']:.3f}; s per dense frame ({cfg.schedule.dense_opt_num} steps) "
        + ", ".join(f"{s:.3f}" for s in run["dense_frame_s"])
        + f"; export s per frame {tm['export']['mean_seconds']:.3f} (frame 0's with the binning), checkpoint s per "
        f"frame {tm['checkpoint']['mean_seconds']:.3f}; s per frame through run {run['wall'] / FRAMES:.3f}"
    )
    last_geo, last_tex = frames[FRAMES]
    phase_card_vs_cpu(cfg, trainer, last_geo)
    phase_texture_card_vs_cpu(cfg, trainer, scene)
    geo_timing = phase_timing(trainer)
    blend4k, blur = phase_texture_timing(trainer, errs)
    bake = phase_bake_timing(trainer, bake_inputs)
    phase_profile(trainer, last_geo)
    dense = phase_profile_dense(trainer, last_tex)
    v3 = phase_v3(trainer, frames)
    batched = phase_batched(cfg, src, trainer, scene, frames)
    fused = phase_fused(cfg, src, trainer, scene, frames, batched)
    cli = phase_cli(run)
    multi = phase_multi(cfg, src, frames, batched, bake_inputs)
    modes = phase_modes(cfg, src, trainer, scene, frames)
    face3d = phase_face3d(trainer.statics, bake_inputs)
    kinds = phase_kinds(cli["jpeg"]["calib"], trainer.statics, scene[3], src.cameras)
    validate = phase_validate(os.path.join(OUT_DIR, cfg.data.exp, cfg.data.seq, "%06d" % FRAMES, "face.png"))
    log(
        f"summary: ms per dense step {dense['compact'][0]:.3f} (ten steps, unprofiled; card busy "
        f"{dense['compact'][1]:.3f}), full canvas {dense['full canvas'][0]:.3f} (busy {dense['full canvas'][1]:.3f}); "
        f"final tex_psnr_fixed {run['psnr_fixed']:.3f}; batched mode: s per tracked frame "
        f"{batched['tracked_frame_s']:.3f} ({batched['parts'][-1]['steps']} batched steps), ms per batched step "
        f"{batched['ms_per_step']:.3f}, busy {batched['profile'][1]:.3f} ms per step in a frozen-binning segment "
        f"({100 * batched['profile'][1] / batched['profile'][0]:.1f}% busy), psnr {batched['psnr']:.3f}; fused "
        f"batched mode: s per tracked frame {fused['tracked_frame_s']:.3f}, ms per batched step "
        f"{fused['ms_per_step']:.3f}, in turns with sequential steps {fused['turns_ms']['fused']:.3f} against "
        f"{fused['turns_ms']['sequential']:.3f}, busy {fused['profile'][1]:.3f} ms per step "
        f"({100 * fused['profile'][1] / fused['profile'][0]:.1f}% busy), psnr {fused['psnr']:.3f}; JPEG tree: dense "
        f"frame {cli['jpeg']['frame_s']:.3f} s, on the card {cli['jpeg']['h2d_s']:.3f} s; dense modes, ms per step: "
        + ", ".join(f"{m} {v:.3f}" for m, v in modes["modes_ms"].items())
        + f"; remat off / on {modes['remat']['off']['ms']:.3f} / {modes['remat']['on']['ms']:.3f} ms per step; "
        f"phase 12: xla bake {face3d['bake']['xla_ms']:.3f} ms against K6's {face3d['bake']['k6_ms']:.4f} ms, "
        f"{face3d['bake']['differ']} pixels apart; phase 13: progressive dense frame {kinds['read_s']['progressive']:.3f} "
        f"s against baseline {kinds['read_s']['baseline']:.3f} s, decode {kinds['decode_s_per_mpx']['progressive']:.5f} "
        f"against {kinds['decode_s_per_mpx']['baseline']:.5f} s per Mpx; phase 14: headline / parity photometric "
        + ", ".join(f"{v:.4f}" for v in validate["report"]["headline_over_parity_photometric"].values())
        + "; peak device memory from phase 12c's bake on "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; total {time.perf_counter() - t_start:.1f} s"
    )
    shutil.rmtree(OUT_DIR, ignore_errors=True)

    print(json.dumps({"kernels": kernel_rows(run, batched, fused, v3, cli, multi, modes, validate, errs, geo_timing,
                                             blend4k, blur, bake)}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
