"""Readings that the limits of ``correct`` are set from, for one cell.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... --control-seeds 7,8,9 [--out f.json]

For each of ``--seeds``: the program's check steps against the reference
(the cell's set-up and check, without the window). For each of
``--control-seeds``: the control, the reference computed in bfloat16
(alphas, weights, image, SSIM and loss; positions and conics in float32)
in the program's place, and the fault that leaves half of each view out of
the loss (the mean taken over the rest), each against the float32
reference. Prints one JSON line per seed and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.harness import cell, check, program  # noqa: E402
from benchmark.harness.scene import make_scene  # noqa: E402
from benchmark.harness.targets import render_views  # noqa: E402
from benchmark.reference import step as S  # noqa: E402


def inputs(config, traffic, seed, dev):
    scene = make_scene(config, seed, dev)
    heads = [scene.head(k, traffic["motion"]) for k in range(len(check.CHECK_STEPS))]
    return scene, heads, [render_views(scene, scene.dense_rig, h, dev) for h in heads]


def free(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def program_seed(config, traffic, seed, dev) -> dict:
    scene, heads, targets = inputs(config, traffic, seed, dev)
    trainer = program.build_trainer(scene, config, traffic, dev)
    prog = check.program_readings(trainer, heads, targets, trainer.source.view_names)
    del trainer
    free(dev)
    ref = S.run_reference(scene, config, list(zip(heads, targets)), check.CHECK_STEPS, dev)
    return {"seed": seed, "kind": "program", "numbers": check.compare(prog, ref), "program": prog, "reference": ref}


@contextlib.contextmanager
def half_views():
    """The loss over the top half of each view alone."""
    original = S.dense_loss

    def half(image, target, colors, anchor, weights):
        h = image.shape[1] // 2
        return original(image[:, :h], target[:, :h], colors, anchor, weights)

    S.dense_loss = half
    try:
        yield
    finally:
        S.dense_loss = original


def control_seed(config, traffic, seed, dev) -> list:
    scene, heads, targets = inputs(config, traffic, seed, dev)
    frames = list(zip(heads, targets))
    ref = S.run_reference(scene, config, frames, check.CHECK_STEPS, dev)
    free(dev)
    out = []
    bf16 = S.run_reference(scene, config, frames, check.CHECK_STEPS, dev, value_dtype=torch.bfloat16)
    out.append({"seed": seed, "kind": "control_bf16", "numbers": check.compare(check.as_program(bf16), ref),
                "readings": bf16})
    free(dev)
    with half_views():
        half = S.run_reference(scene, config, frames, check.CHECK_STEPS, dev)
    out.append({"seed": seed, "kind": "fault_half_views", "numbers": check.compare(check.as_program(half), ref),
                "readings": half})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = cell._load(os.path.join(ROOT, "BENCHMARK.json"))
    ns = argparse.Namespace(workload=args.workload)
    config, traffic, *_ = cell.resolve(ns, bench)
    dev = torch.device(args.device)
    rows = []
    for kind, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for s in [int(x) for x in seeds.split(",") if x]:
            t0 = time.perf_counter()
            got = program_seed(config, traffic, s, dev) if kind == "program" else control_seed(config, traffic, s, dev)
            for row in got if isinstance(got, list) else [got]:
                row["seconds"] = time.perf_counter() - t0
                print(json.dumps({"workload": args.workload, "seed": row["seed"], "kind": row["kind"],
                                  **row["numbers"]}), flush=True)
                rows.append(row)
            free(dev)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(rows, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
