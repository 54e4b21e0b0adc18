"""One run of one cell: ``python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.

The cell's configuration (``benchmark/configs/<config>.json``) and traffic
mix (``benchmark/traffic/<traffic>.json``) are found by the names in
``BENCHMARK.json``; the mix's ``phase`` names the module of
``benchmark/harness`` that drives the program; with ``--trace 1`` the
cell's per-layer metrics are read by ``benchmark/metrics/<metric>.py``.
``--config`` and ``--traffic`` instead of ``--workload`` run a pair that is
no cell (a probe). The last line of standard output is the result, one
JSON object; the numbers compared for ``correct`` are the last lines of
standard error and the result's last key.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import subprocess
import sys
from typing import List, Optional

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "topo4d_tpu")  # whole top-level module names


@dataclasses.dataclass
class Run:
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float
    per_layer: List[str]
    bench_dir: str = BENCH  # where the configuration, traffic, span and metric files are found


def _load(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def resolve(args, bench: dict, root: str = ROOT):
    """-> (config, traffic, chips, end-to-end metrics, per-layer metrics, name) of the run."""
    bench_dir = os.path.join(root, "benchmark")
    if args.workload:
        cells = {w["name"]: w for w in bench["workloads"]}
        if args.workload not in cells:
            raise SystemExit(f"unknown workload {args.workload!r}; BENCHMARK.json has {sorted(cells)}")
        cell = cells[args.workload]
        conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
        config = _load(os.path.join(root, conf["file"]))
        traffic = _load(os.path.join(bench_dir, "traffic", cell["traffic"] + ".json"))
        e2e = [m for m in bench["end_to_end"] if args.workload in m.get("workloads", [args.workload])]
        reported = {m["name"] for m in e2e}
        per_layer = [m for m in bench["per_layer"]
                     if args.workload in m.get("workloads", [args.workload] if m["moves"] in reported else [])]
        return config, traffic, cell["chips"], e2e, per_layer, args.workload
    config = _load(os.path.join(bench_dir, "configs", args.config + ".json"))
    traffic = _load(os.path.join(bench_dir, "traffic", args.traffic + ".json"))
    return config, traffic, 1, [], [], f"{args.config}.{args.traffic}"


def main(argv, t0: float, device: str = "cuda", root: str = ROOT) -> int:
    """One run; ``device`` "cpu" skips the look for a card (the CPU
    rehearsal), ``root`` is the checkout whose data files are read."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--config")
    ap.add_argument("--traffic")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not args.workload and not (args.config and args.traffic):
        ap.error("give --workload, or --config and --traffic")
    bench = _load(os.path.join(root, "BENCHMARK.json"))
    config, traffic, chips, e2e, per_layer, name = resolve(args, bench, root)
    dev = torch.device(device)
    if dev.type == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        print(f"[benchmark] {name} needs {chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    phase = importlib.import_module(f"benchmark.harness.{traffic['phase']}")
    run = Run(config=config, traffic=traffic, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
              device=dev, t0=t0, per_layer=[m["name"] for m in per_layer], bench_dir=os.path.join(root, "benchmark"))
    res = phase.run(run)

    found = forbidden_modules()
    if found:
        print(f"[benchmark] the run loaded {found}: the benchmark runs the PyTorch port alone", file=sys.stderr)
        return 4
    units = {**res.get("units", {}), **{m["name"]: m["unit"] for m in e2e + per_layer}}
    wanted = [m["name"] for m in (per_layer if args.trace else e2e)] or list(res["metrics"])
    metrics = {k: {"value": res["metrics"][k], "unit": units.get(k, "")}
               for k in wanted if res["metrics"].get(k) is not None}
    limits = config.get("limits", {})
    compared = {k: {"value": v, "limit": limits.get(k)} for k, v in res["compared"].items()}
    correct = None
    if compared:
        correct = res["failed"] == 0 and all(c["limit"] is not None and c["value"] <= c["limit"]
                                             for c in compared.values())
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    device_out = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": card, "count": 1,
                  "memory_peak_bytes": res["memory_peak_bytes"]}
    if res.get("busy"):
        device_out["busy_s"], device_out["window_s"] = res["busy"]
    if dev.type == "cuda":
        device_out["power"] = power_limit()
    out = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"], "metrics": metrics,
           "device": device_out}
    if args.trace and res.get("breakdown"):
        out["breakdown"] = res["breakdown"]
    out["compared"] = compared
    for key in ("stages", "span_device_s", "readings"):  # stages: seconds from the process's start
        if key in res:
            print(f"[benchmark] {key} " + json.dumps(res[key]), file=sys.stderr)
    print(f"[benchmark] {name} seed {args.seed}: correct {correct}; card {device_out.get('power')}", file=sys.stderr)
    for k, c in compared.items():
        print(f"compared {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
