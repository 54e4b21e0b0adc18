"""The traced run: the benchmark's spans around the program's entries, the
profiler's record of one window, and what the per-layer readers read.

Spans are data: every ``benchmark/spans/<name>.json`` names a function or
method of the program (``"target": "module:attr"`` or ``"module:Class.attr"``),
which the traced run wraps in ``record_function("bench.<name>")`` and a
host-clock timer. Each
call's record keeps what ``"record"`` asks of its positional arguments
(``"ptr:i"`` a tensor's address, ``"shape:i"`` its shape) and, with
``"keep_result"``, the return value.

The profiler's device activities (kernels, copies, sets) are attributed to
the span inside which the host launched them: the activity's correlation
leads to the host event that launched it, and that event's start lies in
the span's host interval.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import importlib
import importlib.util
import json
import os
import time
from bisect import bisect_right
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


def span_specs(bench_dir: str = BENCH_DIR) -> Dict[str, dict]:
    out = {}
    for path in sorted(glob.glob(os.path.join(bench_dir, "spans", "*.json"))):
        with open(path) as fh:
            out[os.path.basename(path)[: -len(".json")]] = json.load(fh)
    return out


def _resolve(target: str):
    module, attr = target.split(":")
    owner = importlib.import_module(module)
    *parents, leaf = attr.split(".")
    for name in parents:
        owner = getattr(owner, name)
    return owner, leaf


def _recorded(spec: dict, args) -> list:
    out = []
    for item in spec.get("record", []):
        kind, i = item.split(":")
        a = args[int(i)]
        out.append(a.data_ptr() if kind == "ptr" else tuple(a.shape))
    return out


@contextlib.contextmanager
def spans(calls: Dict[str, list], bench_dir: str = BENCH_DIR):
    """Wrap every span's target while the block runs; each call appends
    {"host_s", "args"[, "result"]} to ``calls[name]``."""
    specs = span_specs(bench_dir)
    undo = []
    try:
        for name, spec in specs.items():
            owner, leaf = _resolve(spec["target"])
            original = getattr(owner, leaf)
            calls.setdefault(name, [])
            setattr(owner, leaf, _wrapper(name, spec, original, calls[name]))
            undo.append((owner, leaf, original))
        yield calls
    finally:
        for owner, leaf, original in reversed(undo):
            setattr(owner, leaf, original)


def _wrapper(name: str, spec: dict, original: Callable, log: list) -> Callable:
    label, keep = "bench." + name, spec.get("keep_result", False)

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(label):
            t0 = time.perf_counter()
            out = original(*args, **kwargs)
            rec = {"host_s": time.perf_counter() - t0, "args": _recorded(spec, args)}
        if keep:
            rec["result"] = out
        log.append(rec)
        return out

    wrapped.__wrapped__ = original
    return wrapped


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_ns: int
    dur_ns: int
    kind: str
    span: Optional[str]  # the benchmark span it was launched in, if any


@dataclasses.dataclass
class Trace:
    """Everything a per-layer reader may read of one traced window."""

    window_s: float
    frames: int
    steps: int
    ops: List[DeviceOp]  # the device activities inside the window
    busy_s: float
    calls: Dict[str, list]  # span name -> call records
    peak_bytes: int  # max_memory_allocated over the window
    gaps: List[list]  # [[host activity, idle seconds]]
    context: dict  # the phase's own objects (scene, configuration, heads, device, ...)

    def span_ops(self, *names: str) -> List[DeviceOp]:
        return [op for op in self.ops if op.span in names]


def _kind(e) -> str:
    """A device event's kind: "kernel", "gpu_memcpy", "gpu_memset", or
    another (the profiler's copies of host annotations on the device's
    timeline are no activity of the device)."""
    kind = e.activity_type() if hasattr(e, "activity_type") else ""
    if kind:
        return kind
    name = e.name()
    if name.startswith("bench.") or e.is_user_annotation():
        return "gpu_user_annotation"
    return "gpu_memcpy" if "Memcpy" in name else "gpu_memset" if "Memset" in name else "kernel"


def read_profile(prof, calls: Dict[str, list], peak_bytes: int, frames: int, steps: int, context: dict) -> Trace:
    """The profiler's events -> a ``Trace`` of the ``bench.window`` interval."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    cpu, dev, spans_by_thread = [], [], defaultdict(list)
    runtime_at, op_at = {}, {}  # correlation id -> (host start, thread): launch calls, and ops
    window = None
    for e in events:
        if e.device_type() == DeviceType.CPU:
            name = e.name()
            start, end, thread = e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id()
            if name == WINDOW:
                window = (start, end, thread)
            elif name.startswith("bench."):
                spans_by_thread[thread].append((start, end, name[len("bench."):]))
            kind = e.activity_type() if hasattr(e, "activity_type") else ""
            runtime = kind in ("cuda_runtime", "cuda_driver") or (not kind and name.startswith("cu"))
            (runtime_at if runtime else op_at)[e.correlation_id()] = (start, thread)
            cpu.append((start, end, name, thread))
        elif e.device_type() == DeviceType.CUDA:
            kind = _kind(e)
            if kind in DEVICE_KINDS:
                dev.append((e, kind))
    if window is None:
        raise RuntimeError("the traced window left no bench.window event")
    w0, w1, main = window
    spans_sorted = {t: sorted(v) for t, v in spans_by_thread.items()}
    ops = []
    for e, kind in dev:
        start = e.start_ns()
        if start < w0 or start >= w1:
            continue
        at = runtime_at.get(e.correlation_id()) or op_at.get(e.linked_correlation_id())
        span = None
        if at is not None:
            host_t, thread = at
            lst = spans_sorted.get(thread, [])
            i = bisect_right(lst, (host_t, float("inf"), "")) - 1
            if i >= 0 and lst[i][0] <= host_t <= lst[i][1]:
                span = lst[i][2]
        ops.append(DeviceOp(e.name(), start, e.duration_ns(), kind, span))
    busy, merged = _union([(op.start_ns, min(op.start_ns + op.dur_ns, w1)) for op in ops])
    host = sorted((s, e, n) for s, e, n, t in cpu if t == main and w0 <= s < w1 and n != WINDOW)
    return Trace(window_s=(w1 - w0) / 1e9, frames=frames, steps=steps, ops=ops, busy_s=busy / 1e9, calls=calls,
                 peak_bytes=peak_bytes, gaps=_idle_by_host(merged, host, w0, w1), context=context)


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def _idle_by_host(merged, host, w0: int, w1: int, top: int = 10) -> List[list]:
    """Idle seconds of the window summed by the innermost host activity
    under way at each gap's midpoint -> the ``top`` largest [[name, s]]."""
    gaps, prev = [], w0
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    totals, stack, i = defaultdict(int), [], 0
    for g0, g1 in sorted(gaps, key=lambda g: (g[0] + g[1]) // 2):
        mid = (g0 + g1) // 2
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        totals[stack[-1][2] if stack else "python (no profiled op)"] += g1 - g0
    return [[name, ns / 1e9] for name, ns in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]


def device_ops_breakdown(trace: Trace, top: int = 10) -> List[list]:
    totals = defaultdict(int)
    for op in trace.ops:
        totals[op.name[:120]] += op.dur_ns
    return [[name, ns / 1e9] for name, ns in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]


def metric_reader(name: str, bench_dir: str = BENCH_DIR) -> Callable[[Trace], Optional[float]]:
    """``benchmark/metrics/<name>.py``'s ``read``."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
