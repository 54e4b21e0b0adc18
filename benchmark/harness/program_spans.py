"""The port's own spans and counters in the traced window: what the readers
that split the window's device time by the program's phases read.

The port opens its spans (``topo4d.<name>``, ``topo4d_tpu_torch.utils.profiling``)
while a profiler records. ``Trace`` keeps the benchmark's spans alone, so
the span ``profiler`` (``benchmark/spans/profiler.json``, around
``torch.profiler.profile.__enter__``) keeps the window's profiler, and this
module reads its events once more:

- a device activity (kernel, copy, set) of the window belongs to the
  innermost program span whose host interval holds the call that launched
  it, on the launching thread; a launch on a thread with no program span
  open there (autograd's device thread, which runs the backward's nodes)
  belongs to the innermost program span of the window's thread at the
  launch time;
- the activities are those of ``Trace.ops``, in its order (the same events
  under the same filter), so each also has its benchmark span.

Against a program without spans, or a window without device activity (the
CPU), ``program_trace`` gives None and each reader of it reports nothing.
``program_counters`` reads the port's counters, which count only while a
profiler records: in a run of the benchmark, the traced window alone.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional

from benchmark.harness import trace as tr

PREFIX = "topo4d."
PROFILER_SPAN = "profiler"  # benchmark/spans/profiler.json


@dataclasses.dataclass
class ProgramTrace:
    program: List[Optional[str]]  # each of Trace.ops' innermost program span (None: no span open)

    def self_ns(self, trace, *names: str) -> int:
        """Device ns of the activities whose innermost program span is one of ``names``."""
        return sum(op.dur_ns for op, p in zip(trace.ops, self.program) if p in names)


def program_trace(trace) -> Optional[ProgramTrace]:
    """The window's program spans (read once per trace, kept in its context)."""
    if "program_trace" not in trace.context:
        trace.context["program_trace"] = _read(trace)
    return trace.context["program_trace"]


def _profiler(trace):
    calls = [c for c in trace.calls.get(PROFILER_SPAN, []) if c.get("result") is not None]
    return calls[-1]["result"] if calls else None


def _read(trace) -> Optional[ProgramTrace]:
    from torch.autograd import DeviceType

    prof = _profiler(trace)
    if prof is None or not trace.ops:  # no device activity: nothing of the card to split
        return None
    window, spans_by_thread, dev = None, defaultdict(list), []
    runtime_at, op_at = {}, {}  # as read_profile: correlation id -> (host start, thread)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            name, start, thread = e.name(), e.start_ns(), e.start_thread_id()
            if name == tr.WINDOW:
                window = (start, start + e.duration_ns(), thread)
            elif name.startswith(PREFIX):
                spans_by_thread[thread].append((start, start + e.duration_ns(), name[len(PREFIX):]))
            kind = e.activity_type() if hasattr(e, "activity_type") else ""
            runtime = kind in ("cuda_runtime", "cuda_driver") or (not kind and name.startswith("cu"))
            (runtime_at if runtime else op_at)[e.correlation_id()] = (start, thread)
        elif e.device_type() == DeviceType.CUDA and tr._kind(e) in tr.DEVICE_KINDS:
            dev.append(e)
    if window is None or not spans_by_thread:
        return None
    w0, w1, main = window
    launches = []  # (host time, thread) of each activity of the window, or None
    for e in dev:
        if w0 <= e.start_ns() < w1:
            launches.append(runtime_at.get(e.correlation_id()) or op_at.get(e.linked_correlation_id()))
    if len(launches) != len(trace.ops):
        raise RuntimeError(f"{len(launches)} device activities in the window against the trace's {len(trace.ops)}")
    program: List[Optional[str]] = [None] * len(launches)
    queries = defaultdict(list)
    for i, at in enumerate(launches):
        if at is not None:
            queries[at[1]].append((at[0], i))
    fallback = []
    for thread, qs in queries.items():
        for i, name in _innermost(spans_by_thread.get(thread, []), qs).items():
            program[i] = name
            if name is None and thread != main:
                fallback.append((launches[i][0], i))
    for i, name in _innermost(spans_by_thread.get(main, []), fallback).items():
        program[i] = name
    return ProgramTrace(program=program)


def _innermost(spans: List[tuple], queries: List[tuple]) -> Dict[int, Optional[str]]:
    """One thread's nested spans [(start, end, name)] and queries [(time,
    key)] -> {key: the innermost span holding the time, or None}."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))  # an outer span before an inner one of the same start
    out, stack, j = {}, [], 0
    for t, key in sorted(queries):
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[key] = stack[-1][2] if stack else None
    return out


def per_step_ms(trace, *names: str) -> Optional[float]:
    """Device ms per dense step of the activities whose innermost program
    span is one of ``names``; None without program spans."""
    pt = program_trace(trace)
    if pt is None or trace.steps <= 0:
        return None
    return pt.self_ns(trace, *names) / 1e6 / trace.steps


def program_counters() -> Optional[Dict[str, int]]:
    """The port's counters, or None where the port has none."""
    try:
        from topo4d_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    return counters()
