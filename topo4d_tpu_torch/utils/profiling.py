"""Phase timing, the profiler trace, the port's spans and counters, and the
throughput counter (``utils/profiling.py``).

- ``PhaseTimer`` accumulates wall-clock seconds per named pipeline phase
  (geometry, texture, checkpoint, export), written per run as
  ``timings.json`` beside ``metrics.jsonl``. The trainer's export worker
  times its phases on another thread, so updates and reads take a lock.
  Each phase also opens the span ``phase.<name>``.
- ``span`` and ``count``: the port's own spans (``topo4d.<name>`` in the
  profiler's event list, on the clock of the card's activities) and
  counters of host integers. Both are live exactly while a
  ``torch.profiler`` records on the calling thread (``tracing``): the
  main thread and autograd's threads, not a pool's workers. Otherwise a
  span is one shared no-op context and a count does nothing, so an
  untraced run pays one check of the profiler's state per call.
- ``device_trace`` runs ``torch.profiler`` around a block when a log
  directory is given or ``TOPO4D_PROFILE_DIR`` is set, and writes one
  Chrome trace per process (``trace_rank<r>.json``, viewable in Perfetto or
  ``chrome://tracing``) and the block's counters beside it
  (``counters_rank<r>.json``). A trace that was asked for and cannot be
  taken raises; it never goes missing silently.
- ``sync_value`` waits for the card before a host clock is read.
- ``mpix_per_s`` is the trainer's throughput counter.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from typing import Callable, ContextManager, Dict, Iterator, Optional

import torch

SPAN_PREFIX = "topo4d."
_NO_SPAN = contextlib.nullcontext()  # shared by every untraced span: it allocates nothing
_COUNTERS: Dict[str, int] = {}


def tracing() -> bool:
    """Whether a ``torch.profiler`` records on this thread: spans and
    counters are live exactly then."""
    return torch.autograd._profiler_enabled()


def span(name: str) -> ContextManager:
    """``record_function("topo4d.<name>")`` while ``tracing()``, else a
    shared no-op context."""
    if tracing():
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return _NO_SPAN


def traced(name: str) -> Callable:
    """Decorator: each call of the function runs inside ``span(name)``."""

    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def count(name: str, n: int = 1) -> None:
    """Add the host integer ``n`` to counter ``name`` while ``tracing()``
    (never a value read from the card: the caller holds it already)."""
    if tracing():
        _COUNTERS[name] = _COUNTERS.get(name, 0) + int(n)


def counters() -> Dict[str, int]:
    """A copy of the counters since the last ``reset_counters``."""
    return dict(_COUNTERS)


def reset_counters() -> None:
    _COUNTERS.clear()


class PhaseTimer:
    """Accumulates wall-clock seconds per named phase.

    >>> timer = PhaseTimer()
    >>> with timer.phase("geometry"):
    ...     ...
    >>> timer.summary()["geometry"]["seconds"]
    """

    def __init__(self) -> None:
        self._total: Dict[str, float] = {}
        self._count: Dict[str, int] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with span("phase." + name):
                yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float, count: int = 1) -> None:
        with self._lock:
            self._total[name] = self._total.get(name, 0.0) + seconds
            self._count[name] = self._count.get(name, 0) + count

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                name: {
                    "seconds": round(self._total[name], 4),
                    "count": self._count[name],
                    "mean_seconds": round(self._total[name] / max(self._count[name], 1), 4),
                }
                for name in sorted(self._total)
            }

    def write(self, path: str) -> None:
        summary = self.summary()
        with open(path, "w") as fh:
            json.dump(summary, fh, indent=2)

    def load(self, path: str) -> None:
        """Fold an earlier run's timings.json back in (the resume path: the
        trainer rewrites the file whole). A torn file is ignored."""
        if not os.path.exists(path):
            return
        try:
            with open(path) as fh:
                prior = json.load(fh)
        except (json.JSONDecodeError, OSError):
            return
        for name, row in prior.items():
            self.add(name, row["seconds"], row["count"])


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None, device="cuda") -> Iterator[bool]:
    """Trace the block with ``torch.profiler`` when enabled -> whether it traces.

    Enabled by ``logdir`` or, without one, by ``TOPO4D_PROFILE_DIR``;
    otherwise a no-op that yields False. The trace records host (CPU)
    activity, and the card's kernels and copies (CUDA activity, through
    CUPTI) when ``device`` is a CUDA device (a CUDA device without a card
    raises). On exit, the block's exceptions included, it writes
    ``<logdir>/trace_rank<r>.json``, ``r`` this process's rank (0 alone),
    and the counters counted in the block, ``<logdir>/counters_rank<r>.json``.
    """
    logdir = logdir or os.environ.get("TOPO4D_PROFILE_DIR")
    if not logdir:
        yield False
        return
    from torch.profiler import ProfilerActivity, profile

    from topo4d_tpu_torch.device import resolve_device
    from topo4d_tpu_torch.parallel.multihost import process_index

    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    reset_counters()
    prof.start()
    try:
        yield True
    finally:
        prof.stop()
        rank = process_index()
        prof.export_chrome_trace(os.path.join(logdir, f"trace_rank{rank}.json"))
        with open(os.path.join(logdir, f"counters_rank{rank}.json"), "w") as fh:
            json.dump(counters(), fh, indent=2, sort_keys=True)


def sync_value(x):
    """Wait until every card that holds a tensor of ``x`` (a tensor, or a
    dict, list, tuple or NamedTuple of them) has finished its queued work
    -> ``x``: the point before a host clock is read in a timing loop."""
    devices = set()

    def visit(v):
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                devices.add(v.device)
        elif isinstance(v, dict):
            for w in v.values():
                visit(w)
        elif isinstance(v, (list, tuple)):
            for w in v:
                visit(w)

    visit(x)
    for d in devices:
        torch.cuda.synchronize(d)
    return x


def mpix_per_s(height: int, width: int, iterations: int, seconds: float) -> float:
    """Throughput counter: Mpixels through forward and backward per second."""
    if seconds <= 0:
        return 0.0
    return height * width * iterations / seconds / 1e6
