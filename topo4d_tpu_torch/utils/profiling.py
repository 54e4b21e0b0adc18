"""Phase timing and the throughput counter (``utils/profiling.py``).

``PhaseTimer`` accumulates wall-clock seconds per named pipeline phase
(geometry, texture, checkpoint, export), written per run as
``timings.json`` beside ``metrics.jsonl``. The trainer's export worker
times its phases on another thread, so updates and reads take a lock.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, Iterator


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


def mpix_per_s(height: int, width: int, iterations: int, seconds: float) -> float:
    """Throughput counter: Mpixels through forward and backward per second."""
    if seconds <= 0:
        return 0.0
    return height * width * iterations / seconds / 1e6
