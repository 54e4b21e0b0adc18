"""The readers of the port's own spans and counters
(``benchmark/harness/program_spans.py``): the attribution of each device
activity to the innermost program span, a launch from autograd's thread
included, and, on the card, a traced tiny frame against one with the program's spans patched out."""

from __future__ import annotations

import contextlib
import json
import statistics
import time
import types

import pytest
import torch

from benchmark.harness import cell
from benchmark.harness import program_spans as ps
from benchmark.harness import trace as tr

MAIN, AUTOGRAD = 1, 2


class _Event:
    """What the readers ask of a profiler event."""

    def __init__(self, device, name, start, end, thread=MAIN, corr=0, kind=""):
        self._device, self._name, self._start, self._dur = device, name, start, end - start
        self._thread, self._corr, self._kind = thread, corr, kind

    def device_type(self):
        return self._device

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def start_thread_id(self):
        return self._thread

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._corr

    def activity_type(self):
        return self._kind

    def is_user_annotation(self):
        return False


def _window(with_program_spans: bool = True):
    """A window of two steps: the first's backward runs K2's entry and one
    more kernel on autograd's thread; the second renders; one launch lies
    outside the steps -> (trace, the profiler's stand-in)."""
    from torch.autograd import DeviceType

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [_Event(cpu, tr.WINDOW, 0, 1000)]
    if with_program_spans:
        events += [
            _Event(cpu, "topo4d.dense.step", 100, 500), _Event(cpu, "topo4d.dense.backward", 200, 450),
            _Event(cpu, "topo4d.blend.bwd", 250, 300, thread=AUTOGRAD),
            _Event(cpu, "topo4d.dense.step", 600, 900), _Event(cpu, "topo4d.render.forward", 620, 700),
        ]
    launches = [(AUTOGRAD, 260, 270, 290), (AUTOGRAD, 350, 360, 400), (MAIN, 150, 160, 200),
                (MAIN, 650, 660, 760), (MAIN, 950, 960, 990)]  # (thread, host time, device start, device end)
    for corr, (thread, host, d0, d1) in enumerate(launches, start=1):
        events.append(_Event(cpu, "cudaLaunchKernel", host, host + 5, thread=thread, corr=corr, kind="cuda_runtime"))
        events.append(_Event(cuda, f"kernel{corr}", d0, d1, corr=corr, kind="kernel"))
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=types.SimpleNamespace(
        events=lambda: events)))
    calls = {ps.PROFILER_SPAN: [{"host_s": 0.0, "args": [], "result": prof}]}
    return tr.read_profile(prof, calls, 0, 1, 2, {}), prof


def test_launches_go_to_the_innermost_program_span():
    """A launch on autograd's thread inside its own span goes there; one on
    that thread with no span open goes to the main thread's innermost span
    at its launch time; a launch outside every span has none."""
    trace, _ = _window()
    pt = ps.program_trace(trace)
    assert [op.name for op in trace.ops] == [f"kernel{i}" for i in range(1, 6)]
    assert pt.program == ["blend.bwd", "dense.backward", "dense.step", "render.forward", None]
    assert ps.program_trace(trace) is pt  # read once per trace
    reads = {name: tr.metric_reader(name)(trace) for name in (
        "render_fwd_ms_per_step.dense", "loss_ms_per_step.dense", "backward_ms_per_step.dense",
        "update_ms_per_step.dense")}
    assert reads == {"render_fwd_ms_per_step.dense": 100 / 1e6 / 2, "loss_ms_per_step.dense": 0.0,
                     "backward_ms_per_step.dense": 40 / 1e6 / 2, "update_ms_per_step.dense": 0.0}


def test_a_program_without_spans_reads_nothing():
    """The parent of the port's spans: every reader of them gives None."""
    trace, _ = _window(with_program_spans=False)
    assert ps.program_trace(trace) is None
    for name in ("render_fwd_ms_per_step.dense", "loss_ms_per_step.dense", "backward_ms_per_step.dense",
                 "update_ms_per_step.dense"):
        assert tr.metric_reader(name)(trace) is None
    trace, _ = _window()
    trace.calls.pop(ps.PROFILER_SPAN)
    assert ps.program_trace(trace) is None


def test_the_profiler_span_keeps_the_profiler():
    calls = {}
    original = torch.profiler.profile.__enter__
    with tr.spans(calls):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            pass
    assert torch.profiler.profile.__enter__ is original
    assert [c["result"] for c in calls[ps.PROFILER_SPAN]] == [prof]


def test_tile_fill_reads_the_counters():
    from topo4d_tpu_torch.utils import profiling

    read = tr.metric_reader("tile_fill_pct.dense")
    profiling.reset_counters()
    assert read(None) is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("blend.rows", 8)
        profiling.count("blend.tiles_occupied", 6)
    assert read(None) == 75.0
    profiling.reset_counters()


def _spread_ok(on, off) -> bool:
    """The medians of two sets of runs differ by no more than the wider set's range."""
    width = max(max(on) - min(on), max(off) - min(off))
    return abs(statistics.median(on) - statistics.median(off)) <= width


@pytest.mark.cuda
def test_program_spans_on_the_card(card, tiny_root, capsys, monkeypatch):
    """Three traced tiny frames with the program's spans and three with them
    patched out (the counters still count), each pair on one seed and the
    side that runs first alternating (on, off, off, on, on, off), so that a
    drift of the card's clock over the runs falls on both sides: with them, under 1% of the window's device time has no program
    span, K1, K2 and K5 lie in ``blend.fwd``, ``blend.bwd`` and ``blur``,
    and the six readers the benchmark had read alike (``launches_per_step``
    within 1, the others within the runs' spread); the five new readers each
    report, and without the spans only ``tile_fill_pct.dense`` does."""
    from topo4d_tpu_torch.pipeline import trainer as trainer_mod
    from topo4d_tpu_torch.texture import dense as dense_mod
    from topo4d_tpu_torch.utils import profiling

    kept = []
    read_profile = tr.read_profile

    def keep(*args, **kwargs):
        kept.append(read_profile(*args, **kwargs))
        return kept[-1]

    monkeypatch.setattr(tr, "read_profile", keep)
    old = ["bin_ms_per_frame.dense", "launches_per_step.dense", "elementwise_ms_per_step.dense",
           "blend_roofline", "blur_roofline", "peak_mem_gib.dense"]
    new = ["render_fwd_ms_per_step.dense", "loss_ms_per_step.dense", "backward_ms_per_step.dense",
           "update_ms_per_step.dense", "tile_fill_pct.dense"]
    lines = {True: [], False: []}
    for k in range(6):
        spans_on = k in (0, 3, 4)
        with monkeypatch.context() as mp:
            if not spans_on:
                for module in (profiling, dense_mod, trainer_mod):
                    mp.setattr(module, "span", lambda name: contextlib.nullcontext())
            profiling.reset_counters()
            rc = cell.main(["--workload", "tiny.dense", "--seed", str(2**31 + 101 + k // 2), "--seconds", "0.1",
                            "--trace", "1"], time.perf_counter(), device="cuda", root=str(tiny_root))
        out, _ = capsys.readouterr()
        assert rc == 0
        line = json.loads(out.strip().splitlines()[-1])
        assert line["correct"] is True
        lines[spans_on].append({name: m["value"] for name, m in line["metrics"].items()})
        if spans_on:
            trace = kept[-1]
            pt = ps.program_trace(trace)
            total = sum(op.dur_ns for op in trace.ops)
            loose = sum(op.dur_ns for op, p in zip(trace.ops, pt.program) if p is None)
            assert loose < 0.01 * total, (loose, total)
            for kernel, span in (("tile_blend_fwd_kernel", "blend.fwd"), ("tile_blend_bwd_kernel", "blend.bwd"),
                                 ("gauss_blur_kernel", "blur")):
                named = [p for op, p in zip(trace.ops, pt.program) if kernel in op.name]
                assert named and set(named) == {span}, (kernel, set(named))
    on, off = lines[True], lines[False]
    for reads in on:
        assert all(reads.get(name) is not None for name in old + new), reads
    for reads in off:
        assert all(reads.get(name) is None for name in new[:4]) and reads.get(new[4]) is not None, reads
    for name in old:
        a, b = [r[name] for r in on], [r[name] for r in off]
        if name == "launches_per_step.dense":
            assert abs(statistics.median(a) - statistics.median(b)) <= 1, (a, b)
        else:
            assert _spread_ok(a, b), (name, a, b)
