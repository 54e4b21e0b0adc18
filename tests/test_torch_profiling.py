"""``topo4d_tpu_torch.utils.profiling`` against ``tests/test_profiling.py``:
the phase timer, the throughput counter and the gated profiler trace, which
here records the CPU (the card's kernels join it on a CUDA device), and a
small ``Trainer.run`` under ``TOPO4D_PROFILE_DIR`` that leaves its trace."""

import json
import os
import time

import numpy as np
import pytest
import torch

from topo4d_tpu.utils import profiling as J

from topo4d_tpu_torch.utils.profiling import PhaseTimer, device_trace, mpix_per_s, sync_value

CPU = "cpu"


def _trace_events(path):
    with open(path) as fh:
        return json.load(fh)["traceEvents"]


def test_phase_timer_accumulates_as_jax(tmp_path):
    timers = (PhaseTimer(), J.PhaseTimer())
    for timer in timers:
        for _ in range(3):
            with timer.phase("a"):
                time.sleep(0.01)
        timer.add("b", 2.5)
        try:
            with timer.phase("boom"):
                raise RuntimeError
        except RuntimeError:
            pass
    s, sj = (t.summary() for t in timers)
    assert s.keys() == sj.keys() == {"a", "b", "boom"}
    assert s["a"]["count"] == sj["a"]["count"] == 3 and s["a"]["seconds"] >= 0.03
    assert abs(s["a"]["mean_seconds"] - s["a"]["seconds"] / 3) < 1e-3
    assert s["b"] == sj["b"] == {"seconds": 2.5, "count": 1, "mean_seconds": 2.5}
    assert s["boom"]["count"] == 1
    path = str(tmp_path / "timings.json")
    timers[0].write(path)
    assert json.load(open(path)) == s
    # a resumed run folds the earlier file in; the JAX timer reads the same file alike
    again, again_j = PhaseTimer(), J.PhaseTimer()
    for t in (again, again_j):
        t.load(path)
        t.add("b", 1.5)
    assert again.summary()["b"] == again_j.summary()["b"] == {"seconds": 4.0, "count": 2, "mean_seconds": 2.0}
    bad = tmp_path / "bad.json"
    bad.write_text("{oops")
    torn = PhaseTimer()
    torn.load(str(bad))
    assert torn.summary() == {}


def test_device_trace_disabled_is_noop(monkeypatch, tmp_path):
    monkeypatch.delenv("TOPO4D_PROFILE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    # disabled, it asks for no device: no card is needed
    with device_trace() as tracing:
        assert tracing is False
    assert os.listdir(tmp_path) == []


def test_device_trace_enabled_writes_a_parseable_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("TOPO4D_PROFILE_DIR", raising=False)
    logdir = tmp_path / "trace"
    x = torch.ones((64, 64))
    with device_trace(str(logdir), device=CPU) as tracing:
        assert tracing is True
        y = sync_value(torch.mm(x, x))
    assert float(y[0, 0]) == 64.0
    assert sorted(os.listdir(logdir)) == ["counters_rank0.json", "trace_rank0.json"]
    events = _trace_events(logdir / "trace_rank0.json")
    assert any(e.get("name") == "aten::mm" for e in events)
    # the variable enables it too, and an exception in the block still leaves the trace
    env_dir = tmp_path / "env"
    monkeypatch.setenv("TOPO4D_PROFILE_DIR", str(env_dir))
    with pytest.raises(RuntimeError, match="inside"):
        with device_trace(device=CPU) as tracing:
            assert tracing is True
            torch.mm(x, x)
            raise RuntimeError("inside")
    assert any(e.get("name") == "aten::mm" for e in _trace_events(env_dir / "trace_rank0.json"))


def test_device_trace_on_a_missing_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with device_trace(str(tmp_path), device="cuda"):
            pass


def test_mpix_per_s_and_sync_value():
    for f in (mpix_per_s, J.mpix_per_s):
        assert f(1000, 1000, 10, 2.0) == 5.0
        assert f(100, 100, 1, 0.0) == 0.0
    tree = {"a": torch.ones(2), "b": [torch.zeros(1), (3, "x")]}
    assert sync_value(tree) is tree


def test_trainer_run_under_the_profile_dir_leaves_a_trace(tmp_path, monkeypatch, capsys):
    from topo4d_tpu_torch.config import Config
    from topo4d_tpu_torch.pipeline.data import SyntheticSequence
    from topo4d_tpu_torch.pipeline.scene import build_scene
    from topo4d_tpu_torch.pipeline.trainer import Trainer
    from topo4d_tpu_torch.testing import grid_uvs, make_camera_ring, make_grid_mesh, make_synthetic_regions
    from topo4d_tpu_torch.topology.obj_io import MeshObj

    verts, faces = make_grid_mesh(6, 6, extent=0.5)
    cfg = Config()
    cfg.data.output_dir = str(tmp_path / "out")
    cfg.data.use_mask = False
    cfg.data.log_views = []
    cfg.schedule.frame_num = 1
    cfg.schedule.init_opt_num = 3
    cfg.schedule.log_freq = 2
    mesh = MeshObj(vertices=verts, uvs=grid_uvs(6, 6), faces=faces, uv_faces=[list(f) for f in faces])
    params, statics = build_scene(mesh, make_synthetic_regions(verts.shape[0], faces), cfg, num_views=2)
    cams = make_camera_ring(2, width=32, height=16, distance=2.0, device=CPU)
    truth = dict(params, rgb_colors=np.random.default_rng(0).uniform(0.1, 0.9, params["rgb_colors"].shape)
                 .astype(np.float32))
    source = SyntheticSequence(params=truth, cameras=cams, num_frames=1)
    logdir = tmp_path / "trace"
    monkeypatch.setenv("TOPO4D_PROFILE_DIR", str(logdir))
    Trainer(cfg, source, params, statics, device=CPU).run(resume=False)
    assert "torch.profiler trace enabled" in capsys.readouterr().out
    names = {e.get("name") for e in _trace_events(logdir / "trace_rank0.json")}
    assert "aten::mm" in names or "aten::matmul" in names or "aten::bmm" in names
