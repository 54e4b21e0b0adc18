"""The port's own spans and counters (``topo4d_tpu_torch.utils.profiling``):
what a tiny dense frame records under ``torch.profiler`` on the CPU, that
an untraced frame makes no span and counts nothing, that the binning and
blend counters equal what the frame's binnings and launches say, and that
a ``Trainer.run`` under ``TOPO4D_PROFILE_DIR`` leaves the phases' spans and
the counters beside its trace."""

import json

import numpy as np
import pytest
import torch

from topo4d_tpu_torch.config import Config
from topo4d_tpu_torch.pipeline.data import SyntheticSequence, view_order
from topo4d_tpu_torch.pipeline.scene import build_scene
from topo4d_tpu_torch.pipeline.trainer import Trainer, _blend_rows
from topo4d_tpu_torch.rasterizer import blend
from topo4d_tpu_torch.testing import grid_uvs, make_camera_ring, make_grid_mesh, make_synthetic_regions
from topo4d_tpu_torch.topology.obj_io import MeshObj
from topo4d_tpu_torch.utils import profiling

CPU = "cpu"
STEPS, LOG_FREQ = 7, 3  # log rows at steps 0, 3, 6; steps 1-2 and 4-5 through the multi-step
STEP_PARTS = ("dense.constraints", "render.forward", "dense.loss", "dense.backward", "dense.update")


def _dense_case(tmp_path, frames=1, **texture):
    """A 10x10 grid at density 2, 4 views at 64x48 (12 tiles), ``STEPS``
    dense steps logged every ``LOG_FREQ`` -> (config, trainer, frame 0's
    full-resolution targets)."""
    verts, faces = make_grid_mesh(10, 10, extent=0.5)
    cfg = Config()
    cfg.data.output_dir = str(tmp_path / "out")
    cfg.data.use_mask = False
    cfg.data.log_views = []
    cfg.texture.gen_tex = True
    cfg.texture.density = 2
    cfg.texture.tex_res = 64
    cfg.schedule.frame_num = frames
    cfg.schedule.init_opt_num = 3
    cfg.schedule.dense_opt_num = STEPS
    cfg.schedule.dense_log_freq = LOG_FREQ
    for k, v in texture.items():
        setattr(cfg.texture, k, v)
    mesh = MeshObj(vertices=verts, uvs=grid_uvs(10, 10), faces=faces, uv_faces=[list(f) for f in faces])
    params, statics = build_scene(mesh, make_synthetic_regions(verts.shape[0], faces), cfg, num_views=4)
    truth = dict(params, rgb_colors=np.random.default_rng(0).uniform(0.1, 0.9, params["rgb_colors"].shape)
                 .astype(np.float32))
    cams = make_camera_ring(4, width=64, height=48, distance=2.0, device=CPU)
    source = SyntheticSequence(params=truth, cameras=cams, num_frames=frames)
    return cfg, Trainer(cfg, source, params, statics, device=CPU), source.frame(0, full_res=True)


def _profiled(fn):
    """Run ``fn`` under ``torch.profiler`` (CPU) -> the port's spans as
    [(name without the prefix, start ns, end ns)], in start order."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    spans = [(e.name()[len(profiling.SPAN_PREFIX):], e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events() if e.name().startswith(profiling.SPAN_PREFIX)]
    return sorted(spans, key=lambda s: s[1])


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_dense_frame_spans(tmp_path):
    """One frame: one ``dense.frame`` holding one ``dense.transfer`` and one
    ``dense.binnings``, a ``dense.step`` per step (the multi-step's too),
    each holding one of each of its parts, and a ``dense.eval`` per log row
    plus the terminal row."""
    _, trainer, frame = _dense_case(tmp_path)
    spans = _profiled(lambda: trainer.fit_frame_texture(0, frame))
    names = [s[0] for s in spans]
    assert {n: names.count(n) for n in set(names)} == {
        "dense.frame": 1, "dense.transfer": 1, "dense.binnings": 1, "dense.step": STEPS,
        "dense.eval": -(-STEPS // LOG_FREQ) + 1, **{part: STEPS for part in STEP_PARTS},
    }
    frame_span = spans[0]
    assert frame_span[0] == "dense.frame" and all(_inside(s, frame_span) for s in spans)
    steps = [s for s in spans if s[0] == "dense.step"]
    for step in steps:
        assert sorted(s[0] for s in spans if s[0] in STEP_PARTS and _inside(s, step)) == sorted(STEP_PARTS)
    evals = [s for s in spans if s[0] == "dense.eval"]
    assert not any(_inside(e, s) for e in evals for s in steps)


def test_untraced_frame_makes_no_span_and_counts_nothing(tmp_path, monkeypatch):
    """Without a profiler a span is one shared no-op context (no
    ``record_function`` is made) and a count leaves the registry empty."""

    def refuse(*args, **kwargs):
        raise AssertionError("record_function made without a profiler")

    _, trainer, frame = _dense_case(tmp_path)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiling.reset_counters()
    assert not profiling.tracing()
    assert profiling.span("a") is profiling.span("b")
    profiling.count("blend.renders", 3)
    trainer.fit_frame_texture(0, frame)
    assert profiling.counters() == {}


@pytest.mark.parametrize("capacity", [-1, 4])
def test_binning_counters_equal_the_binnings(tmp_path, capacity):
    """``binning.entries``, ``binning.cropped`` and ``binning.overflow``
    equal the sums over the frame's own binnings (auto capacity, and a
    manual one of 4 below the occupancy, whose overflow is counted)."""
    _, trainer, frame = _dense_case(tmp_path, tile_capacity=capacity)
    made = []
    dense_binnings = trainer.dense_binnings

    def keep(t):
        made.extend(dense_binnings(t))
        return made[-4:]

    trainer.dense_binnings = keep
    profiling.reset_counters()
    _profiled(lambda: trainer.fit_frame_texture(0, frame))
    got = profiling.counters()
    assert len(made) == 4
    occ = [int(torch.count_nonzero(b.tile_count)) for b in made]
    assert got["binning.entries"] == sum(int(b.entry_valid.sum()) for b in made) > 0
    assert got["binning.cropped"] == sum(int(b.num_cropped) for b in made)
    overflow = sum(max(o - _blend_rows(b), 0) for o, b in zip(occ, made))
    assert got["binning.overflow"] == overflow
    assert (overflow > 0) == (capacity == 4)


@pytest.mark.parametrize("rebin_freq", [0, 2])
def test_blend_renders_count_the_launches(tmp_path, rebin_freq):
    """``blend.renders`` equals the frame's blend launches as ``LAUNCHES``
    counts them (the plain blend on the CPU), in scan mode and in loop
    mode; in scan mode ``blend.rows`` and ``blend.tiles_occupied`` follow
    the step order and the eval renders of view 0."""
    cfg, trainer, frame = _dense_case(tmp_path, rebin_freq=rebin_freq)
    made = []
    dense_binnings = trainer.dense_binnings
    trainer.dense_binnings = lambda t: made.extend(dense_binnings(t)) or made
    profiling.reset_counters()
    blend.reset_launches()
    _profiled(lambda: trainer.fit_frame_texture(0, frame))
    got = profiling.counters()
    assert got["blend.renders"] == blend.LAUNCHES["tile_blend_plain"] > STEPS
    assert 0 < got["blend.tiles_occupied"] <= got["blend.rows"]
    if rebin_freq == 0:
        order = [int(v) for v in view_order(4, STEPS, seed=10_000)]
        renders = order + [0] * (-(-STEPS // LOG_FREQ) + 1)
        assert got["blend.renders"] == len(renders)
        assert got["blend.rows"] == sum(_blend_rows(made[v]) for v in renders)
        assert got["blend.tiles_occupied"] == sum(int(torch.count_nonzero(made[v].tile_count)) for v in renders)


def test_trainer_run_under_the_profile_dir_leaves_spans_and_counters(tmp_path, monkeypatch):
    """``TOPO4D_PROFILE_DIR``: the trace holds the phases' spans and the
    dense frame's, and ``counters_rank0.json`` lies beside it."""
    cfg, trainer, _ = _dense_case(tmp_path)
    logdir = tmp_path / "trace"
    monkeypatch.setenv("TOPO4D_PROFILE_DIR", str(logdir))
    trainer.run(resume=False)
    with open(logdir / "trace_rank0.json") as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"topo4d.phase.geometry", "topo4d.phase.texture", "topo4d.dense.frame", "topo4d.dense.step"} <= names
    with open(logdir / "counters_rank0.json") as fh:
        counted = json.load(fh)
    assert counted["blend.renders"] == STEPS + -(-STEPS // LOG_FREQ) + 1
    assert counted["binning.entries"] > 0 and counted["blend.rows"] == 12 * counted["blend.renders"]
