"""The benchmark's spans around the port's kernel entries see every call
that the port's own launch counters (``LAUNCHES``) count."""

from __future__ import annotations

import json
import types

import pytest
import torch

from benchmark.harness import check, program
from benchmark.harness import trace as tr
from benchmark.harness.scene import make_scene
from benchmark.harness.targets import render_views

from .conftest import tiny_config


def test_blend_spans_count_the_launches(monkeypatch):
    """On the CPU, with the kernel launch replaced by a no-op: every call
    that reaches K1's and K2's entries through the port's autograd function
    is one span call and one count."""
    from topo4d_tpu_torch import kernels
    from topo4d_tpu_torch.rasterizer import blend

    monkeypatch.setattr(kernels, "kernel", lambda symbol: (lambda *args: 0))
    monkeypatch.setattr(blend, "_check_inputs", lambda p, s, c, tx, ty, ids: tx * ty if ids is None else ids.shape[0])
    monkeypatch.setattr(blend, "_check_grad_inputs", lambda *args: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    blend.reset_launches()
    originals = blend.tile_blend_fwd_cuda, blend.tile_blend_bwd_cuda
    calls = {}
    with tr.spans(calls):
        assert blend.tile_blend_fwd_cuda is not originals[0]
        for _ in range(3):
            packed = torch.zeros(16, 256, requires_grad=True)
            start, count = torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32)
            out = blend._TileBlendCUDA.apply(packed, start, count, 2, 2, None, None)
            out.sum().backward()
    assert (blend.tile_blend_fwd_cuda, blend.tile_blend_bwd_cuda) == originals
    assert len(calls["blend_fwd"]) == blend.LAUNCHES["tile_blend_fwd"] == 3
    assert len(calls["blend_bwd"]) == blend.LAUNCHES["tile_blend_bwd"] == 3
    assert all(len(c["args"]) == 1 for c in calls["blend_fwd"] + calls["blend_bwd"])


@pytest.mark.cuda
def test_traced_frame_on_the_card(card):
    """One tiny dense frame on the card under the profiler: the span calls
    equal the launch counts, and each kernel of an entry is attributed to
    that entry's span."""
    from topo4d_tpu_torch.losses import blur
    from topo4d_tpu_torch.rasterizer import blend

    config = tiny_config()
    traffic = {"phase": "dense", "cycle_frames": 3, "motion": 0.004}
    scene = make_scene(config, 7, card)
    heads = [scene.head(k, 0.004) for k in range(3)]
    targets = [render_views(scene, scene.dense_rig, h, card) for h in heads]
    trainer = program.build_trainer(scene, config, traffic, card)
    names = trainer.source.view_names
    check.program_readings(trainer, heads, targets, names)
    blend.reset_launches()
    blur.reset_launches()
    calls = {}
    with tr.spans(calls):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(tr.WINDOW):
                program.set_geometry(trainer, heads[2])
                trainer.fit_frame_texture(2, program.frame_data(targets[2], names))
                torch.cuda.synchronize()
    trace = tr.read_profile(prof, calls, 0, 1, config["dense_opt_num"], {})
    for span, key in (("blend_fwd", "tile_blend_fwd"), ("blend_bwd", "tile_blend_bwd")):
        assert len(calls[span]) == blend.LAUNCHES[key] > 0
    assert len(calls["blur"]) == blur.LAUNCHES["gauss_blur"] > 0
    for span, kernel in (("blend_fwd", "tile_blend_fwd_kernel"), ("blend_bwd", "tile_blend_bwd_kernel"),
                         ("blur", "gauss_blur_kernel")):
        named = [op for op in trace.ops if kernel in op.name]
        assert len(named) == len(calls[span]) and all(op.span == span for op in named), json.dumps(
            [[op.name, op.span] for op in named][:5])
    assert 0 < trace.busy_s <= trace.window_s
