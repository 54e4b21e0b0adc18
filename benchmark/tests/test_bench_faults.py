"""``correct`` comes out false when the timed path is broken underneath,
and the lower-precision control fails the configurations' limits. Each
run skips the look for a card and drives the rest of a run on the CPU at
a tiny size."""

from __future__ import annotations

import json
import time

import pytest
import torch

from benchmark import calibrate
from benchmark.harness import cell, check

from .conftest import tiny_config


def run_tiny(root, capsys):
    rc = cell.main(["--workload", "tiny.dense", "--seed", "9", "--seconds", "0.1", "--trace", "0"],
                   time.perf_counter(), device="cpu", root=str(root))
    assert rc == 0
    return json.loads(capsys.readouterr()[0].strip().splitlines()[-1])


def state_unchanged(monkeypatch):
    """Every dense step returns the state it was given."""
    from topo4d_tpu_torch.pipeline import trainer
    from topo4d_tpu_torch.texture import dense

    make = dense.make_texture_step

    def broken(*args, **kwargs):
        step = make(*args, **kwargs)

        def same_state(state, *a, **k):
            return state, step(state, *a, **k)[1]

        return same_state

    monkeypatch.setattr(dense, "make_texture_step", broken)
    monkeypatch.setattr(trainer, "make_texture_step", broken)


def half_views(monkeypatch):
    """The photometric loss over the top half of each view, its mean taken over that half."""
    from topo4d_tpu_torch.texture import dense

    loss = dense.photometric_loss
    monkeypatch.setattr(dense, "photometric_loss",
                        lambda pred, target: loss(pred[:, : pred.shape[1] // 2], target[:, : target.shape[1] // 2]))


def _broken_multi_step(monkeypatch, alter):
    """The multi-step runs on ``alter(view_ids, binnings)`` in place of its
    views and frozen binnings."""
    from topo4d_tpu_torch.pipeline import trainer
    from topo4d_tpu_torch.texture import dense

    make = dense.make_texture_multi_step

    def broken(*args, **kwargs):
        multi = make(*args, **kwargs)

        def run(state, means, images, cams, view_ids, anchor, pre, lr, weights, binnings=None, masks=None):
            view_ids, binnings = alter(list(view_ids), binnings)
            return multi(state, means, images, cams, view_ids, anchor, pre, lr, weights, binnings, masks)

        return run

    monkeypatch.setattr(dense, "make_texture_multi_step", broken)
    monkeypatch.setattr(trainer, "make_texture_multi_step", broken)


def multi_step_drops_a_step(monkeypatch):
    """The multi-step leaves out the last view of its slice."""
    _broken_multi_step(monkeypatch, lambda ids, binnings: (ids[:-1], binnings))


def multi_step_wrong_binning(monkeypatch):
    """The multi-step renders each view with the next view's frozen binning."""
    _broken_multi_step(monkeypatch, lambda ids, b: (ids, None if b is None else list(b[1:]) + list(b[:1])))


@pytest.mark.parametrize("fault", [state_unchanged, half_views, multi_step_drops_a_step, multi_step_wrong_binning])
def test_broken_step_is_not_correct(tiny_root, capsys, monkeypatch, fault):
    assert run_tiny(tiny_root, capsys)["correct"] is True
    fault(monkeypatch)
    line = run_tiny(tiny_root, capsys)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["compared"].values())


@pytest.mark.parametrize("name", ["seam24_d30", "face24_d30"])
def test_control_fails_the_limits(name):
    """The reference in bfloat16, in the program's place, fails at least one
    of the configuration's limits."""
    config = tiny_config(name)
    traffic = {"phase": "dense", "cycle_frames": 3, "motion": 0.004}
    rows = calibrate.control_seed(config, traffic, 3, torch.device("cpu"))
    control = next(r for r in rows if r["kind"] == "control_bf16")["numbers"]
    assert any(control[k] > config["limits"][k] for k in control), control
    assert set(control) == set(check.compare(check.as_program(rows[0]["readings"]), rows[0]["readings"]))
