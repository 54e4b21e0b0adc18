"""The dense loop's binning cadences and the photometric remat of the
port's trainer against the JAX trainer on the CPU, through
``tests/test_torch_dense_step.py``'s harness (the same scene, tolerances
and row comparison; JAX's Pallas kernels in interpret mode).

JAX selects the mode at ``pipeline/trainer.py:620-627``: scan mode at
``texture.rebin_freq`` 0 (one frozen binning per view, bound up front) and
1 (no frozen binning: every render bins afresh), loop mode at any other
value or without ``schedule.use_scan`` (a view bound at its first use,
re-bound after ``rebin_freq`` uses). Each case holds the frozen binnings
the port builds to the count JAX's trainer builds and to that lifecycle.
"""

import pytest
import torch
from test_torch_dense_step import _counting, _fit_texture_both, _texture_case

from topo4d_tpu_torch import convert
from topo4d_tpu_torch.pipeline.data import view_order
from topo4d_tpu_torch.pipeline.trainer import Trainer

CPU = "cpu"


def _loop_mode_binnings(order, rebin, log_freq):
    """Frozen binnings of JAX's loop mode over ``order``: one at each view's
    first use and one after every ``rebin`` uses (never, when negative),
    plus view 0's at the first log row if no step has bound it."""
    uses, n = {}, 0
    for i, v in enumerate(order):
        if v not in uses or 0 < rebin <= uses[v]:
            uses[v], n = 0, n + 1
        uses[v] += 1
        if i % log_freq == 0 and 0 not in uses:
            uses[0], n = 0, n + 1
    return n


@pytest.mark.parametrize("option", ["rebin_1", "rebin_2", "loop_rebin_0", "remat"])
def test_trainer_dense_modes_match_jax(option):
    """``rebin_freq`` 1 (scan mode, a fresh binning in every render),
    ``rebin_freq`` 2 (loop mode, each view re-bound after 2 uses; 9
    iterations, so that view 3 is re-bound at its third use), loop mode at
    ``rebin_freq`` 0 (``use_scan`` off: each view bound once, at its first
    use) and ``remat_photometric``, each against the JAX trainer."""
    texture, schedule = {
        "rebin_1": ({"rebin_freq": 1}, None),
        "rebin_2": ({"rebin_freq": 2}, {"dense_opt_num": 9}),
        "loop_rebin_0": ({}, {"use_scan": False}),
        "remat": ({"remat_photometric": True}, None),
    }[option]
    tt, _, counts = _fit_texture_both(allview_eval=False, schedule=schedule, **texture)
    assert counts["port"] == counts["jax"]
    num_iters = tt.cfg.schedule.dense_opt_num
    order = [int(v) for v in view_order(4, num_iters, seed=10_000)]
    if option == "rebin_1":
        assert counts["port"] == 0
        assert counts["fresh"] == 6 + 3  # one per step, one per eval render (2 log rows, the terminal row)
    elif option in ("rebin_2", "loop_rebin_0"):
        rebin = texture.get("rebin_freq", 0)
        # each view once at its first use, view 0 at the first log row; rebin 2 re-binds view 3 once
        assert counts["port"] == _loop_mode_binnings(order, rebin, 3) == 4 + (rebin == 2)
        assert counts["fresh"] == 0
    else:
        assert counts == {"jax": 4, "port": 4, "fresh": 0}


def test_trainer_remat_equals_remat_off_bit_for_bit():
    """``texture.remat_photometric`` recomputes the photometric loss in the
    backward (two calls per step instead of one) and changes no bit: the
    dense parameters, Adam moments and metric rows equal the run without
    it."""
    import topo4d_tpu_torch.texture.dense as t_dense

    runs, calls = [], {}
    for remat in (False, True):
        _, tcfg, params, js, _, seq, frame = _texture_case({"remat_photometric": remat})
        tt = Trainer(tcfg, seq, params, convert.statics_from_numpy(js), device=CPU)
        calls[remat] = 0
        with pytest.MonkeyPatch.context() as mp:
            _counting(mp, t_dense, "photometric_loss", calls, remat)
            tt.fit_frame_texture(0, frame)
        runs.append(tt)
    assert calls == {False: 6, True: 12}
    off, on = runs
    for k, v in off.texture_state.params.items():
        assert torch.equal(on.texture_state.params[k], v), k
        assert torch.equal(on.texture_state.opt.mu[k], off.texture_state.opt.mu[k]), k
        assert torch.equal(on.texture_state.opt.nu[k], off.texture_state.opt.nu[k]), k
    assert on.metrics_log == off.metrics_log
