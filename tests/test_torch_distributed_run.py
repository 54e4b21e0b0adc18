"""``Trainer.run`` over two gloo ranks on the CPU (``tests/torch_ranks.py``),
the "orbax" resume backend and the configuration keys of the multi-rank
paths.

- A batched 2-frame run (4 views, a view mesh of 2, the "orbax" backend)
  with each rank handed its own output directory: rank 0's tree is whole
  and rank 1 created nothing; the ranks end on the same bits; the result
  equals a 1-process run's (the pickle backend) within the batched
  tolerances of ``tests/test_torch_batched.py`` (parameters rtol 1e-5 /
  atol 1e-6, rotations of the tracked frame within two Adam steps; metric
  rows rtol 1e-4); a second run on rank 0's directory resumes as a no-op;
  a rank that reads another directory makes every rank raise.
- A parity-mode run with a dense phase under ``texture.tile_shard``: the
  geometry runs replicated, the dense renders tile-sharded over the ranks,
  and both equal a 1-process run's exactly (in value), the processes on
  one thread each.
- The "orbax" backend's round trip (``tests/test_checkpoint_orbax.py:17``).
- ``Config.from_json`` taking ``texture.tile_shard`` and
  ``data.checkpoint_backend`` "orbax".
"""

import json
import os

import numpy as np
import pytest
import torch

from topo4d_tpu_torch.config import Config
from topo4d_tpu_torch.losses.temporal import TemporalPriors
from topo4d_tpu_torch.opt.adam import adam_init
from topo4d_tpu_torch.opt.step import GeometryPriors, TrainState
from topo4d_tpu_torch.pipeline.checkpoint import load_params, load_resume_orbax, save_resume_orbax
from topo4d_tpu_torch.pipeline.trainer import Trainer
from topo4d_tpu_torch.texture.dense import TextureState
from torch_ranks import CPU, run_world, small_run


def _cases(root):
    base = {"grid": 6, "views": 4, "w": 48, "h": 32, "seed": 11}
    batched = dict(base, out=str(root / "batched"), data={"checkpoint_backend": "orbax"},
                   schedule={"views_per_step": 0, "frame_num": 2, "init_opt_num": 24, "opt_num": 16,
                             "polish_iters": 2, "log_freq": 500, "ckp_freq": 1},
                   raster={"track_rebin_freq": 0})
    dense = dict(base, out=str(root / "dense"),
                 schedule={"frame_num": 2, "init_opt_num": 6, "opt_num": 4, "polish_iters": 1, "log_freq": 500,
                           "ckp_freq": 1, "dense_opt_num": 3, "dense_log_freq": 2},
                 texture={"gen_tex": True, "density": 1, "tex_res": 32, "tile_shard": True})
    return batched, dense


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    batched, dense = _cases(tmp_path_factory.mktemp("ranks"))
    ranks = run_world(2, tmp_path_factory.mktemp("world"), "trainer_runs", {"batched": batched, "dense": dense})
    one_b, one_d = _cases(tmp_path_factory.mktemp("one"))
    one_b["data"] = {"checkpoint_backend": "pickle"}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks: a reduction's order follows the thread count
    try:
        single = {}
        for name, case in (("batched", one_b), ("dense", one_d)):
            cfg, source, params, statics = small_run(case, case["out"])
            tr = Trainer(cfg, source, params, statics, device=CPU)
            tr.run(resume=False)
            single[name] = (tr, os.path.join(cfg.data.output_dir, cfg.data.exp, cfg.data.seq))
    finally:
        torch.set_num_threads(threads)
    return ranks, single, batched


def _tree(out):
    return os.path.join(out, "exp_op1", "seq_01")


def test_rank0_alone_writes(runs):
    ranks, _, batched = runs
    out = _tree(batched["out"])
    for f in ("resume_orbax", "params.npz", "metrics.jsonl", "timings.json", "loss.json", "000001/face.obj",
              "000002/face.obj"):
        assert os.path.exists(os.path.join(out, f)), f
    assert not os.path.exists(os.path.join(out, "resume.pkl"))  # the orbax backend
    assert not os.path.exists(os.path.join(batched["out"], "rank1"))  # rank 1's own directory: never made
    assert not os.path.exists(os.path.join(batched["out"], "elsewhere"))
    assert [int(r["mesh"]) for r in ranks] == [2, 2] and [int(r["segments"]) for r in ranks] == [0, 0]


def test_ranks_hold_the_same_bits(runs):
    ranks = runs[0]
    keys = [k for k in ranks[0] if k.split("/")[0] in ("params", "mu", "nu", "dense")]
    assert len(keys) > 20
    for k in keys:
        np.testing.assert_array_equal(ranks[1][k], ranks[0][k], err_msg=k)


def test_two_ranks_match_one(runs):
    ranks, single, batched = runs
    tr, out1 = single["batched"]
    got, want = load_params(os.path.join(_tree(batched["out"]), "params.npz")), load_params(
        os.path.join(out1, "params.npz"))
    assert sorted(got) == sorted(want)
    lrs = tr.cfg.lrs
    for k in want:
        assert got[k].shape == want[k].shape, k
        if k == "unnorm_rotations":
            np.testing.assert_allclose(got[k][0], want[k][0], rtol=1e-5, atol=1e-6, err_msg=k)
            bound = 2 * 4 * max(lrs.track[k], lrs.polish[k])
            assert np.abs(got[k][1:] - want[k][1:]).max() <= bound
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    rows = [json.loads(r) for r in ranks[0]["rows"]]
    rows_1 = tr.metrics_log
    assert [(r.get("frame"), r.get("iter")) for r in rows] == [(r.get("frame"), r.get("iter")) for r in rows_1]
    for a, b in zip(rows, rows_1):
        for k in ("loss_total", "loss_im", "psnr"):
            if k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=(b["frame"], b.get("iter"), k))
    with open(os.path.join(_tree(batched["out"]), "metrics.jsonl")) as fh:
        assert len([json.loads(line) for line in fh]) == len(rows_1)


def test_resume_is_a_noop(runs):
    for r in runs[0]:
        assert int(r["resumed_steps"]) == 0 and bool(r["resumed_equal"])


def test_mismatched_output_dir_raises_on_every_rank(runs):
    for r in runs[0]:
        msg = str(r["mismatch"])
        assert "resume checkpoint mismatch" in msg and "[2, -1]" in msg and "shared filesystem" in msg


def test_tile_sharded_dense_run_equals_one_process(runs):
    ranks, single, _ = runs
    tr, _ = single["dense"]
    assert tr.texture_state is not None
    for k, v in tr.state.params.items():
        np.testing.assert_array_equal(ranks[0][f"dense/geometry/{k}"], v.numpy(), err_msg=k)
    for k, v in tr.texture_state.params.items():
        np.testing.assert_array_equal(ranks[0][f"dense/{k}"], v.numpy(), err_msg=k)


def test_orbax_resume_roundtrip(tmp_path):
    """``tests/test_checkpoint_orbax.py:17``: the payload's types and values."""
    n, k = 12, 4
    params = {"means3D": torch.ones(n, 3), "rgb_colors": torch.zeros(n, 3)}
    state = TrainState(params=params, opt=adam_init(params), max_2d_radius=torch.zeros(n))
    priors = GeometryPriors(
        neighbor_indices=torch.zeros((k, n), dtype=torch.int64), neighbor_dist=torch.ones(k, n),
        iso_w=torch.ones(k, n), rig_w=torch.ones(k, n), rot_w=torch.ones(k, n), init_scale=torch.ones(n),
        temporal=TemporalPriors(prev_inv_rot=torch.ones(4, n), prev_offset=torch.ones(3, k, n)),
        cos_init=torch.ones(7),
    )
    dense = {"dense_rgb_colors": torch.full((5, 3), 0.5)}
    tex = TextureState(params=dense, opt=adam_init(dense))
    out = str(tmp_path / "out")
    assert load_resume_orbax(out) is None
    save_resume_orbax(out, 5, state, priors, {"a": np.ones(3)}, [{"means3D": np.ones((n, 3))}], tex)
    p = load_resume_orbax(out)
    assert p["frame"] == 5
    assert isinstance(p["state"], TrainState)
    assert isinstance(p["priors"], GeometryPriors)
    assert isinstance(p["texture_state"], TextureState)
    np.testing.assert_array_equal(p["state"].params["means3D"], np.ones((n, 3)))
    np.testing.assert_array_equal(p["priors"].temporal.prev_offset, np.ones((3, k, n)))
    np.testing.assert_array_equal(p["texture_state"].params["dense_rgb_colors"], 0.5 * np.ones((5, 3)))
    np.testing.assert_array_equal(p["first_frame_attrs"]["a"], np.ones(3))
    assert len(p["output_params"]) == 1
    assert p["state"].opt.step == {"means3D": 0, "rgb_colors": 0}
    # a later save replaces the earlier whole; no texture state loads as None
    save_resume_orbax(out, 6, state, priors, None, [{"means3D": np.ones((n, 3))}] * 11)
    p = load_resume_orbax(out)
    assert p["frame"] == 6 and p["texture_state"] is None and p["first_frame_attrs"] is None
    assert len(p["output_params"]) == 11
    assert sorted(os.listdir(out)) == ["resume_orbax"]


def test_config_takes_the_multi_rank_keys():
    raw = json.loads(Config().to_json())
    raw["texture"]["tile_shard"] = True
    raw["data"]["checkpoint_backend"] = "orbax"
    cfg = Config.from_json(json.dumps(raw))
    assert cfg.texture.tile_shard is True and cfg.data.checkpoint_backend == "orbax"
