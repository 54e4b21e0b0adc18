"""Fixtures of the benchmark's own tests (run them with
``python -m pytest benchmark/tests``; the card-marked ones need a CUDA card
and skip without one)."""

from __future__ import annotations

import json
import os
import shutil

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

TINY = {
    "views": 4, "work_size": [48, 32], "dense_size": [96, 64], "density": 2,
    "dense_opt_num": 4, "dense_log_freq": 3,
}


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


def tiny_config(name: str = "seam24_d30", **extra) -> dict:
    with open(os.path.join(BENCH, "configs", name + ".json")) as fh:
        config = json.load(fh)
    config["mesh"].update(rows=12, cols=10)
    config.update(TINY, **extra)
    return config


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout's data files with one tiny cell, ``tiny.dense``: the real
    traffic, span and metric files, and the seam configuration cut to a
    12 x 10 grid, 4 views of 96 x 64 and 4 dense steps a frame (logged at
    step 0, steps 1-2 through the multi-step, step 3 logged)."""
    bench = tmp_path / "benchmark"
    for sub in ("traffic", "spans", "metrics"):
        shutil.copytree(os.path.join(BENCH, sub), bench / sub)
    (bench / "configs").mkdir()
    (bench / "configs" / "tiny.json").write_text(json.dumps(tiny_config()))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    spec["configs"] = [dict(spec["configs"][0], name="tiny", file="benchmark/configs/tiny.json")]
    spec["workloads"] = [dict(spec["workloads"][0], name="tiny.dense", config="tiny")]
    for m in spec["per_layer"]:
        m["workloads"] = ["tiny.dense"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path
