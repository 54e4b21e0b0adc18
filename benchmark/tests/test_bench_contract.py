"""The benchmark's contract on the CPU: ``BENCHMARK.json``'s form, the
result line of a run, and the files found by name."""

from __future__ import annotations

import json
import os
import re
import time

import pytest

from benchmark.harness import cell

from .conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_spec_form():
    spec = load_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and 1 <= spec["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in spec[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as fh:
            assert json.load(fh)["reduced"] == c["reduced"]
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert os.path.exists(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
        assert len(w["why"]) <= 200
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py"))
    assert len(json.dumps(spec)) < 64 * 1024


def run_tiny(root, capsys, trace: int, *extra):
    rc = cell.main(["--workload", "tiny.dense", "--seed", str(2**31 + 11), "--seconds", "0.1",
                    "--trace", str(trace), *extra], time.perf_counter(), device="cpu", root=str(root))
    out, err = capsys.readouterr()
    return rc, json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(tiny_root, capsys, trace):
    rc, line, err = run_tiny(tiny_root, capsys, trace)
    assert rc == 0
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "compared"
    assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["compared"]) == {"loss_gap", "grad_gap", "change_gap", "step_count_gap"}
    assert err.strip().splitlines()[-1].startswith("compared step_count_gap")
    if trace:  # the CPU has no device trace: the readers of device time find nothing and are left out
        assert set(line["metrics"]) <= {m["name"] for m in load_spec()["per_layer"]}
        assert line["device"]["window_s"] > 0 and "breakdown" in line
    else:
        assert set(line["metrics"]) == {"dense_s_per_frame", "setup_s"}
        assert line["metrics"]["dense_s_per_frame"]["unit"] == "s/frame"


def test_metric_found_by_its_file(tiny_root, capsys):
    (tiny_root / "benchmark" / "metrics" / "frames_in_window.py").write_text(
        "def read(trace):\n    return float(trace.frames)\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "frames_in_window", "unit": "frames", "better": "higher",
                              "source": "program_counter", "layer": "trainer loop", "moves": "dense_s_per_frame",
                              "workloads": ["tiny.dense"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    rc, line, _ = run_tiny(tiny_root, capsys, 1)
    assert rc == 0 and line["metrics"]["frames_in_window"] == {"value": 1.0, "unit": "frames"}


def test_files_found_by_name(tiny_root):
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    args = type("A", (), {"workload": "tiny.dense"})
    config, traffic, chips, e2e, per_layer, _ = cell.resolve(args, spec, str(tiny_root))
    assert config["mesh"]["rows"] == 12 and traffic["phase"] == "dense" and chips == 1
    assert [m["name"] for m in e2e] == ["dense_s_per_frame", "setup_s"]
    with pytest.raises(SystemExit):
        cell.resolve(type("A", (), {"workload": "no.such"}), spec, str(tiny_root))
