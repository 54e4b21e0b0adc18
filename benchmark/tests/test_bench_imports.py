"""What a benchmark run may load: the PyTorch port, never JAX or the JAX
package (compared by whole top-level module names), and a reference that
loads nothing of the port."""

from __future__ import annotations

import ast
import glob
import json
import os
import subprocess
import sys

from benchmark.harness import cell

from .conftest import BENCH, ROOT


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name in ("topo4d_tpu_torch", "topo4d_tpu_torch.pipeline", "jaxtyping", "flax_like"):
        monkeypatch.setitem(sys.modules, name, sys)
    found = set(cell.forbidden_modules())
    assert not found & {"topo4d_tpu_torch", "jaxtyping", "flax_like"}
    monkeypatch.setitem(sys.modules, "topo4d_tpu.losses", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert set(cell.forbidden_modules()) == found | {"topo4d_tpu", "jax"}


def test_run_loads_no_jax(tiny_root):
    """A whole tiny run in a fresh process: it exits 0 with a result line,
    which it would not do had it loaded JAX or the JAX package."""
    code = (
        "import sys, time; sys.path.insert(0, %r); from benchmark.harness import cell; "
        "rc = cell.main(['--workload', 'tiny.dense', '--seed', '5', '--seconds', '0.1', '--trace', '0'], "
        "time.perf_counter(), device='cpu', root=%r); "
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'topo4d_tpu')]; "
        "sys.exit(rc)" % (ROOT, str(tiny_root))
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True


def imported_roots(path: str):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_reference_imports_nothing_of_the_port():
    files = glob.glob(os.path.join(BENCH, "reference", "*.py"))
    assert files
    for path in files:
        assert set(imported_roots(path)) <= {"__future__", "dataclasses", "typing", "numpy", "scipy", "torch"}, path
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.step, benchmark.reference.render; "
            "assert not [m for m in sys.modules if m.split('.')[0] in "
            "('topo4d_tpu_torch', 'topo4d_tpu', 'jax', 'jaxlib', 'flax')]" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
