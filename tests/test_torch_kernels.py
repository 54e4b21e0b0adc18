"""The kernel build cache of the PyTorch port (``topo4d_tpu_torch/kernels.py``).

A built library is named by a hash of its ``.cu`` source, of every
``csrc/`` header that source includes (followed into headers) and of the
nvcc flags, so an edited header is never served stale from ``build/``. No
``nvcc`` is needed: only the names are computed.
"""

import pytest

from topo4d_tpu_torch import kernels


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "body.cuh"\nint k() { return f(); }\n')
    (tmp_path / "body.cuh").write_text('#pragma once\n  #  include "inner.cuh"\nint f() { return g(); }\n')
    (tmp_path / "inner.cuh").write_text("#pragma once\nint g() { return 1; }\n")
    (tmp_path / "other.cuh").write_text("int h() { return 2; }\n")
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    return tmp_path


def test_library_name_follows_included_headers(csrc):
    assert [p.name for p in kernels._sources("k.cu")] == ["k.cu", "body.cuh", "inner.cuh"]
    name = kernels._lib_path("k.cu").name
    assert name.startswith("k-") and name.endswith(".so")
    assert kernels._lib_path("k.cu").name == name  # the same files give the same name
    (csrc / "other.cuh").write_text("int h() { return 3; }\n")  # not included: no rebuild
    assert kernels._lib_path("k.cu").name == name
    for header in ("body.cuh", "inner.cuh"):
        before = kernels._lib_path("k.cu").name
        (csrc / header).write_text((csrc / header).read_text() + "// edited\n")
        assert kernels._lib_path("k.cu").name != before, header


def test_shared_blend_body_is_in_both_backward_keys():
    """K2 and K4b include the same per-tile body, so an edit of it renames
    both libraries."""
    for source in ("blend_bwd.cu", "blend_v3_bwd.cu"):
        assert [p.name for p in kernels._sources(source)] == [source, "blend_bwd_tile.cuh"]
    for source in ("blur.cu", "bake.cu"):
        assert [p.name for p in kernels._sources(source)] == [source]


def test_shared_blend_body_is_in_both_forward_keys():
    """K1 and K4f include the same per-tile body, so an edit of it renames
    both libraries, and neither includes the backward's."""
    for source in ("blend_fwd.cu", "blend_v3_fwd.cu"):
        assert [p.name for p in kernels._sources(source)] == [source, "blend_fwd_tile.cuh"]


def test_every_kernel_source_is_named_once():
    """Each C symbol maps to its own source, and every source and header in
    csrc/ is built by some kernel: nothing is left unbuilt or shared by
    name."""
    sources = [src for src, _ in kernels.KERNELS.values()]
    assert len(sources) == len(set(sources))
    used = {p.name for src in sources for p in kernels._sources(src)}
    assert used == {p.name for p in kernels.CSRC.iterdir() if p.suffix in (".cu", ".cuh")}
