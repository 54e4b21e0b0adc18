"""Build and load the hand-written CUDA kernels of ``csrc/`` (nvcc + ctypes).

Each ``.cu`` file has a plain C interface and is compiled on first use by
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false -shared
-Xcompiler -fPIC`` into ``<repo>/build/``, one shared library per source,
named by a hash of the source, of every ``csrc/`` header it includes
(``#include "..."``, followed into headers) and of the flags, so an edited
kernel or header is never served stale.
``build_all()`` starts one ``nvcc`` per source at once. Nothing here runs at
import: the CPU tests import every module on a machine without ``nvcc``.

There is no fallback: a failed build raises with nvcc's output, and a
launch whose ``cudaGetLastError()`` is not 0 raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
]

P = ctypes.c_void_p
I64 = ctypes.c_int64
I32 = ctypes.c_int

# C symbol -> (source file, argtypes); pointers and the stream are c_void_p
KERNELS: Dict[str, tuple] = {
    "tile_blend_fwd": ("blend_fwd.cu", [P, I64, P, P, P, I32, I32, P, P]),
    "tile_blend_bwd": ("blend_bwd.cu", [P, I64, P, P, P, I32, I32, P, P, P, P]),
    "tile_blend_v3_fwd": ("blend_v3_fwd.cu", [P, I64, P, P, P, I32, I32, I32, P, P]),
    "tile_blend_v3_bwd": ("blend_v3_bwd.cu", [P, I64, P, P, P, I32, I32, I32, P, P, P, P]),
    "gauss_blur": ("blur.cu", [P, P, I32, I32, I32, P, P]),
    "uv_bake": ("bake.cu", [P, P, I64, P, I32, P, P, P, I32, P, I32, I32, I32, I32, P, P]),
}

_loaded: Dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and /usr/local/cuda/bin)")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(source: str) -> List[Path]:
    """``source`` and every ``csrc/`` file it includes with quotes, followed
    into the included files, each once, in the order first met."""
    found: List[Path] = []
    todo = [CSRC / source]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo.extend(CSRC / name for name in _INCLUDE.findall(path.read_text()))
    return found


def _lib_path(source: str) -> Path:
    text = b"".join(p.read_bytes() for p in _sources(source))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build_all(verbose: bool = False) -> float:
    """Compile every missing kernel library, all nvcc processes at once.

    Returns the wall seconds spent. Raises RuntimeError with the compiler's
    output if any build fails.
    """
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs: List[tuple] = []
    missing = [s for s in sorted({src for src, _ in KERNELS.values()}) if not _lib_path(s).exists()]
    nvcc = _nvcc() if missing else None  # before any temporary file is made
    for source in missing:
        out = _lib_path(source)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, str(CSRC / source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((source, out, tmp, proc))
    failed = []
    for source, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{source}:\n{log}")
            os.unlink(tmp)
            continue
        if verbose:
            print(f"[nvcc] {source}\n{log.strip()}")
        os.replace(tmp, out)  # atomic: a concurrent builder sees a whole file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def kernel(symbol: str):
    """The ctypes function for ``symbol``, building its library if needed."""
    fn = _loaded.get(symbol)
    if fn is None:
        source, argtypes = KERNELS[symbol]
        path = _lib_path(source)
        if not path.exists():
            build_all()
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[symbol] = fn
    return fn


def check(status: int, symbol: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{symbol}: CUDA launch failed with cudaError {status}")
