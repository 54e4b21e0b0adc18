"""Build and load the port's host libraries of ``csrc/`` (host compiler + ctypes).

Two libraries, each one source with a plain C interface, compiled on first
use into ``<repo>/build/``, named by a hash of the source and the flags, as
``kernels.py`` names the CUDA kernels:

- ``imgdec`` (``csrc/imgdec.c``): the loader's image decoding, the PNG
  unfilter and the JPEG decoder; C99, built by ``$CC``, else ``cc``,
  else ``gcc``;
- ``scanline`` (``csrc/scanline.cpp``): the scanline z-buffer renderer of
  ``mesh3d.scanline``; C++, built by ``$CXX``, else ``c++``, else ``g++``.
  ``-ffp-contract=off`` keeps the compiler from fusing its double-precision
  barycentrics into multiply-adds on a host that has them, so every host
  computes the same bits.

``ctypes.CDLL`` releases the interpreter lock for the length of each call,
so decoding threads do not stall the thread that drives the card.

There is no fallback: a failed build raises with the compiler's output.
Nothing here runs at import. These libraries are host code and apart from
``kernels.KERNELS`` and ``kernels.build_all``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np

from topo4d_tpu_torch.kernels import BUILD_DIR, CSRC

P = ctypes.c_void_p
I64 = ctypes.c_int64
I32 = ctypes.c_int32
F32P = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


class HostLibrary(NamedTuple):
    source: str  # file under csrc/
    compilers: Sequence[str]  # environment variable first, then names on PATH
    flags: Sequence[str]
    functions: Dict[str, tuple]  # C symbol -> (argtypes, restype)
    init: Optional[str] = None  # a void(void) function called once after loading


LIBRARIES: Dict[str, HostLibrary] = {
    "imgdec": HostLibrary(
        source="imgdec.c",
        compilers=("$CC", "cc", "gcc"),
        flags=("-O2", "-std=c99", "-shared", "-fPIC"),
        functions={
            "png_unfilter": ([P, I64, I64, I32, P], ctypes.c_int),
            "jpeg_info": ([P, I64, P, P, I64], ctypes.c_int),
            "jpeg_decode": ([P, I64, P, P, I64], ctypes.c_int),
        },
        init="imgdec_init",
    ),
    "scanline": HostLibrary(
        source="scanline.cpp",
        compilers=("$CXX", "c++", "g++"),
        flags=("-O3", "-shared", "-fPIC", "-ffp-contract=off"),
        functions={
            "render_colors": ([F32P, I32, I32P, I32, F32P, I32, I32, I32, F32P], None),
            "rasterize_triangles": ([F32P, I32, I32P, I32, I32, I32, F32P, I32P, F32P], None),
            "vertex_normals": ([F32P, I32, I32P, I32, F32P], None),
            "render_texture": (
                [F32P, I32, I32P, I32, F32P, I32, I32, I32, F32P, I32P, I32, I32, I32, F32P], None
            ),
        },
    ),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _compiler(spec: HostLibrary) -> str:
    for name in spec.compilers:
        name = os.environ.get(name[1:]) if name.startswith("$") else name
        path = name and shutil.which(name)
        if path:
            return path
    raise RuntimeError(f"no host compiler for {spec.source} found (looked for {', '.join(spec.compilers)} on PATH)")


def lib_path(name: str = "imgdec") -> Path:
    spec = LIBRARIES[name]
    text = (CSRC / spec.source).read_bytes()
    digest = hashlib.sha256(text + " ".join(spec.flags).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{Path(spec.source).stem}-{digest}.so"


def build(name: str = "imgdec") -> Path:
    """Compile library ``name`` if it is missing -> its path. Raises
    RuntimeError with the compiler's output if the build fails."""
    spec = LIBRARIES[name]
    out = lib_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = _compiler(spec)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([cc, *spec.flags, "-o", tmp, str(CSRC / spec.source)], capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"host library build failed ({cc} {' '.join(spec.flags)} {spec.source}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent builder sees a whole file
    return out


def library(name: str = "imgdec") -> ctypes.CDLL:
    """The loaded library ``name``, built at its first call (thread-safe)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            spec = LIBRARIES[name]
            lib = ctypes.CDLL(str(build(name)))
            for symbol, (argtypes, restype) in spec.functions.items():
                fn = getattr(lib, symbol)
                fn.argtypes = argtypes
                fn.restype = restype
            if spec.init is not None:
                init = getattr(lib, spec.init)
                init.argtypes = []
                init.restype = None
                init()
            _loaded[name] = lib
        return lib
