"""Build and load the host C library of ``csrc/imgdec.c`` (cc + ctypes).

The loader's image decoding (the PNG unfilter, the baseline JPEG decoder)
is plain C, compiled on first use by the host compiler (``cc``, else
``gcc``) with ``CC_FLAGS`` into ``<repo>/build/``, the library named by a
hash of its source and flags, as ``kernels.py`` names the CUDA kernels.
``ctypes.CDLL`` releases the interpreter lock for the length of each call,
so decoding threads do not stall the thread that drives the card.

There is no fallback: a failed build raises with the compiler's output.
Nothing here runs at import. This library is host code and apart from
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

from topo4d_tpu_torch.kernels import BUILD_DIR, CSRC

SOURCE = "imgdec.c"
CC_FLAGS = ["-O2", "-std=c99", "-shared", "-fPIC"]

P = ctypes.c_void_p
I64 = ctypes.c_int64
I32 = ctypes.c_int32

# C symbol -> argtypes; every function returns int
FUNCTIONS = {
    "png_unfilter": [P, I64, I64, I32, P],
    "jpeg_info": [P, I64, P, P, I64],
    "jpeg_decode": [P, I64, P, P, I64],
}

_lock = threading.Lock()
_lib = None


def _cc() -> str:
    for name in (os.environ.get("CC"), "cc", "gcc"):
        path = name and shutil.which(name)
        if path:
            return path
    raise RuntimeError("no host C compiler found (looked for $CC, cc and gcc on PATH)")


def lib_path() -> Path:
    text = (CSRC / SOURCE).read_bytes()
    digest = hashlib.sha256(text + " ".join(CC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{Path(SOURCE).stem}-{digest}.so"


def build() -> Path:
    """Compile the library if it is missing -> its path. Raises
    RuntimeError with the compiler's output if the build fails."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = _cc()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([cc, *CC_FLAGS, "-o", tmp, str(CSRC / SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"host library build failed ({cc} {' '.join(CC_FLAGS)} {SOURCE}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent builder sees a whole file
    return out


def library() -> ctypes.CDLL:
    """The loaded library, built at the first call (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in FUNCTIONS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.imgdec_init.argtypes = []
            lib.imgdec_init.restype = None
            lib.imgdec_init()
            _lib = lib
        return _lib
