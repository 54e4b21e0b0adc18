"""Coloured and textured OBJ writers (face3d mesh/io.py;
``topo4d_tpu/mesh3d/io.py``), host side, writing the JAX package's text
byte for byte.

One formatted block per section instead of face3d's per-line loop
(io.py:31-103). Faces are written in face3d's order, the indices reversed
(2, 1, 0) and 1-based; a textured OBJ gets a companion ``.mtl`` and a
texture PNG, written by ``utils/png.py`` (the card's machine has no PIL).
Tensors are accepted and copied to the host. Reading is
``topology.obj_io``'s.
"""

from __future__ import annotations

import os

import numpy as np

from topo4d_tpu_torch.utils.png import write_png


def _host(a) -> np.ndarray:
    """An array or a tensor on any device -> a NumPy array."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def _fmt_rows(prefix: str, arr) -> str:
    return "".join(prefix + " " + " ".join(repr(float(x)) for x in row) + "\n" for row in _host(arr))


def write_obj_with_colors(path: str, vertices, triangles, colors) -> None:
    """v lines carry xyz and rgb; f lines reversed and 1-based (io.py:31-59)."""
    if not path.endswith(".obj"):
        path += ".obj"
    tri = _host(triangles).astype(np.int64) + 1
    with open(path, "w") as f:
        f.write(_fmt_rows("v", np.concatenate([_host(vertices), _host(colors)], axis=1)))
        for a, b, c in tri:
            f.write(f"f {c} {b} {a}\n")


def write_obj_with_texture(path: str, vertices, triangles, texture, uv_coords) -> None:
    """The OBJ, its ``.mtl`` and the texture PNG; vt rows flipped in v; each
    f entry pairs v and vt of the same (reversed, 1-based) index
    (io.py:62-103)."""
    if not path.endswith(".obj"):
        path += ".obj"
    mtl_path = path[:-4] + ".mtl"
    tex_path = path[:-4] + "_texture.png"
    tri = _host(triangles).astype(np.int64) + 1
    uv = _host(uv_coords).astype(np.float64)
    with open(path, "w") as f:
        f.write(f"mtllib {os.path.abspath(mtl_path)}\n")
        f.write(_fmt_rows("v", vertices))
        f.write(_fmt_rows("vt", np.stack([uv[:, 0], 1.0 - uv[:, 1]], axis=1)))
        f.write("usemtl FaceTexture\n")
        for a, b, c in tri:
            f.write(f"f {c}/{c} {b}/{b} {a}/{a}\n")
    with open(mtl_path, "w") as f:
        f.write("newmtl FaceTexture\n")
        f.write(f"map_Kd {os.path.abspath(tex_path)}\n")
    arr = _host(texture)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    write_png(tex_path, arr)


def write_asc(path: str, vertices) -> None:
    """A plain-text xyz dump (io.py:21-29)."""
    if not path.endswith(".asc"):
        path += ".asc"
    np.savetxt(path, _host(vertices))
