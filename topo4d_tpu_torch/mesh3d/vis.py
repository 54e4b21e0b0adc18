"""Mesh visualisation (face3d mesh/vis.py; ``topo4d_tpu/mesh3d/vis.py``).

``plot_mesh`` draws a triangle mesh as a trisurf on a matplotlib 3-D axis.
matplotlib is imported inside the call, so nothing else needs it (the
card's machine may not have it); the caller saves or shows the figure.
"""

from __future__ import annotations

import numpy as np


def plot_mesh(
    vertices,  # (V, 3), an array or a tensor on any device
    triangles,  # (F, 3) int
    subplot=(1, 1, 1),
    title: str = "mesh",
    el: float = 90.0,
    az: float = -90.0,
    lwdt: float = 0.1,
    color: str = "grey",
    ax=None,
):
    """Trisurf plot of a triangle mesh -> the 3-D axis.

    face3d's view (elevation 90, azimuth -90: frontal), axes off, line width
    and colour as given; an existing 3-D ``ax`` may be passed instead of
    face3d's implicit pyplot state, and ``ax.dist``, which matplotlib 3.7
    removed, is not set.
    """
    import matplotlib.pyplot as plt

    def host(a, dtype):
        return (a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)).astype(dtype)

    v = host(vertices, np.float64)
    tris = host(triangles, np.int64)
    if ax is None:
        ax = plt.subplot(*subplot, projection="3d")
    ax.plot_trisurf(v[:, 0], v[:, 1], v[:, 2], triangles=tris, lw=lwdt, color=color, alpha=1)
    ax.axis("off")
    ax.view_init(elev=el, azim=az)
    ax.set_title(title)
    return ax
