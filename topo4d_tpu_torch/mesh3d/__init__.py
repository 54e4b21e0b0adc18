"""The face3d library surface (``topo4d_tpu/mesh3d/``), in PyTorch.

``transform``, ``light`` and ``bfm`` (the Basel Face Model layer and its
keypoint fit) are float32 functions on tensors that run on the device of
their tensors; ``io`` and ``vis`` are host helpers; ``scanline`` binds the
C++ scanline z-buffer renderer (``csrc/scanline.cpp``, built by the host
compiler at first use) and ``mesh_numpy`` is its pure-NumPy oracle. No part
of the fitting pipeline imports this package; the UV bake has its own
renderers (``texture/bake_tiled.py``, ``texture/bake.py``).
"""

from topo4d_tpu_torch.mesh3d import io, light, transform  # noqa: F401
from topo4d_tpu_torch.mesh3d.bfm import MorphableModel, fit_points, load_bfm  # noqa: F401
