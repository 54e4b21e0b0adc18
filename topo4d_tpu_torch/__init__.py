"""PyTorch + CUDA port of ``topo4d_tpu``: parity-mode and batched all-views
geometry tracking, the dense texture phase, the per-frame export through
``Trainer.run``, and the command line (``python -m topo4d_tpu_torch``) on a
capture in the reference's disk layout, with its face-parsing masks,
progress renders and the tiled and oracle renderers; on several cards
(``torchrun --nproc_per_node=N -m topo4d_tpu_torch``) the batched steps
shard their views and the dense renders their tiles over the ranks.

The JAX package beside this one is the reference; this package mirrors its
layout (``core/``, ``rasterizer/``, ``losses/``, ``opt/``, ``parallel/``,
``topology/``, ``texture/``, ``pipeline/``) and keeps its public layouts (images (C, H, W), packed
entries (16, E_pad), one-ring tables (K, N)) so that tests compare like with
like. It imports neither JAX nor the JAX package.

Device rule: every entry point takes ``device`` and defaults to ``"cuda"``;
it raises when no card is present and never falls back to the CPU. The tile
blend (K1/K2, or K4f/K4b under ``variant="v3"``), the SSIM blur and the UV
bake run the hand-written CUDA kernels (``csrc/``) on CUDA tensors and their
plain PyTorch versions only on CPU tensors. The tiled and oracle renderers
are plain PyTorch on whichever device the caller picks. Host IO (XML, PNG,
pickle) is NumPy.

Contract paths run in float32 with TF32 off (cuBLAS and cuDNN).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
