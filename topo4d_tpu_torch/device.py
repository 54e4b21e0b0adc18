"""Device selection: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no card exists.

    There is no silent fallback: a caller that wants the CPU passes
    ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "topo4d_tpu_torch: device 'cuda' requested but no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev
