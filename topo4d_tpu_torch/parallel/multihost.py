"""Multi-process start-up and host-0 gating (``parallel/multihost.py``).

The JAX package scales one program over N hosts with
``jax.distributed.initialize``; here each rank is a process with one card,
joined by ``torch.distributed``. Every rank runs the same fit; only rank 0
(host 0) writes to disk and prints the per-frame lines.

Launch with ``torchrun --nproc_per_node=N -m topo4d_tpu_torch ...`` (its
variables feed ``init_method="env://"``), or with the JAX launch variables
``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``
(``init_method="tcp://..."``).
The backend is NCCL when the ranks' device is CUDA and gloo on the CPU;
``backend=`` names another (gloo on the card, for ranks that share one
card, where NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from topo4d_tpu_torch.device import resolve_device


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    auto: Optional[bool] = None,
    device="cuda",
    backend: Optional[str] = None,
) -> bool:
    """Join the process group when a multi-process launch is configured ->
    whether this process is one of several.

    Three modes, in precedence order (``multihost.py:19``):

    1. explicit arguments, or ``JAX_COORDINATOR_ADDRESS`` with
       ``JAX_NUM_PROCESSES`` > 1 (and ``JAX_PROCESS_ID``): a TCP rendezvous
       at that address;
    2. ``auto=True``, ``TOPO4D_MULTIHOST=auto`` or a ``WORLD_SIZE`` above 1
       (as ``torchrun`` sets it): ``init_method="env://"``, fed by the
       variables ``torchrun`` sets; a failure raises
       ``RuntimeError``, never falls back to a single process (which would
       make every rank believe it is host 0);
    3. neither: a no-op that returns False.

    A second call is a no-op. ``device`` is the ranks' device: a bare
    "cuda" pins this rank to ``cuda:<LOCAL_RANK>`` (the process id when
    ``LOCAL_RANK`` is unset) and raises when that card does not exist; an
    explicit ``cuda:<i>`` or "cpu" is taken as given. The pinned device is
    ``rank_device()``.
    """
    if getattr(initialize_multihost, "_done", False):
        return getattr(initialize_multihost, "_distributed", False)
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if auto is None:
        auto = os.environ.get("TOPO4D_MULTIHOST", "").lower() == "auto"
        auto = auto or int(os.environ.get("WORLD_SIZE", "1")) > 1
    distributed = False
    if coordinator_address is not None and (num_processes or 0) > 1:
        if process_id is None:
            raise ValueError("a multi-process launch at JAX_COORDINATOR_ADDRESS needs the process id (JAX_PROCESS_ID)")
        dev = _pin_device(device, process_id)
        _init(backend, dev, init_method=f"tcp://{coordinator_address}", world_size=num_processes, rank=process_id)
        distributed = True
    elif auto:
        rank = int(os.environ.get("RANK", "0"))
        dev = _pin_device(device, rank)
        try:
            _init(backend, dev, init_method="env://")
        except Exception as exc:
            raise RuntimeError(
                "a multi-process launch was requested (TOPO4D_MULTIHOST=auto or WORLD_SIZE > 1) but "
                f"torch.distributed's env:// rendezvous failed (not launched by torchrun?): {exc}"
            ) from exc
        distributed = dist.get_world_size() > 1
    initialize_multihost._done = True
    initialize_multihost._distributed = distributed
    return distributed


def _pin_device(device, process_id: int) -> torch.device:
    """This rank's device: ``cuda:<LOCAL_RANK or process_id>`` for a bare
    "cuda", checked against the cards present; else ``device`` as given."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        index = int(os.environ.get("LOCAL_RANK", process_id))
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {process_id} would take cuda:{index}, but this host has {torch.cuda.device_count()} "
                "card(s): launch at most one rank per card, or pass an explicit device"
            )
        dev = torch.device("cuda", index)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    initialize_multihost._device = dev
    return dev


def _init(backend: Optional[str], dev: torch.device, **kwargs) -> None:
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend=backend, **kwargs)
    print(
        f"[topo4d_tpu_torch] rank {dist.get_rank()} of {dist.get_world_size()}: backend {backend}, device {dev}",
        flush=True,
    )


def free_port() -> int:
    """A TCP port on localhost that is free now, for a rendezvous of ranks
    spawned on this host."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_device(default="cuda") -> torch.device:
    """The device ``initialize_multihost`` pinned this rank to, else
    ``default`` (resolved: no card raises)."""
    dev = getattr(initialize_multihost, "_device", None)
    return dev if dev is not None else resolve_device(default)


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_host0() -> bool:
    """Whether this process owns disk IO, logging and checkpoints."""
    return process_index() == 0


def host0_print(*args, **kwargs) -> None:
    if is_host0():
        print(*args, **kwargs)
