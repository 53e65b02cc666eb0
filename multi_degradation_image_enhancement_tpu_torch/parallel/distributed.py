"""Multi-process bootstrap (counterpart of
``multi_degradation_image_enhancement_tpu/parallel/distributed.py``).

One process per GPU, launched by ``torchrun``::

    torchrun --nproc_per_node N -m multi_degradation_image_enhancement_tpu_torch.run \\
        -c cfg.json -p train

:func:`initialize` joins the process group once per process, before any
collective and before the process touches its card; :func:`is_primary` says
which process writes checkpoints, logs and outputs.  Importing this module
(or the package) starts no process group and creates no CUDA context.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value in (None, "") else int(value)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the default process group (idempotent).

    The explicit arguments win; otherwise torchrun's environment:
    ``MASTER_ADDR``/``MASTER_PORT`` (the rendezvous ``tcp://addr:port``),
    ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``.  ``coordinator_address`` is a
    ``host:port`` or a full init URL (``tcp://…``, ``file://…``).  The
    backend is ``backend`` if given, else ``nccl`` where CUDA is available
    and ``gloo`` on the CPU.  On CUDA the process takes card ``LOCAL_RANK``
    (``torch.cuda.set_device``) first; ``gloo`` ranks may share a card, and
    take ``LOCAL_RANK`` modulo the card count."""
    if dist.is_initialized():
        return
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    if world is None or rank is None:
        raise ValueError("initialize needs the world size and the rank: pass num_processes and "
                         "process_id, or launch with torchrun (WORLD_SIZE, RANK)")
    addr = coordinator_address
    if addr is None:
        host, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if not (host and port):
            raise ValueError("initialize needs a rendezvous: pass coordinator_address, or "
                             "launch with torchrun (MASTER_ADDR, MASTER_PORT)")
        addr = f"{host}:{port}"
    if "://" not in addr:
        addr = f"tcp://{addr}"
    cuda = torch.cuda.is_available()
    backend = backend or ("nccl" if cuda else "gloo")
    if cuda:
        local = _env_int("LOCAL_RANK")
        local = rank if local is None else local
        torch.cuda.set_device(local % torch.cuda.device_count() if backend == "gloo" else local)
    dist.init_process_group(backend, init_method=addr, world_size=int(world), rank=int(rank))


def launched_by_torchrun() -> bool:
    """True in a process that torchrun (or an equivalent launcher) started:
    its environment names a world size and a rank."""
    return _env_int("WORLD_SIZE") is not None and _env_int("RANK") is not None


def is_primary() -> bool:
    """True on the process that writes logs, checkpoints and outputs: rank 0,
    or the only process when no process group exists."""
    return not dist.is_initialized() or dist.get_rank() == 0


def world_size() -> int:
    """The process group's size (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def broadcast_from_primary(tensors) -> None:
    """Overwrite each tensor, in place, with rank 0's on every process of
    the group; nothing without one."""
    if dist.is_initialized():
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t.data, src=0)


def barrier() -> None:
    """Wait for every process of the group; nothing without one."""
    if dist.is_initialized():
        dist.barrier()
