"""Process-group set-up for data-parallel training (counterpart of the JAX
package's ``parallel/distributed.py``).

The JAX package scales past one host with ``jax.distributed``: every host
runs the same ``train.py`` and feeds its local shard (reference:
``accelerate launch --multi_gpu``). The port's counterpart is
``torch.distributed`` under ``torchrun``: one process per card, each reading
torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``, NCCL between cards and gloo on the CPU. Without those
variables (or arguments) nothing is initialized and the program stays one
process.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Union

import torch
import torch.distributed as dist

TIMEOUT = timedelta(minutes=10)  # a collective that waits longer fails, rather than hang

__all__ = [
    "initialize_distributed",
    "local_batch_slice",
    "is_main_process",
    "process_index",
    "process_count",
    "local_device",
]


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def initialize_distributed(
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    local_rank: Optional[int] = None,
    master_addr: Optional[str] = None,
    master_port: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
    backend: Optional[str] = None,
) -> bool:
    """Join the process group from the arguments, or from torchrun's
    variables where an argument is None. Nothing happens when neither gives
    a world size (one process, as without torchrun) or when a group is up
    already. ``backend`` None: NCCL when ``device`` is CUDA, else gloo. On
    CUDA the process's card is ``LOCAL_RANK``. Returns whether more than
    one process is up."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    world_size = world_size if world_size is not None else _int_env("WORLD_SIZE")
    if world_size is None:
        return False
    rank = rank if rank is not None else (_int_env("RANK") or 0)
    local_rank = local_rank if local_rank is not None else (_int_env("LOCAL_RANK") or 0)
    master_addr = master_addr or os.environ.get("MASTER_ADDR", "localhost")
    master_port = master_port if master_port is not None else _int_env("MASTER_PORT")
    if master_port is None:
        raise ValueError("initialize_distributed needs MASTER_PORT (or master_port=)")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(local_rank)
    backend = backend or ("nccl" if cuda else "gloo")
    if backend == "nccl":
        # the train program captures DDP's all-reduce in a CUDA graph, which
        # NCCL's asynchronous error handling does not allow; without it the
        # watchdog does not abort the ranks that wait on one that failed
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{master_addr}:{master_port}",
        rank=rank,
        world_size=world_size,
        timeout=TIMEOUT,
    )
    return world_size > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank 0's guard for side effects: logs, evaluation, checkpoints."""
    return process_index() == 0


def local_batch_slice(global_batch: int) -> slice:
    """This process's contiguous slice of the global batch."""
    per = global_batch // process_count()
    start = process_index() * per
    return slice(start, start + per)


def local_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` with the process's card made explicit (``cuda`` ->
    ``cuda:<current>``), as DistributedDataParallel needs it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev
