"""Data parallelism over the process group (counterpart of the JAX
package's ``parallel/mesh.py``).

The JAX package trains one SPMD program over a device mesh: the global
batch sharded over the ``data`` axis, the state replicated, XLA inserting
the gradient all-reduce. On the card the mesh becomes the process group:

* ``shard_global_batch`` -> each rank feeds its loader shard
  (``data/dataset.py:Loader``'s ``shard_index``/``shard_count``) and takes
  its rows of the global batch's draws (:func:`local_rows`);
* ``replicate_global`` -> the step's forward is wrapped in
  ``DistributedDataParallel`` (:func:`wrap_ddp`), which broadcasts rank 0's
  weights and averages the gradients, its all-reduce overlapping the
  backward;
* ``make_multislice_mesh`` has no counterpart: NCCL under torchrun spans
  nodes as it spans cards;
* BatchNorm under ``BN_MODE train`` takes its statistics over the global
  batch (``models/resnet.py:_bn``), as the JAX program does.

N ranks at ``TRAIN.BATCH_SIZE`` B each compute what one process computes on
the N x B global batch ordered rank by rank; under gradient accumulation
(G micro-batches) global micro-batch i is every rank's local micro-batch i,
rank by rank.
"""

from __future__ import annotations

import torch
from torch.nn.parallel import DistributedDataParallel

from .distributed import local_device, process_count, process_index

__all__ = ["data_parallel_size", "local_rows", "wrap_ddp"]


def data_parallel_size(cfg) -> int:
    """The ranks ``TPU.DATA_PARALLEL`` asks for: -1 (the JAX default, every
    device) means every rank of the process group; any other value must
    equal the group's size, since torchrun's ``--nproc_per_node`` sets it."""
    want, world = int(cfg.TPU.DATA_PARALLEL), process_count()
    if want not in (-1, world):
        raise ValueError(
            f"TPU.DATA_PARALLEL={want}, but {world} rank(s) are up: the port trains on every rank "
            f"torchrun starts (set --nproc_per_node {want}, or TPU.DATA_PARALLEL -1)")
    return world


def local_rows(local_batch: int, rank: int, world: int, groups: int = 1) -> torch.Tensor:
    """Indices of rank ``rank``'s rows in the global batch of ``world`` x
    ``local_batch`` rows, cut into ``groups`` micro-batches: global
    micro-batch i holds every rank's local micro-batch i, rank by rank (with
    one group: rank r holds rows r B .. (r + 1) B)."""
    if local_batch % groups:
        raise ValueError(f"batch {local_batch} does not split into {groups} micro-batches")
    mb = local_batch // groups
    return torch.cat([torch.arange(i * world * mb + rank * mb, i * world * mb + (rank + 1) * mb)
                      for i in range(groups)])


def wrap_ddp(state, cfg) -> None:
    """Wrap ``state``'s step forward in DistributedDataParallel (rank 0's
    weights broadcast to every rank). Every ``TRAIN.USE_COND`` variant
    gives every parameter a gradient, so the reducer needs no search for
    unused ones. The BatchNorm statistics are global already, so DDP does
    not broadcast the buffers. On a card the wrapper is built on a side
    stream, as a CUDA graph that holds its backward needs
    (``train/program.py``)."""
    from contextlib import nullcontext

    from ..train.state import StepForward

    dev = local_device(state.model.device)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    if side is not None:
        side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side) if side is not None else nullcontext():
        state.ddp = DistributedDataParallel(
            StepForward(state.model, bool(cfg.TPU.REMAT)),
            device_ids=[dev.index] if dev.type == "cuda" else None,
            broadcast_buffers=False,
        )
    if side is not None:
        torch.cuda.current_stream(dev).wait_stream(side)
    state.rank, state.world = process_index(), process_count()
