"""Data-parallel training (counterpart of the JAX package's ``parallel/``)."""

from .ddp import data_parallel_size, local_rows, wrap_ddp
from .distributed import (
    initialize_distributed,
    is_main_process,
    local_batch_slice,
    local_device,
    process_count,
    process_index,
)

__all__ = [
    "initialize_distributed",
    "local_batch_slice",
    "local_device",
    "is_main_process",
    "process_index",
    "process_count",
    "data_parallel_size",
    "local_rows",
    "wrap_ddp",
]
