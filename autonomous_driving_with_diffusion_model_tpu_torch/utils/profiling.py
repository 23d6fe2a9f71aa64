"""Tracing for the trainer's ``--profile-dir`` (counterpart of the JAX
package's ``utils/profiling.py``, as far as the trainer uses it): a
``torch.profiler`` trace of the host and the card, written as a Chrome
trace (``trace.json``) that TensorBoard or Perfetto opens."""

from __future__ import annotations

import contextlib
import os

import torch

__all__ = ["trace"]


@contextlib.contextmanager
def trace(log_dir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
