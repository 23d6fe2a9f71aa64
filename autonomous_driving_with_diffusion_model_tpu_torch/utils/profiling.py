"""Profiling and tracing (counterpart of the JAX package's
``utils/profiling.py``):

* ``trace(log_dir)``: a ``torch.profiler`` trace of the host and the card,
  written as a Chrome trace (``trace.json``) that TensorBoard or Perfetto
  opens (the trainer's ``--profile-dir``);
* ``annotate(name)``: a named span in that trace
  (``torch.profiler.record_function``);
* ``device_timer``: wall-clock timing of a function on the device, per
  call or chained (one synchronization at the end, so the host's round
  trips do not count).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch

__all__ = ["trace", "annotate", "device_timer"]


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


def annotate(name: str):
    return torch.profiler.record_function(name)


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _tensors(v)


def _synchronize(out) -> None:
    """Wait for the cards that hold ``out``'s tensors; CPU tensors are ready."""
    for dev in {t.device for t in _tensors(out) if t.is_cuda}:
        torch.cuda.synchronize(dev)


def device_timer(
    fn: Callable,
    *args,
    iters: int = 20,
    warmup: int = 2,
    chain: Optional[Callable] = None,
    **kwargs,
):
    """Time a device function.

    Without ``chain``: each call synchronizes its output's device (the
    host's round trip included). With ``chain(prev_out, args) -> args``:
    sequentially dependent calls, synchronized once at the end, which
    measures the device's time. Returns (mean_ms, all samples or the total
    ms)."""
    out = fn(*args, **kwargs)
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    _synchronize(out)

    if chain is None:
        samples = []
        for _ in range(iters):
            t0 = time.perf_counter()
            _synchronize(fn(*args, **kwargs))
            samples.append((time.perf_counter() - t0) * 1000.0)
        return sum(samples) / len(samples), samples

    t0 = time.perf_counter()
    for _ in range(iters):
        args = chain(out, args)
        out = fn(*args, **kwargs)
    _synchronize(out)
    total = (time.perf_counter() - t0) * 1000.0
    return total / iters, total
