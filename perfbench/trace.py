"""What the profiler's trace says about a stretch of work: the seconds in
which the device ran anything, device time by kernel name and by kind, the
kernels that took the most time, and the device's idle gaps by what the
host was doing in them.

:func:`profile` runs the work under ``torch.profiler`` and lists its events;
:func:`reduce_events` turns a list of events into the numbers, so that the
arithmetic runs on the CPU in the tests. The classes of kernel names are
``chip_smoke.py:device_breakdown``'s.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, NamedTuple

import numpy as np

__all__ = ["Event", "profile", "reduce_events", "kernel_kind"]

LIBRARY_MARKS = ("cudnn", "xmma", "gemm", "conv", "sm90", "fft", "pointwise_mult_and_sum_complex", "wgrad", "dgrad")


class Event(NamedTuple):
    device: bool  # ran on the device (a kernel, a copy, a fill), else a host-side span
    name: str
    start_us: float
    end_us: float


def kernel_kind(name: str) -> str:
    """The port's kernels, copies and fills, cuDNN and cuBLAS (their FFT,
    weight-gradient and data-gradient kernels too), or other."""
    if "gn_mish" in name:
        return "port_kernels"
    if "Memcpy" in name or "Memset" in name:
        return "memcpy/memset"
    if any(s in name for s in LIBRARY_MARKS):
        return "cudnn/cublas"
    return "other"


def profile(run: Callable[[], int], device) -> Dict:
    """``run()`` (which returns how many units of work it did) under the
    profiler, ending in a device synchronize; returns :func:`reduce_events`'
    numbers, ``units`` and the host clock's ``wall_s``."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize(device)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        units = run()
        torch.cuda.synchronize(device)
        wall_s = time.perf_counter() - t0
    events = []
    for ev in prof.events():
        on_device = getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA
        if on_device and getattr(ev, "is_user_annotation", False):
            continue  # a range marked on the device spans its kernels
        events.append(Event(on_device, ev.name, float(ev.time_range.start), float(ev.time_range.end)))
    out = reduce_events(events)
    out.update(units=units, wall_s=wall_s)
    return out


def _union(intervals: np.ndarray) -> np.ndarray:
    """Sorted, merged [start, end) rows of (n, 2) ``intervals``."""
    if len(intervals) == 0:
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    merged = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return np.asarray(merged)


def reduce_events(events: List[Event], top: int = 10) -> Dict:
    """``busy_s``: the union of the device events' intervals; ``by_name``
    and ``by_kind``: summed device seconds; ``device_ops``: the ``top``
    names by device seconds; ``idle_gaps``: the device's idle gaps between
    its first and its last event, summed by the host span that covers
    each gap's middle (the innermost, the one that started last), the
    ``top`` of them; ``device_events``: how many."""
    dev = [e for e in events if e.device and e.end_us > e.start_us]
    host = [e for e in events if not e.device and e.end_us > e.start_us]
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.end_us - e.start_us) / 1e6
    by_kind: Dict[str, float] = {}
    for name, s in by_name.items():
        by_kind[kernel_kind(name)] = by_kind.get(kernel_kind(name), 0.0) + s
    merged = _union(np.asarray([(e.start_us, e.end_us) for e in dev], dtype=np.float64).reshape(-1, 2))
    busy_s = float((merged[:, 1] - merged[:, 0]).sum()) / 1e6 if len(merged) else 0.0
    gaps: Dict[str, float] = {}
    if len(merged) > 1:
        starts = np.asarray([e.start_us for e in host])
        ends = np.asarray([e.end_us for e in host])
        names = [e.name for e in host]
        for g0, g1 in zip(merged[:-1, 1], merged[1:, 0]):
            mid = 0.5 * (g0 + g1)
            cover = np.flatnonzero((starts <= mid) & (ends >= mid)) if len(host) else []
            label = names[cover[np.argmax(starts[cover])]] if len(cover) else "no host span"
            gaps[label] = gaps.get(label, 0.0) + (g1 - g0) / 1e6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"busy_s": busy_s, "by_name": by_name, "by_kind": by_kind, "device_ops": rank(by_name),
            "idle_gaps": rank(gaps), "device_events": len(dev)}
