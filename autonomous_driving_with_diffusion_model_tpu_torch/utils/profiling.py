"""Tracing of the port: host spans, device spans inside its CUDA graphs, and
counters, kept in memory and read as plain data (the counterpart of the
JAX package's ``utils/profiling.py``).

Tracing is on while a ``torch.profiler`` session runs or after
:func:`enable`; otherwise it is off, and a span costs one flag check and
returns a shared no-op context: nothing is allocated or recorded.

* :func:`span` ``(name, request=None, **attrs)``: a host span. It records
  its name, its start and end on the host clock (``time.perf_counter_ns``),
  its parent (the innermost span open on its thread) and its request (given,
  or its parent's), into a ring of the last :data:`RING_SPANS` spans. It
  also opens ``torch.profiler.record_function(name)``, so that the span sits
  in the profiler's trace on the clock of the device's events.
* :class:`GraphSpans`: the device spans of one captured CUDA graph. While
  :func:`capture` holds it, each :func:`mark` in the captured code launches
  a marker (``ops/csrc/span_stamp.cu``): a one-thread kernel that writes the
  device's ns timer into a ring of the graph's replays in device memory,
  whose slot a counter on the device, bumped by the last marker
  (:func:`mark_end`), picks. The span between two markers is named by the
  first. The markers are part of the graph whether tracing is on or off;
  nothing is read back while it replays. At capture each marker also counts
  the kernel nodes captured so far, which gives each span's kernels. After
  each replay the program calls :meth:`GraphSpans.replayed`, which, while
  tracing is on, records which request the replay served.
* :func:`count` ``(name, n=1, seconds=0.0)``: a counter, on or off, for rare
  events (a graph's capture and its seconds, a new weights generation).
* :func:`report` returns the spans, each traced replay's device spans (ms,
  summed by name), the captured graphs with their kernels per span, and the
  counters, as plain data; :func:`reset` clears them.
* ``trace(log_dir)``: a ``torch.profiler`` trace of the host and the card,
  written as a Chrome trace (``trace.json``) that TensorBoard or Perfetto
  opens (the trainer's ``--profile-dir``); the program's spans are in it.
"""

from __future__ import annotations

import contextlib
import ctypes
import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["trace", "enable", "on", "span", "current_request", "count", "GraphSpans", "capture", "mark",
           "mark_end", "report", "reset", "RING_SPANS", "RING_REPLAYS", "DEVICE_SLOTS"]

RING_SPANS = 8192  # host spans kept
RING_REPLAYS = 8192  # traced replays kept
DEVICE_SLOTS = 1024  # replays a graph's device ring holds
RING_GRAPHS = 64  # captured graphs kept
STAMP_SOURCE = "span_stamp.cu"

_enabled = False
_ids = itertools.count()
_local = threading.local()  # .stack: the spans open on this thread; .capture: the GraphSpans being captured


class _Store:
    def __init__(self):
        self.lock = threading.Lock()
        self.spans: deque = deque(maxlen=RING_SPANS)
        self.replays: deque = deque(maxlen=RING_REPLAYS)  # (GraphSpans, replay index, request)
        self.graphs: deque = deque(maxlen=RING_GRAPHS)
        self.counters: Dict[str, List] = {}


_store = _Store()


def enable(value: bool = True) -> None:
    """Turn tracing on (or off again) without a profiler session."""
    global _enabled
    _enabled = bool(value)


def on() -> bool:
    """Whether tracing is on: after :func:`enable`, or while a profiler runs."""
    return _enabled or _autograd_profiler._is_profiler_enabled


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _NoSpan:
    """The span of tracing off: shared, does nothing, reads as false."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs) -> None:
        pass


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("id", "parent", "request", "name", "attrs", "start", "_range")

    def __init__(self, name: str, request, attrs: dict):
        self.name, self.request, self.attrs = name, request, attrs

    def set(self, **attrs) -> None:
        """Add attributes to the span."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        if self.request is None and parent is not None:
            self.request = parent.request
        stack.append(self)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self._range.__exit__(*exc)
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        _store.spans.append((self.id, self.parent, self.request, self.name, self.start, end,
                             threading.get_ident(), self.attrs))
        return False


def span(name: str, request=None, **attrs):
    """A host span named ``name`` (a context manager); ``request`` defaults
    to the parent span's. Off, the shared no-op."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return _NO_SPAN
    return _Span(name, request, attrs)


def current_request():
    """The request of the innermost span open on this thread, or None."""
    stack = getattr(_local, "stack", None)
    return stack[-1].request if stack else None


def count(name: str, n: int = 1, seconds: float = 0.0) -> None:
    """Add ``n`` events and their ``seconds`` to the counter ``name``."""
    with _store.lock:
        c = _store.counters.setdefault(name, [0, 0.0])
        c[0] += n
        c[1] += seconds


def _mark_kernel(graph: "GraphSpans", index: int, last: bool, count_nodes: bool) -> int:
    """Launch marker ``index`` of ``graph`` on the current stream; the kernel
    nodes captured so far where ``count_nodes`` (-1 outside a capture)."""
    from ..ops.build import library

    nodes = ctypes.c_longlong(-1)
    device = graph.ring.device
    with torch.cuda.device(device):
        err = library(STAMP_SOURCE).adm_span_mark(
            graph.ring.data_ptr(), graph.counter.data_ptr(), DEVICE_SLOTS, graph.capacity, index, int(last),
            ctypes.addressof(nodes) if count_nodes else None, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"the span marker of {graph.name} failed (CUDA error {err})")
    return nodes.value


class GraphSpans:
    """The device spans of one CUDA graph of the program ``name``, with at
    most ``capacity`` markers, on ``device`` (a CUDA device).

    Made before the capture, it holds the device ring (:data:`DEVICE_SLOTS`
    replays of ``capacity`` int64 stamps) and the replay counter, and
    launches one marker outside the capture, so that the marker's module is
    loaded before it. Inside :func:`capture`, :func:`mark` places the
    markers; :meth:`close` after the capture checks that the last one was
    :func:`mark_end` and keeps the graph for :func:`report`."""

    def __init__(self, name: str, device, capacity: int):
        self.name = name
        self.id = next(_ids)
        self.capacity = int(capacity)
        self.ring = torch.zeros((DEVICE_SLOTS, self.capacity), dtype=torch.int64, device=device)
        self.counter = torch.zeros((1,), dtype=torch.int64, device=device)
        self.names: List[Optional[str]] = []  # the span each marker starts; None: the last marker
        self.nodes: List[int] = []  # kernel nodes captured up to each marker, the marker's own included
        self.attrs: dict = {}
        self.replays = 0
        _mark_kernel(self, 0, False, False)  # replay 0 writes this slot again

    def mark(self, name: Optional[str], attrs: dict) -> None:
        if self.names and self.names[-1] is None:
            raise RuntimeError(f"{self.name}: a marker after the last one")
        if len(self.names) >= self.capacity:
            raise RuntimeError(f"{self.name}: more than {self.capacity} span markers in one graph")
        self.nodes.append(_mark_kernel(self, len(self.names), name is None, True))
        self.names.append(name)
        self.attrs.update(attrs)

    def close(self) -> None:
        if not self.names or self.names[-1] is not None:
            raise RuntimeError(f"{self.name}: the captured graph's markers do not end with mark_end()")
        with _store.lock:
            _store.graphs.append(self)

    def kernels(self) -> Optional[Dict[str, int]]:
        """Kernel nodes of each span (summed by name), the markers left out;
        None where the capture could not count them."""
        if any(n < 0 for n in self.nodes):
            return None
        out: Dict[str, int] = {}
        for name, a, b in zip(self.names, self.nodes, self.nodes[1:]):
            out[name] = out.get(name, 0) + b - a - 1
        return out

    def replayed(self) -> None:
        """After a replay: count it, and while tracing is on record the
        request it served. Call it after every replay of the graph: the
        host's count is what maps a replay to its slot of the ring."""
        index = self.replays
        self.replays += 1
        if _enabled or _autograd_profiler._is_profiler_enabled:
            _store.replays.append((self, index, current_request()))

    def describe(self) -> dict:
        kernels = self.kernels()
        return {"id": self.id, "name": self.name, "markers": len(self.names),
                "spans": [n for n in self.names if n is not None], "kernels": kernels,
                "kernel_nodes": None if kernels is None else self.nodes[-1] - len(self.nodes),
                "attrs": dict(self.attrs)}


@contextlib.contextmanager
def capture(graph: Optional[GraphSpans]):
    """While inside, :func:`mark` on this thread places ``graph``'s markers
    (None: nowhere). Wrap the ``torch.cuda.graph`` capture in it."""
    previous = getattr(_local, "capture", None)
    _local.capture = graph
    try:
        yield graph
    finally:
        _local.capture = previous


def mark(name: str, **attrs) -> None:
    """Inside :func:`capture`: a marker where the device span ``name``
    starts (and the one before ends); ``attrs`` go to the graph. Elsewhere
    (eager code, the CPU) nothing."""
    graph = getattr(_local, "capture", None)
    if graph is not None:
        graph.mark(name, attrs)


def mark_end() -> None:
    """Inside :func:`capture`: the graph's last marker, which ends the last
    span and moves the ring to the next replay's slot."""
    graph = getattr(_local, "capture", None)
    if graph is not None:
        graph.mark(None, {})


def _device_spans(replays) -> List[dict]:
    """Each recorded replay still in its graph's ring: ms by span, and from
    the first marker to the last."""
    rings = {}
    out = []
    for graph, index, request in replays:
        if graph.id not in rings:
            torch.cuda.synchronize(graph.ring.device)
            rings[graph.id] = (graph.ring.cpu().numpy(), int(graph.counter.item()))
        ring, done = rings[graph.id]
        if not index < done <= index + DEVICE_SLOTS:
            continue  # not run yet, or written over by a later replay
        stamps = [int(t) for t in ring[index % DEVICE_SLOTS, :len(graph.names)]]
        spans: Dict[str, float] = {}
        for name, a, b in zip(graph.names, stamps, stamps[1:]):
            spans[name] = spans.get(name, 0.0) + (b - a) / 1e6
        out.append({"graph": graph.name, "graph_id": graph.id, "replay": index, "request": request,
                    "spans": spans, "replay_ms": (stamps[-1] - stamps[0]) / 1e6})
    return out


def report() -> dict:
    """The spans, the traced replays' device spans, the graphs and the
    counters, as plain data. Copies the device rings to the host (a
    synchronize): call it outside the loop it measures."""
    with _store.lock:
        spans, replays = list(_store.spans), list(_store.replays)
        graphs = {g.id: g for g in [*_store.graphs, *(r[0] for r in replays)]}
        counters = {k: {"count": c, "seconds": s} for k, (c, s) in _store.counters.items()}
    return {
        "spans": [{"id": i, "parent": p, "request": r, "name": n, "start_ns": s, "end_ns": e, "thread": t,
                   "attrs": dict(a)} for i, p, r, n, s, e, t, a in spans],
        "device_spans": _device_spans(replays),
        "graphs": [g.describe() for g in graphs.values()],
        "counters": counters,
    }


def reset() -> dict:
    """:func:`report`, then clear the spans, the replays, the graphs and
    the counters."""
    out = report()
    with _store.lock:
        _store.spans.clear()
        _store.replays.clear()
        _store.graphs.clear()
        _store.counters.clear()
    return out


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
