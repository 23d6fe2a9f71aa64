"""The port's CUDA-graph programs: what replaces the JAX package's
``jax.jit`` calls. Their owners are the plan (``driving/program.py``), the
train and distill steps and the scorer's fit (``train/program.py``) and the
augmentation (``data/augment.py``).

An owner (a :class:`Programs`) holds one :class:`Program` per key: its fixed
input buffers and, on a CUDA device, its graph. A key's build is

* the warm run (:meth:`Programs.warm`): the body run eagerly on the owner's
  side stream, which builds what the body builds at first use (the kernel
  packs of ``models/blocks.py``, the kernels' library, cuDNN's plans,
  AdamW's moments), synchronized and timed;
* the capture (:meth:`Programs.capture`): the body captured with
  ``torch.cuda.graph`` into a private memory pool, in the ``thread_local``
  capture mode (so a pipelined agent's worker thread can capture while the
  main thread works on), its device-span markers into the owner's
  ``profiling.GraphSpans``. The capture runs nothing. A capture that fails
  raises ``RuntimeError`` naming the key; nothing falls back to the eager
  body. It counts ``captures.<name>`` with the seconds of the warm run and
  of the capture.

Every later call of the key replays the graph (:meth:`Programs.replay`).

The kernels' launch counts (``ops/kernels.py``) are host counters that the
wrappers add to where they launch, which a replay does not call. A call
counts the launches of one run of its body: the capture's launches are
recorded and taken back out (``kernels.recorded_launches``), and every
replay adds them. A warm run counts as a call where the owner says so (a
training step's first step is a real step) and not otherwise (a plan's
first call counts its replay).

A graph bakes in the pointers it was captured on, and a replay writes in
place without bumping autograd's ``_version`` counters. So the replay bumps
the ``_version`` of what the graph writes
(``torch.autograd.graph.increment_version``), and an owner follows the
tensors its graphs read by :func:`tensors_key` (``data_ptr`` and
``_version`` of each): when that key moves (a ``load_state_dict``, a resume,
an EMA copy), :meth:`Programs.follow` drops every program and counts a new
generation, which the owner's keys carry. An old graph is never replayed on
tensors it was not captured on. An owner that follows every parameter and
buffer of some modules keys them through a :class:`ModuleTensors`, which
walks the modules only when their structure may have changed.

On the CPU only the keys and the buffers run: the owners call their bodies
on the same buffers.
"""

from __future__ import annotations

import contextlib
import itertools
import operator
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.nn.modules import module as _module

from ..utils import profiling
from . import kernels

__all__ = ["ModuleTensors", "Program", "Programs", "tensors_key"]


_version_of = operator.attrgetter("_version")


def tensors_key(tensors: List[torch.Tensor]) -> Tuple:
    """The ``data_ptr`` and the ``_version`` of each tensor, in order: the key
    changes when any of them is written in place (outside a replay) or
    replaced, or its ``data`` is set (``param.data = x``, ``Module.to``)."""
    return tuple(map(torch.Tensor.data_ptr, tensors)), tuple(map(_version_of, tensors))


# The modules of every follower's trees, and a number for each parameter,
# buffer or submodule registered (set, replaced or set to None) into one of
# them: by ``register_*``, ``add_module`` or an attribute assignment,
# ``load_state_dict(assign=True)`` and a ``ModuleList``'s or
# ``Sequential``'s item assignment among them. Each such registration sets
# ``_registration`` to a number never used before; a registration into a
# module outside them (a module being built, a ``Sequential`` slice) leaves it.
_watched: "weakref.WeakSet[torch.nn.Module]" = weakref.WeakSet()
_registration_numbers = itertools.count(1)
_registration = 0


def _registered(module, *_) -> None:
    global _registration
    if module in _watched:
        _registration = next(_registration_numbers)


for _register in (_module.register_module_parameter_registration_hook,
                  _module.register_module_buffer_registration_hook,
                  _module.register_module_module_registration_hook):
    _register(_registered)


class ModuleTensors:
    """Every parameter and buffer of the module trees ``modules``, followed
    without walking the trees on every call.

    A walk (:meth:`walk`) lists each module of the trees once and the slot
    of each parameter and buffer (its module's ``_parameters`` or
    ``_buffers`` and its name), the parameters first. :meth:`key` is
    :func:`tensors_key` of the tensors read from those slots at the call, so
    a tensor put into its slot by any path is keyed, the buffers that
    ``Module.to`` replaces without a registration among them. It walks
    first where the structure may have changed since the last walk: a
    registration into a module of any follower's trees, another number of
    submodules in a walked module (a deletion, a ``ModuleList.insert``), or
    a slot gone (a parameter or buffer deleted). ``walks`` counts the walks,
    and so does the counter ``counter`` where given."""

    def __init__(self, modules, counter: Optional[str] = None):
        self.modules = list(modules)
        self.counter = counter
        self.walks = 0
        self._registration = -1
        self._children: List[dict] = []
        self._sizes: List[int] = []
        self._slot_dicts: List[dict] = []
        self._slot_names: List[str] = []

    def walk(self) -> None:
        """List the trees' modules' ``_modules`` and the tensors' slots."""
        self._registration = _registration
        mods = [m for top in self.modules for m in top.modules()]
        _watched.update(mods)
        self._children = [m._modules for m in mods]
        self._sizes = list(map(len, self._children))
        slots = [(d, name) for d in (*(m._parameters for m in mods), *(m._buffers for m in mods))
                 for name, t in d.items() if t is not None]
        self._slot_dicts, self._slot_names = [d for d, _ in slots], [name for _, name in slots]
        self.walks += 1
        if self.counter is not None:
            profiling.count(self.counter)

    def key(self) -> Tuple:
        """:func:`tensors_key` of every parameter and buffer, walking first
        where the structure may have changed."""
        if self._registration != _registration or list(map(len, self._children)) != self._sizes:
            self.walk()
        try:
            tensors = list(map(operator.getitem, self._slot_dicts, self._slot_names))
        except KeyError:  # a parameter or buffer deleted
            self.walk()
            tensors = list(map(operator.getitem, self._slot_dicts, self._slot_names))
        return tensors_key(tensors)


class Program:
    """One key's program: the owner's input buffers and, once captured, the
    graph, what the body returned in the capture (each replay writes it
    again), the launches it recorded and its device spans (or None); the
    eager runs its key takes before the capture (``warm_steps``, of which
    ``warm_left`` are still to run), what the owner keeps alive beside the
    graph, and the seconds of the last warm run and of the capture (host
    clock, each ending in a synchronize)."""

    def __init__(self, inputs, warm_steps: int = 1):
        self.inputs = inputs
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None
        self.launches: Dict[str, int] = {}
        self.spans: Optional[profiling.GraphSpans] = None
        self.warm_steps = self.warm_left = warm_steps
        self.keep: list = []
        self.warm_s = self.capture_s = 0.0


class Programs:
    """An owner's programs on ``device``: ``programs`` by key, ``key`` the
    last call's, ``generation`` that of the tensors it follows (-1 before
    the first), and the side stream its builds run on."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.programs: Dict[Tuple, Program] = {}
        self.key: Optional[Tuple] = None
        self.generation = -1
        self._followed: Optional[Tuple] = None
        self._stream: Optional[torch.cuda.Stream] = None

    def follow(self, key: Tuple) -> bool:
        """Where ``key`` (the :func:`tensors_key` of what the graphs read) is
        not the one followed: drop every program, whose graphs hold the old
        tensors, and start the next generation; True then."""
        if key == self._followed:
            return False
        self.programs.clear()
        self._followed, self.generation = key, self.generation + 1
        return True

    def settle(self, key: Tuple) -> None:
        """Follow ``key`` in the same generation: what the owner's own step
        wrote, eagerly or by a replay."""
        self._followed = key

    def captured(self) -> Optional[Program]:
        """The last call's key's program, once it holds a graph."""
        prog = self.programs.get(self.key)
        return prog if prog is not None and prog.graph is not None else None

    def warm(self, prog: Program, run: Callable, counted: bool = True):
        """``run()`` eagerly on the side stream, synchronized: a warm run of
        ``prog``, its seconds into ``prog.warm_s``; its launches count as a
        call's where ``counted``. Returns what ``run`` returns."""
        t0 = time.perf_counter()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with contextlib.nullcontext() if counted else kernels.recorded_launches():
            with torch.cuda.stream(self._stream):
                out = run()
            current.wait_stream(self._stream)
        torch.cuda.synchronize(self.device)
        prog.warm_s = time.perf_counter() - t0
        prog.warm_left -= 1
        return out

    def capture(self, prog: Program, body: Callable, what: str, name: Optional[str] = None,
                markers: int = 0) -> None:
        """Capture ``body`` (after a warm run) into ``prog``: its graph, its
        outputs and the launches it recorded. ``what`` names the program and
        its key in the error of a failed capture, which also drops the key.
        ``name``: the graph's device spans, of at most ``markers`` markers,
        and the counter ``captures.<name>`` (None: neither)."""
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        spans = profiling.GraphSpans(name, self.device, markers) if name is not None else None
        graph = torch.cuda.CUDAGraph()
        try:
            with kernels.recorded_launches() as launches, profiling.capture(spans), torch.cuda.graph(
                    graph, stream=self._stream, capture_error_mode="thread_local"):
                outputs = body()
            if spans is not None:
                spans.close()
        except RuntimeError as e:
            self.programs.pop(self.key, None)
            raise RuntimeError(f"capturing {what} as a CUDA graph failed: {e}") from e
        torch.cuda.synchronize(self.device)
        prog.graph, prog.outputs, prog.launches, prog.spans = graph, outputs, launches, spans
        prog.capture_s = time.perf_counter() - t0
        if name is not None:
            profiling.count(f"captures.{name}", 1, prog.warm_s + prog.capture_s)

    @staticmethod
    def replay(prog: Program, writes=(), times: int = 1):
        """Replay ``prog``'s graph ``times`` times, each adding its launches
        to the counts and counting a replay of its device spans, then bump
        the ``_version`` of ``writes``, what the graph writes in place.
        Returns the capture's outputs, which the next replay writes again."""
        for _ in range(times):
            prog.graph.replay()
            kernels.add_launch_counts(prog.launches)
            if prog.spans is not None:
                prog.spans.replayed()
        if writes:
            torch.autograd.graph.increment_version(writes)
        return prog.outputs
