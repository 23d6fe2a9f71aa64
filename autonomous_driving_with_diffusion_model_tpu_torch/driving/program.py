"""The plan as one program on the card (the counterpart of the JAX
planner's ``self._plan = jax.jit(_plan)``, JAX ``driving/plan.py:186``).

:class:`PlanProgram` runs the planner's body (``DiffusionPlanner._plan``:
normalize, encode once, denoise K hypotheses, score, argmin) on fixed input
buffers: the uint8 frame (H, W, 3), the target (1, 2), the init
trajectories (K, horizon, D) and, where the sampler needs it, the step noise
(S, K, horizon, D). A plan copies its inputs into them with ``copy_``, runs
the program of its key and returns copies of (trajs, best) on the device,
so that a later plan cannot overwrite a handle that was not fetched yet.

On a CUDA device the program is a CUDA graph, so one plan is one replay,
with no Python between its ~10,000 launches:

* the body runs once eagerly on a side stream, which builds what it builds
  at first use (the kernel packs of ``models/blocks.py``, the kernels'
  library, cuDNN's plans, the classifier guidance's autograd), then is
  captured with ``torch.cuda.graph`` into a private memory pool, and every
  plan of that key replays it. A graph unrolls the whole denoising loop, so
  the JAX package's ``TPU.SCAN_UNROLL`` has nothing to set here;
* the key is the frame's shape, K, the step noise's shape, the compute
  dtype and the weights: ``data_ptr`` and ``_version`` of every parameter
  and buffer of the planner's modules. A capture bakes in the pointers of
  the cached kernel packs, so weights that change after a capture
  (``load_state_dict``, an EMA copy) drop every program of the old weights
  and the next plan captures anew: an old graph is never replayed. The key
  counts the weights by their generation (0, 1, ...);
* a capture that fails raises ``RuntimeError`` naming the key. Nothing falls
  back to the eager loop; the eager body stays callable as the planner's
  ``_plan``, the plain version the graph is held against;
* capture runs in the ``thread_local`` capture mode, so a pipelined agent's
  worker thread can capture while the main thread works on.

The kernels' launch counts (``ops/kernels.py``) are host counters that the
wrappers add to where they launch, which a replay does not call. The warm
run and the capture are the program's build: the counts are set back to
what they were before it, and the capture's count of each kernel is added
on every replay. So a plan counts the launches of its one replay, as it
counted its eager loop's before.

On the CPU the same object calls the body on the same buffers: only the
capture and the replay are CUDA's, and the buffers, keys and invalidation
run in the CPU tests.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..ops import kernels

__all__ = ["PlanProgram", "weights_key"]


def weights_key(modules) -> Tuple:
    """``(data_ptr, _version)`` of every parameter and buffer of
    ``modules``, in order: it changes when any of them is written in place
    or replaced."""
    return tuple((t.data_ptr(), t._version) for m in modules for t in (*m.parameters(), *m.buffers()))


class _Program:
    """One key's input buffers, and on the card its graph, the graph's
    outputs, the launches it captured and the seconds of its warm run and
    of its capture (host clock, each ending in a synchronize)."""

    def __init__(self, inputs: List[Optional[torch.Tensor]]):
        self.inputs = inputs
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Tuple[torch.Tensor, ...] = ()
        self.launches: Dict[str, int] = {}
        self.warm_s = self.capture_s = 0.0


class PlanProgram:
    """``program(body, init, frame, target, noise) -> (trajs, best)``: the
    plan ``body(init, frame, target, noise)`` on fixed buffers, on
    ``device``; a CUDA graph per key there. ``modules`` hold the weights
    the key follows; ``dtype`` is the compute dtype."""

    def __init__(self, modules, device, dtype: torch.dtype):
        self.modules = list(modules)
        self.device = torch.device(device)
        self.dtype = dtype
        self.programs: Dict[Tuple, _Program] = {}
        self.key: Optional[Tuple] = None  # the key of the last plan
        self._weights: Optional[Tuple] = None
        self._generation = -1
        self._stream: Optional[torch.cuda.Stream] = None
        self._lock = threading.Lock()  # one plan at a time on the shared buffers

    def __call__(self, body: Callable, init: torch.Tensor, frame: torch.Tensor, target: torch.Tensor,
                 noise: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        with self._lock:
            weights = weights_key(self.modules)
            if weights != self._weights:
                self.programs.clear()  # their graphs hold the old weights' packs
                self._weights, self._generation = weights, self._generation + 1
            self.key = key = (tuple(frame.shape), int(init.shape[0]),
                              None if noise is None else tuple(noise.shape), self.dtype, self._generation)
            prog = self.programs.get(key)
            new = prog is None
            if new:
                prog = _Program([
                    torch.empty(a.shape, dtype=dt, device=self.device) if a is not None else None
                    for a, dt in ((init, torch.float32), (frame, torch.uint8), (target, torch.float32),
                                  (noise, torch.float32))])
            for buf, src in zip(prog.inputs, (init, frame, target, noise)):
                if buf is not None:
                    buf.copy_(src)
            if new and self.device.type == "cuda":
                self._build(prog, body, key)  # raises if the capture fails
            self.programs[key] = prog
            if prog.graph is None:  # the CPU: the body on the buffers
                return tuple(o.clone() for o in body(*prog.inputs))
            prog.graph.replay()
            kernels.add_launch_counts(prog.launches)
            return tuple(o.clone() for o in prog.outputs)

    def _build(self, prog: _Program, body: Callable, key: Tuple) -> None:
        """Warm the body on a side stream, then capture it into ``prog``;
        the launch counts end as they began."""
        t0 = time.perf_counter()
        before = kernels.launch_counts()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        try:
            self._stream.wait_stream(current)
            with torch.cuda.stream(self._stream):
                body(*prog.inputs)
            current.wait_stream(self._stream)
            warm = kernels.launch_counts()
            torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, stream=self._stream, capture_error_mode="thread_local"):
                    outputs = body(*prog.inputs)
            except RuntimeError as e:
                raise RuntimeError(f"capturing the plan as a CUDA graph failed for {_describe(key)}: {e}") from e
            captured = kernels.launch_counts()
        finally:
            now = kernels.launch_counts()
            kernels.add_launch_counts({k: before[k] - now[k] for k in before})
        prog.graph, prog.outputs = graph, tuple(outputs)
        prog.launches = {k: captured[k] - warm[k] for k in warm}
        torch.cuda.synchronize(self.device)
        prog.warm_s, prog.capture_s = t1 - t0, time.perf_counter() - t1


def _describe(key: Tuple) -> str:
    """A program's key in words."""
    frame, k, noise, dtype, generation = key
    return (f"the key (frame {frame}, K {k}, step noise {noise}, {str(dtype).replace('torch.', '')}, "
            f"weights generation {generation})")
