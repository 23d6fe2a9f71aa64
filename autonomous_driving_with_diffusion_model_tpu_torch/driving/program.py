"""The plan as one program on the card (the counterpart of the JAX
planner's ``self._plan = jax.jit(_plan)``, JAX ``driving/plan.py:186``).

:class:`PlanProgram` runs the planner's body (``DiffusionPlanner._plan``:
normalize, encode once, denoise K hypotheses, score, argmin) on fixed input
buffers: the uint8 frame (H, W, 3), the target (1, 2), the init
trajectories (K, horizon, D) and, where the sampler needs it, the step noise
(S, K, horizon, D), and any further inputs the body takes (RDT-1B's
instruction: its tokens and mask). A plan copies its inputs into them with ``copy_``, runs
the program of its key and returns copies of (trajs, best) on the device,
so that a later plan cannot overwrite a handle that was not fetched yet.

On a CUDA device the program is a CUDA graph (``ops/program.py``), so one
plan is one replay, with no Python between its ~10,000 launches:

* the key's first plan runs the body once eagerly on a side stream, then
  captures it, and every plan of that key replays it. A graph unrolls the
  whole denoising loop, so the JAX package's ``TPU.SCAN_UNROLL`` has nothing
  to set here;
* the key is the frame's shape, K, the step noise's shape, the compute
  dtype, the further inputs' shapes and the weights' generation: the weights are followed by
  ``data_ptr`` and ``_version`` of every parameter and buffer of the
  planner's modules, read through a
  :class:`~..ops.program.ModuleTensors`, which walks the modules again only
  where their structure may have changed. A capture bakes in the pointers of the
  cached kernel packs, so weights that change after a capture
  (``load_state_dict``, an EMA copy, a training program's replay) drop
  every program of the old weights and the next plan captures anew;
* a capture that fails raises ``RuntimeError`` naming the key; the eager
  body stays callable as the planner's ``_plan``, the plain version the
  graph is held against.

Tracing (``utils/profiling.py``). A call records the host spans
``plan.weights_key`` (the weights' key, and a walk of the modules where
their structure changed), ``plan.inputs`` (the
key, the buffers, the copies into them, the frame's pageable copy among
them), ``plan.build`` on a miss, ``plan.replay`` (the replay's launch; on
the CPU the body) and ``plan.outputs`` (the clones), children of the
planner's ``plan`` span. The graph carries the device spans that the body
marks (``DiffusionPlanner._plan``: ``plan.encode``, ``plan.denoise``,
``plan.score``; at most :data:`MARKERS` markers), each replay's written on
the device and read only by ``profiling.report()``. A build counts
``captures.plan`` and its seconds (the warm run and the capture), a new
weights generation ``weights_generations.plan``, a walk of the modules
``weights_walks.plan``.

The kernels' launch counts: neither the warm run nor the capture counts,
and the key's first plan replays after its build, so a plan counts the
launches of its one replay, as it counted its eager loop's before.

On the CPU the same object calls the body on the same buffers: only the
capture and the replay are CUDA's, and the buffers, keys and invalidation
run in the CPU tests.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Tuple

import torch

from ..ops import program
from ..utils import profiling

__all__ = ["PlanProgram", "describe", "MARKERS"]

MARKERS = 6  # device-span markers a plan graph may hold


class PlanProgram(program.Programs):
    """``program(body, init, frame, target, noise, extra=()) -> (trajs,
    best)``: the plan ``body(init, frame, target, noise, *extra)`` on fixed
    buffers (``extra``: device tensors of the body's further inputs), on
    ``device``; a CUDA graph per key there. ``modules`` hold the weights
    the key follows; ``dtype`` is the compute dtype."""

    def __init__(self, modules, device, dtype: torch.dtype):
        super().__init__(device)
        self.weights = program.ModuleTensors(modules, "weights_walks.plan")
        self.dtype = dtype
        self._lock = threading.Lock()  # one plan at a time on the shared buffers

    def __call__(self, body: Callable, init: torch.Tensor, frame: torch.Tensor, target: torch.Tensor,
                 noise: Optional[torch.Tensor], extra: Tuple[torch.Tensor, ...] = ()
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        with self._lock:
            with profiling.span("plan.weights_key"):
                if self.follow(self.weights.key()):
                    profiling.count("weights_generations.plan")
            with profiling.span("plan.inputs"):
                self.key = key = (tuple(frame.shape), int(init.shape[0]),
                                  None if noise is None else tuple(noise.shape), self.dtype,
                                  tuple(tuple(a.shape) for a in extra) or None, self.generation)
                prog = self.programs.get(key)
                new = prog is None
                if new:
                    prog = program.Program([
                        torch.empty(a.shape, dtype=dt, device=self.device) if a is not None else None
                        for a, dt in ((init, torch.float32), (frame, torch.uint8), (target, torch.float32),
                                      (noise, torch.float32), *((a, a.dtype) for a in extra))])
                for buf, src in zip(prog.inputs, (init, frame, target, noise, *extra)):
                    if buf is not None:
                        buf.copy_(src)
            if new and self.device.type == "cuda":
                with profiling.span("plan.build"):
                    run = lambda: tuple(body(*prog.inputs))
                    self.warm(prog, run, counted=False)
                    self.capture(prog, run, f"the plan for {describe(key)}", "plan", MARKERS)
            self.programs[key] = prog
            with profiling.span("plan.replay"):
                outputs = body(*prog.inputs) if prog.graph is None else self.replay(prog)
            with profiling.span("plan.outputs"):
                return tuple(o.clone() for o in outputs)


def describe(key: Tuple) -> str:
    """A program's key in words."""
    frame, k, noise, dtype, extra, generation = key
    more = f", further inputs {', '.join(map(str, extra))}" if extra else ""
    return (f"the key (frame {frame}, K {k}, step noise {noise}, {str(dtype).replace('torch.', '')}{more}, "
            f"weights generation {generation})")
