"""The training-side steps as one program each on the card (the
counterparts of the JAX package's jitted steps: the train step,
``train.py:204`` ``jax.jit(make_train_step(...), donate_argnums=(0,))``; the
distill step, ``distill.py:161`` ``jax.jit(step, donate_argnums=(0,))``; the
scorer fit, ``models/scorer.py:178`` ``@jax.jit`` over a ``lax.scan`` of its
steps). Built as every program of the port is (``ops/program.py``).

:class:`TrainProgram` and :class:`DistillProgram` hold fixed input buffers
(the batch and the step's draws) and one CUDA graph per key. A step copies
its inputs into the buffers; the host parts of the step (the draws, the EMA
decay written into its device scalar, the counts and the next LR afterwards,
``train/state.py:TrainStep``) run around the device part, its ``body``:

* the key's first step runs the unchanged eager body on a side stream (a
  real step, which counts its launches), then the body is captured and
  every later step of the key replays it. Under DistributedDataParallel
  on NCCL the first 11 steps run eagerly (DDP's reducer settles its
  buckets in its first iterations) and the capture holds the gradients'
  all-reduce;
* the draws are made on the host side of the step, in the eager step's
  order (t, noise, keep, then the dropout masks' uniforms, each into its
  buffer), so a replay computes what the eager step computes bit for bit;
  the dropout masks reach the forward through ``models/blocks.py:
  DropoutDraws``, whose cursor gives a ``TPU.REMAT`` recompute the first
  pass's masks;
* the key is the batch's shapes and dtypes, G (``GRADIENT_ACCUMULATION_
  STEPS``), the compute dtype, ``BN_MODE``, ``REMAT``, ``USE_COND``, the
  ranks and the state's generation: ``data_ptr`` and ``_version`` of every
  parameter, buffer, AdamW moment and count and EMA shadow (of the teacher's
  weights too, for distillation), which eager code moves when it writes
  them (a resume, a ``load_state_dict``); the program's own steps stay in
  their generation. A new generation drops the old graphs, so one is never
  replayed on tensors it was not captured on;
* each replay bumps the ``_version`` of every tensor the step writes,
  which the kernel packs' caches (``models/blocks.py:_packed``) and the plan
  program's key read, so a plan or a sample after graph steps packs and
  captures the new weights;
* a capture that fails raises ``RuntimeError`` naming the key; the eager
  step stays callable (``TrainStep``, ``DistillStep``), the plain version a
  graph is held against.

Tracing (``utils/profiling.py``): a train step is the host span ``step``,
whose request is the state's step count, with the children ``step.draws``
(the dropout uniforms before a replay), ``step.state_key`` (the walks of
what the step writes), ``step.replay`` (the replay's launch; on the CPU the
body) and ``step.build`` on a miss. Its graph carries the device spans the
body marks (``TrainStep.body``: ``step.forward``, ``step.backward``,
``step.optimizer``; 2G + 2 markers of the 2G + 4 a graph may hold), read
only by ``profiling.report()``. A capture counts ``captures.step`` and the
seconds of its eager step and its capture. The distill program and
:func:`replay_steps` record none of these.

:func:`replay_steps` runs a step of no inputs (the scorer's full-batch
AdamW step) ``steps`` times as one eager step, one capture and ``steps - 1``
replays.

On the CPU the same objects run the step on the same buffers: only the
capture and the replay are CUDA's.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..models.blocks import DropoutDraws
from ..ops import program
from ..utils import profiling
from .state import StepDraws, TrainState, TrainStep

__all__ = ["TrainProgram", "DistillProgram", "replay_steps", "DDP_WARM_STEPS"]

DDP_WARM_STEPS = 11  # eager DDP iterations before a capture (PyTorch's CUDA graphs notes)


def _optimizer_tensors(optimizer: torch.optim.Optimizer) -> List[torch.Tensor]:
    return [v for st in optimizer.state.values() for v in st.values() if isinstance(v, torch.Tensor)]


def _fill(bufs: Dict[str, torch.Tensor], srcs: Dict[str, torch.Tensor]) -> None:
    for name, src in srcs.items():
        bufs[name].copy_(src)


def _buffers(srcs: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    return {name: torch.empty(src.shape, dtype=src.dtype, device=device) for name, src in srcs.items()}


class _StepProgram(program.Programs):
    """What the train and distill programs share: the keyed buffers."""

    def _program(self, state_key: Tuple, key_of: Callable[[int], Tuple], inputs: Dict[str, torch.Tensor],
                 warm_steps: int) -> Tuple[program.Program, bool]:
        self.follow(state_key)
        self.key = key = key_of(self.generation)
        prog = self.programs.get(key)
        if prog is None:
            prog = self.programs[key] = program.Program(_buffers(inputs, self.device), warm_steps)
        _fill(prog.inputs, inputs)
        return prog, prog.graph is None and self.device.type == "cuda"


class TrainProgram(_StepProgram):
    """``program(state, batch, draws=None, generator=None) -> metrics``: the
    train step ``step`` (a :class:`~.state.TrainStep`) on fixed buffers, as
    the step takes them; a CUDA graph per key on the card. The metrics are
    the step's: the loss a copy on the device, the LR and the EMA decay
    host floats."""

    def __init__(self, step: TrainStep, device):
        super().__init__(device)
        self.step = step

    @staticmethod
    def writes(state: TrainState) -> List[torch.Tensor]:
        """What a step writes: the parameters, buffers, AdamW's state and the
        EMA shadows."""
        m = state.model
        return [*m.parameters(), *m.buffers(), *_optimizer_tensors(state.optimizer), *state.ema.shadow_params]

    def state_key(self, state: TrainState) -> Tuple:
        return program.tensors_key(self.writes(state))

    def __call__(self, state: TrainState, batch: Dict[str, torch.Tensor], draws: Optional[StepDraws] = None,
                 generator: Optional[torch.Generator] = None) -> dict:
        with profiling.span("step", request=state.step):
            return self._step(state, batch, draws, generator)

    def _step(self, state: TrainState, batch: Dict[str, torch.Tensor], draws: Optional[StepDraws],
              generator: Optional[torch.Generator]) -> dict:
        step = self.step
        draws = step.local_draws(state, batch["trajs"].shape[0], draws, generator)
        inputs = {**{f"batch.{k}": v for k, v in sorted(batch.items())},
                  "t": draws.t, "noise": draws.noise, "keep": draws.keep}
        key_of = lambda generation: (
            tuple((k, tuple(v.shape), v.dtype) for k, v in inputs.items()), step.groups,
            state.model.compute_dtype, step.bn_mode, step.remat, step.use_cond.name, state.world, generation)
        ddp_nccl = state.ddp is not None and self.device.type == "cuda"
        with profiling.span("step.state_key"):
            state_key = self.state_key(state)
        prog, build = self._program(state_key, key_of, inputs, DDP_WARM_STEPS if ddp_nccl else 1)
        bufs = prog.inputs
        batch_b = {k[len("batch."):]: v for k, v in bufs.items() if k.startswith("batch.")}
        if prog.graph is not None:
            with profiling.span("step.draws"):
                gen = _generator(draws.dropout, self.device)
                for u in bufs["dropout"]:  # after t, noise and keep, as the eager step draws them
                    u.copy_(torch.rand(u.shape, generator=gen, device=gen.device))
            lr, decay = step.begin(state)
            with profiling.span("step.replay"):
                loss = self.replay(prog, self.writes(state)).clone()
            step.end(state)
        elif not build:  # the CPU: the step on the buffers
            lr, decay = step.begin(state)
            with profiling.span("step.replay"):
                loss = step.body(state, batch_b, StepDraws(bufs["t"], bufs["noise"], bufs["keep"], draws.dropout))
            step.end(state)
        else:
            with profiling.span("step.build"):
                lr, decay, loss = self._build(prog, state, batch_b, draws)
        with profiling.span("step.state_key"):
            self.settle(self.state_key(state))
        return {"loss": loss, "lr": lr, "ema_decay": decay}

    def _build(self, prog: program.Program, state: TrainState, batch_b: Dict[str, torch.Tensor], draws: StepDraws):
        """An eager step on the side stream; after the key's last one, the
        capture. Returns (lr, decay, loss) of the eager step."""
        step, bufs = self.step, prog.inputs
        recorder = DropoutDraws(_generator(draws.dropout, self.device))

        def run():
            lr, decay = step.begin(state)
            loss = step.body(state, batch_b, StepDraws(bufs["t"], bufs["noise"], bufs["keep"], recorder))
            step.end(state)
            return lr, decay, loss

        lr, decay, loss = self.warm(prog, run)
        if prog.warm_left <= 0:
            # the dropout masks' uniforms, drawn into these before each replay
            uniforms = bufs["dropout"] = [torch.empty_like(u) for u in recorder.draws]
            body = lambda: step.body(state, batch_b, StepDraws(bufs["t"], bufs["noise"], bufs["keep"],
                                                               DropoutDraws(draws=uniforms)))
            self.capture(prog, body, f"the train step for {_describe(self.key)}", "step", 2 * step.groups + 4)
        return lr, decay, loss


class DistillProgram(_StepProgram):
    """``program(state, teacher, batch, draws=None, generator=None) ->
    metrics``: the distill step ``step`` (``diffusion/distill.py``'s
    ``DistillStep``) on fixed buffers; a CUDA graph per key on the card,
    one per stage (a new student or teacher is a new generation)."""

    def __init__(self, step, device):
        super().__init__(device)
        self.step = step

    @staticmethod
    def writes(state) -> List[torch.Tensor]:
        """What a step writes: the student's parameters and buffers, AdamW's
        state and the EMA shadows."""
        return [*state.student.parameters(), *state.student.buffers(), *_optimizer_tensors(state.optimizer),
                *state.ema.shadow_params]

    def state_key(self, state, teacher) -> Tuple:
        return program.tensors_key([*self.writes(state), *teacher.parameters(), *teacher.buffers()])

    def __call__(self, state, teacher, batch: Dict[str, torch.Tensor], draws=None,
                 generator: Optional[torch.Generator] = None) -> dict:
        step = self.step
        draws = step.draws(batch, draws, generator)
        inputs = {**{f"batch.{k}": v for k, v in sorted(batch.items())}, "i": draws.i, "noise": draws.noise}
        key_of = lambda generation: (
            tuple((k, tuple(v.shape), v.dtype) for k, v in inputs.items()), state.student.compute_dtype,
            step.use_cond.name, generation)
        prog, build = self._program(self.state_key(state, teacher), key_of, inputs, 1)
        bufs = prog.inputs
        batch_b = {k[len("batch."):]: v for k, v in bufs.items() if k.startswith("batch.")}
        buf_draws = type(draws)(bufs["i"], bufs["noise"])
        if prog.graph is not None:
            lr = step.begin(state)
            loss = self.replay(prog, self.writes(state)).clone()
            step.end(state)
        elif not build:
            lr = step.begin(state)
            loss = step.body(state, teacher, batch_b, buf_draws)
            step.end(state)
        else:
            def run():
                lr = step.begin(state)
                loss = step.body(state, teacher, batch_b, buf_draws)
                step.end(state)
                return lr, loss

            lr, loss = self.warm(prog, run)
            self.capture(prog, lambda: step.body(state, teacher, batch_b, buf_draws),
                         f"the distill step for {_describe_distill(self.key)}")
            # the teacher's cached kernel packs the graph reads, alive whatever
            # repacks the teacher later
            prog.keep = [dict(m.__dict__.get("_kernel_params", {})) for m in teacher.modules()]
        self.settle(self.state_key(state, teacher))
        return {"loss": loss, "lr": lr}


def replay_steps(step: Callable[[], torch.Tensor], steps: int, device,
                 writes: List[torch.Tensor]) -> Tuple[torch.Tensor, dict]:
    """``steps`` calls of ``step`` (an optimizer step of no inputs that
    returns its loss and writes ``writes`` in place), and the last one's
    loss: on the card one eager call on a side stream, one capture and
    ``steps - 1`` replays (the counterpart of a ``lax.scan`` of the steps
    under ``jax.jit``), ``writes``' ``_version`` bumped after them; a loop on
    the CPU. Also returns ``{"warm_s", "capture_s", "replays"}``."""
    dev = torch.device(device)
    info = {"warm_s": 0.0, "capture_s": 0.0, "replays": 0}
    loss = torch.full((), math.nan)
    if dev.type != "cuda":
        for _ in range(steps):
            loss = step()
        return loss, info
    if steps <= 0:
        return loss, info
    owner, prog = program.Programs(dev), program.Program(None)
    loss = owner.warm(prog, step)
    info["warm_s"] = prog.warm_s
    if steps == 1:
        return loss, info
    owner.capture(prog, step, "the fit's step")
    out = owner.replay(prog, writes, steps - 1)
    info.update(capture_s=prog.capture_s, replays=steps - 1)
    return out.clone(), info


def _generator(gen: Optional[torch.Generator], device) -> torch.Generator:
    """``gen``, or where it is None the generator the eager step's dropout
    then draws from: ``device``'s default."""
    if gen is not None:
        return gen
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.default_generators[device.index if device.index is not None
                                             else torch.cuda.current_device()]
    return torch.default_generator


def _describe(key: Tuple) -> str:
    """A train program's key in words."""
    inputs, groups, dtype, bn_mode, remat, use_cond, world, generation = key
    shapes = ", ".join(f"{k} {tuple(s)}" for k, s, _ in inputs)
    return (f"the key ({shapes}; G {groups}, {str(dtype).replace('torch.', '')}, BN_MODE {bn_mode}, "
            f"REMAT {remat}, {use_cond}, {world} rank(s), state generation {generation})")


def _describe_distill(key: Tuple) -> str:
    inputs, dtype, use_cond, generation = key
    shapes = ", ".join(f"{k} {tuple(s)}" for k, s, _ in inputs)
    return (f"the key ({shapes}; {str(dtype).replace('torch.', '')}, {use_cond}, "
            f"state generation {generation})")
