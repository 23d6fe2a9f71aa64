"""Train state and the training step (counterpart of the JAX package's
``train/state.py``; reference: train.py:106-327).

The reference's training semantics:

* AdamW with betas (0.95, 0.999), eps 1e-7 and torch's default weight decay
  0.01 (train.py:170), the learning rate constant after a linear warmup
  (train.py:171-174), or a cosine decay to 0 (distillation);
* per step: t ~ U[0, TIME_STEPS), x_t = add_noise(x0), the first waypoint's
  anchor dims zeroed (train.py:232-235), under FREE_GUIDANCE a whole-batch
  condition drop (train.py:237-241: the target is kept when a uniform draw
  is <= USE_FREE_COND_PROB, else zeros), float32 MSE against the noise or
  x0 per PRED_TYPE (train.py:244-249);
* gradients scrubbed: nan -> 0, +-inf -> +-1e5 (train.py:252-255); no
  clipping (TRAIN.GRAD_NORM is read nowhere, as in the JAX package);
* the EMA updated after every optimizer step (train.py:260-261).

The state is PyTorch's: the model (parameters and BatchNorm buffers), a
``torch.optim.AdamW``, a ``LambdaLR`` and the EMA shadow, all updated in
place by the step. The step takes its random draws explicitly
(:class:`StepDraws`), or draws them from a ``torch.Generator`` it is given;
with neither it refuses.

Data-parallel (``parallel/ddp.py:wrap_ddp``), each rank holds the same
state, feeds its local batch through the ``DistributedDataParallel``
wrapper of the step's forward, and takes its rows of the GLOBAL batch's
draws, which every rank draws alike from the same generator (JAX draws them
for the global batch inside its one program, ``train.py:265,278``). The
gradients are averaged over the ranks before the NaN scrub and AdamW, so
every rank makes the same update and the same EMA step.
"""

from __future__ import annotations

import math
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
from torch.optim.lr_scheduler import LambdaLR
from torch.utils.checkpoint import checkpoint

from ..diffusion.schedule import DiffusionSchedule, add_noise
from ..models.temporal_unet import BN_MODES, TemporalMapUnet
from ..utils.constants import ANCHOR_DIMS, GuidanceType
from .ema import EmaConfig, EmaState, ema_init, ema_update

__all__ = [
    "TrainState",
    "StepDraws",
    "StepForward",
    "create_train_state",
    "draw_step",
    "make_lr_schedule",
    "make_optimizer",
    "make_train_step",
    "ema_config",
]

BETAS = (0.95, 0.999)
EPS = 1e-7
WEIGHT_DECAY = 0.01  # torch AdamW's default; the reference passes none


def make_lr_schedule(base_lr: float, warmup_steps: int) -> Callable[[int], float]:
    """Constant after a linear warmup (diffusers
    get_constant_schedule_with_warmup; reference train.py:171-174): the LR of
    the update made at optimizer step ``step`` (0 for the first), in
    float32 as the JAX package computes it."""

    def schedule(step: int) -> float:
        warm = min(np.float32(step) / np.float32(max(warmup_steps, 1)), np.float32(1.0))
        return float(np.float32(base_lr) * warm)

    return schedule


def _cosine_schedule(lr: float, warmup_steps: int, decay_steps: int) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, decay_steps, 0): a
    linear warmup from 0, then a cosine from ``lr`` to 0 over the remaining
    steps, 0 after ``decay_steps``."""
    warmup_steps = max(min(warmup_steps, decay_steps - 1), 0)
    span = decay_steps - warmup_steps

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return float(np.float32(lr) * np.float32(step) / np.float32(warmup_steps))
        c = np.float32(min(step - warmup_steps, span))
        return float(np.float32(lr) * np.float32(0.5) * (np.float32(1.0) + np.cos(np.float32(math.pi) * c / np.float32(span))))

    return schedule


def make_optimizer(params, lr: float, warmup_steps: int, decay_steps: int = 0):
    """(AdamW, LambdaLR): the reference's AdamW contract (train.py:170-174),
    the single source of these hyperparameters.

    torch's AdamW decays the weight before the Adam step, ``p (1 - lr wd)``,
    with ``lr`` the update's LR: optax's ``adamw`` adds ``wd p`` to the Adam
    direction and scales the sum by ``-lr``, the same update. The scheduler's
    factor is the LR itself (the optimizer's base LR is 1): optax evaluates
    the schedule at the update count before incrementing it, and ``LambdaLR``
    sets the LR of update k to ``schedule(k)`` (k = 0 first) when it steps
    after each update. ``decay_steps`` > 0 swaps the constant-after-warmup
    schedule for a cosine decay to 0 over that many steps (JAX
    ``make_optimizer``), which distillation uses."""
    schedule = (_cosine_schedule(lr, warmup_steps, decay_steps) if decay_steps > 0
                else make_lr_schedule(lr, warmup_steps))
    optimizer = torch.optim.AdamW(params, lr=1.0, betas=BETAS, eps=EPS, weight_decay=WEIGHT_DECAY)
    return optimizer, LambdaLR(optimizer, schedule)


def ema_config(cfg) -> EmaConfig:
    return EmaConfig(decay=cfg.TRAIN.EMA_MAX_DECAY, update_after_step=5000, use_ema_warmup=True,
                     inv_gamma=cfg.TRAIN.EMA_INV_GAMMA, power=cfg.TRAIN.EMA_POWER)


@dataclass
class TrainState:
    """What a step updates, in place: the model's parameters and BatchNorm
    buffers, the optimizer's moments and counts, the LR schedule, the EMA
    shadow, and ``step``, the optimizer steps taken. Data-parallel, ``ddp``
    is the DistributedDataParallel wrapper of the step's forward and
    ``rank`` / ``world`` the process's place in the group."""

    model: TemporalMapUnet
    optimizer: torch.optim.AdamW
    scheduler: LambdaLR
    ema: EmaState
    step: int = 0
    ddp: Optional[nn.Module] = None
    rank: int = 0
    world: int = 1


class StepForward(nn.Module):
    """The train step's forward, the module DistributedDataParallel wraps:
    ``model(x, img, time, cond)`` with the dropout generator ``gen``; under
    ``TPU.REMAT`` through ``torch.utils.checkpoint`` (non-reentrant), whose
    backward recomputes it with the same dropout masks."""

    def __init__(self, model: TemporalMapUnet, remat: bool):
        super().__init__()
        self.model = model
        self.remat = remat

    def forward(self, x, image, time, cond, gen: Optional[torch.Generator] = None):
        gen_state = gen.get_state() if self.remat and gen is not None else None

        def run(x, image, time, cond):
            if gen_state is not None:
                gen.set_state(gen_state)  # the recompute draws the first pass's masks
            return self.model(x, img=image, time=time, cond=cond, dropout_generator=gen)

        if self.remat:
            return checkpoint(run, x, image, time, cond, use_reentrant=False)
        return run(x, image, time, cond)


def create_train_state(model: TemporalMapUnet, cfg) -> TrainState:
    """A fresh state around ``model`` (its weights as they are)."""
    optimizer, scheduler = make_optimizer(model.parameters(), cfg.TRAIN.LR, cfg.TRAIN.LR_WARMUP)
    return TrainState(model, optimizer, scheduler, ema_init(model.parameters()), 0)


class StepDraws(NamedTuple):
    """The random draws of one step, for a batch of B rows cut into G
    micro-batches (TRAIN.GRADIENT_ACCUMULATION_STEPS): ``t`` (B,) integer
    timesteps in [0, TIME_STEPS); ``noise`` (B, horizon, transition_dim);
    ``keep`` (G,) bool, whether each micro-batch keeps its target (read
    under FREE_GUIDANCE only); ``dropout`` the generator of the dropout masks
    (None: the default generator)."""

    t: torch.Tensor
    noise: torch.Tensor
    keep: torch.Tensor
    dropout: Optional[torch.Generator] = None


def draw_step(cfg, batch_size: int, generator: torch.Generator) -> StepDraws:
    """A step's draws from ``generator``, on its device: t, then the noise,
    then the keep flags; the generator then draws the dropout masks."""
    dev = generator.device
    t = torch.randint(0, cfg.TRAIN.TIME_STEPS, (batch_size,), generator=generator, device=dev)
    noise = torch.randn((batch_size, cfg.MODEL.HORIZON, cfg.MODEL.TRANSITION_DIM),
                        generator=generator, device=dev)
    groups = max(int(cfg.TRAIN.GRADIENT_ACCUMULATION_STEPS), 1)
    keep = torch.rand((groups,), generator=generator, device=dev) <= cfg.TRAIN.USE_FREE_COND_PROB
    return StepDraws(t, noise, keep, generator)


def _nan_scrub_(grads) -> None:
    """Reference train.py:252-255, in place."""
    for g in grads:
        torch.nan_to_num_(g, nan=0.0, posinf=1e5, neginf=-1e5)


def _bn_buffers(model: nn.Module):
    """The buffers a training-mode BatchNorm moves in a forward."""
    return [b for m in model.modules() if isinstance(m, nn.BatchNorm2d) and m.training
            for b in m.buffers()]


def make_train_step(schedule: DiffusionSchedule, cfg) -> Callable:
    """``step(state, batch, draws=None, generator=None) -> metrics``.

    ``batch``: ``image`` (B, H, W, 3) normalized float images (uint8 is cast
    to float32 as it is), ``trajs`` (B, horizon, transition_dim) and
    ``target`` (B, 2), on the model's device. ``draws``: a
    :class:`StepDraws`, or None to draw them from ``generator``. The step
    puts the model in training mode (``TPU.BN_MODE``), updates ``state`` in
    place and returns ``{"loss": 0-d tensor on the device, "lr": the update's
    LR, "ema_decay"}``. Data-parallel, ``batch`` is the rank's local batch,
    ``draws`` are the global batch's (``state.world`` x B rows, of which the
    step takes the rank's, ``parallel/ddp.py:local_rows``) and the loss is
    the global batch's.

    With GRADIENT_ACCUMULATION_STEPS G > 1 the batch's leading dim is cut
    into G micro-batches of consecutive rows, run in order (BatchNorm
    statistics carried from one to the next); the gradients and the loss are
    averaged (JAX ``train/state.py:198-232``). ``TPU.REMAT`` runs the forward
    under ``torch.utils.checkpoint`` (non-reentrant): the backward recomputes
    it with the same dropout masks, and the BatchNorm statistics move once."""
    use_cond = GuidanceType[cfg.TRAIN.USE_COND]
    pred_type = cfg.TRAIN.NOISE_SCHEDULER.PRED_TYPE
    if pred_type not in ("epsilon", "sample"):
        raise ValueError("Not supported prediction type.")
    bn_mode = str(cfg.TPU.BN_MODE)
    if bn_mode not in BN_MODES:
        raise ValueError(f"TPU.BN_MODE must be 'train' or 'frozen', got {bn_mode!r}")
    remat = bool(cfg.TPU.REMAT)
    groups = max(int(cfg.TRAIN.GRADIENT_ACCUMULATION_STEPS), 1)
    ema_cfg = ema_config(cfg)

    def micro_loss(forward, image, trajs, target, t, noise, keep, gen):
        trajs = trajs.to(torch.float32)
        if not torch.is_floating_point(image):
            image = image.to(torch.float32)
        x = add_noise(schedule, trajs, noise, t)
        x[..., 0, :ANCHOR_DIMS] = 0.0
        cond = None
        if use_cond == GuidanceType.FREE_GUIDANCE:
            target = target.to(torch.float32)
            cond = torch.where(keep, target, torch.zeros_like(target))
        pred = forward(x, image, t.to(torch.float32), cond, gen)
        want = noise if pred_type == "epsilon" else trajs
        return torch.mean((pred.to(torch.float32) - want) ** 2)

    def local_draws(state: TrainState, draws: StepDraws, B: int) -> StepDraws:
        """The rank's rows of the global batch's draws; the dropout masks
        from a generator of the rank's own, seeded alike on every rank."""
        if draws.t.shape[0] != B * state.world:
            raise ValueError(f"draws for {draws.t.shape[0]} rows, the global batch has {B * state.world}")
        if state.world == 1:
            return draws
        from ..parallel.ddp import local_rows

        rows = local_rows(B, state.rank, state.world, groups)
        gen = draws.dropout
        if gen is not None and use_cond == GuidanceType.CLASSIFIER_GUIDANCE:
            seed = int(torch.randint(0, 2**62, (1,), generator=gen, device=gen.device))
            gen = torch.Generator(device=gen.device).manual_seed(seed + state.rank)
        return StepDraws(draws.t[rows.to(draws.t.device)], draws.noise[rows.to(draws.noise.device)],
                         draws.keep, gen)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], draws: Optional[StepDraws] = None,
                   generator: Optional[torch.Generator] = None) -> dict:
        model = state.model
        B = batch["trajs"].shape[0]
        if draws is None:
            if generator is None:
                raise ValueError("the train step needs its draws: pass draws=StepDraws(...) or a torch.Generator")
            draws = draw_step(cfg, B * state.world, generator)
        if B % groups:
            raise ValueError(f"batch {B} does not split into {groups} micro-batches")
        draws = local_draws(state, draws, B)
        dev = model.device
        t, noise, keep = (a.to(dev) for a in draws[:3])
        model.train(bn_mode=bn_mode)
        forward = state.ddp if state.ddp is not None else StepForward(model, remat)
        params = list(model.parameters())
        for p in params:
            p.grad = None
        mb = B // groups
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(groups):
            rows = slice(i * mb, (i + 1) * mb)
            # DDP averages the gradients once, in the last micro-batch's backward
            sync = state.ddp.no_sync() if state.ddp is not None and i < groups - 1 else nullcontext()
            with sync:
                loss_i = micro_loss(forward, batch["image"][rows], batch["trajs"][rows], batch["target"][rows],
                                    t[rows], noise[rows], keep.reshape(-1)[i], draws.dropout)
                moved = [b.clone() for b in _bn_buffers(model)] if remat else []
                loss_i.backward()
            for b, saved in zip(_bn_buffers(model) if remat else (), moved):
                b.copy_(saved)  # the recompute moved them a second time
            loss = loss + loss_i.detach()
        grads = []
        for p in params:
            if p.grad is None:  # as JAX's zero gradient: the weight still decays
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        if groups > 1:
            torch._foreach_div_(grads, float(groups))
            loss = loss / groups
        if state.world > 1:  # the global batch's loss
            dist.all_reduce(loss)
            loss = loss / state.world
        _nan_scrub_(grads)
        lr = state.scheduler.get_last_lr()[0]
        state.optimizer.step()
        state.scheduler.step()
        decay = ema_update(ema_cfg, state.ema, params)
        state.step += 1
        return {"loss": loss, "lr": lr, "ema_decay": decay}

    return train_step

