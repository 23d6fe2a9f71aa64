"""Progressive distillation: halve the DDIM grid, stage by stage
(counterpart of the JAX package's ``diffusion/distill.py``; Salimans & Ho,
"Progressive Distillation for Fast Sampling of Diffusion Models", ICLR 2022,
on this planner's x0-("sample")-prediction DDIM sampler).

Per stage the student, initialized from the teacher, learns to do in ONE
DDIM step what the teacher does in TWO:

* grids are exact halvings: the student's ``ts`` are every other teacher
  step, its ``prev`` the teacher's second substep's prev (an odd-length tail
  collapses to a single substep). Samplers take such a grid through
  ``SamplerConfig.timesteps`` / ``cfg.TPU.SAMPLE_TIMESTEPS``.
* the regression target is the IMPLIED x0: the model output z for which one
  student DDIM step from (x_t, t) lands on the teacher's two-step result
  x_s, ``z = (x_s - c2 x_t) / (sqrt(a_s) - c2 sqrt(a_t))`` with
  ``c2 = sqrt((1 - a_s) / (1 - a_t))``, clipped to [-1, 1]; at a terminal
  prev (alpha 1) it is x_s.
* the first waypoint's anchor dims are zeroed in x_t, in each teacher
  substep and in the target, as the sampler zeroes them.
* teacher and student run with frozen BatchNorm and no dropout (eval
  mode): the student starts from converged EMA weights.

FREE_GUIDANCE distills the w-guided teacher (``u + w (c - u)`` at
``free_scale``, Meng et al. 2023), while the student makes one conditional
pass: deploy it with ``GUIDANCE.FREE_SCALE 1.0``. CLASSIFIER_GUIDANCE is
refused, as in the JAX package: its in-loop gradient guidance has no
distillation target.

The teacher and the student are two modules of one config, the student a
deep copy. The teacher's parameters need no gradient and it runs under
``torch.no_grad()``, so its blocks pack their kernel weights once
(``models/blocks.py:_packed``); the student's encoder and U-Net take the
gradient (JAX differentiates ``params`` whole), its packs built in the graph.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.temporal_unet import TemporalMapUnet
from ..utils.constants import ANCHOR_DIMS, GuidanceType
from .schedule import DiffusionSchedule, add_noise, leading_timesteps
from .steps import StepConfig, ddim_step_rows

if TYPE_CHECKING:
    from ..train.ema import EmaState

__all__ = [
    "DistillGrid",
    "DistillState",
    "DistillDraws",
    "initial_grid",
    "halve_grid",
    "grid_chain",
    "implied_x0_target",
    "draw_distill",
    "make_distill_step",
]


class DistillGrid(NamedTuple):
    """One stage's student grid and the teacher substeps each step spans.

    All 1-D int64 numpy arrays of equal length S (the student step count):
    student step i goes ``ts[i] -> prev[i]`` while the teacher goes
    ``ts[i] -> mids[i] -> prev[i]`` (or a single ``ts[i] -> prev[i]`` substep
    where ``single[i]``, the odd-length tail).
    """

    ts: np.ndarray
    mids: np.ndarray
    prev: np.ndarray
    single: np.ndarray  # bool


def initial_grid(num_train_timesteps: int, num_steps: int) -> Tuple[np.ndarray, np.ndarray]:
    """The teacher's starting grid: diffusers' leading spacing (what the
    standard sampler runs at EVAL.SAMPLE_STEPS=num_steps)."""
    return leading_timesteps(num_train_timesteps, num_steps)


def halve_grid(ts: np.ndarray, prev: np.ndarray) -> DistillGrid:
    """Student grid = every other teacher step, starting at the first."""
    ts = np.asarray(ts, np.int64)
    prev = np.asarray(prev, np.int64)
    S = len(ts)
    if S < 2:
        raise ValueError(f"cannot halve a {S}-step grid")
    idx = np.arange(0, S, 2)
    has_second = idx + 1 < S
    mids = prev[idx]  # == ts[idx + 1] where a second substep exists
    prev2 = np.where(has_second, prev[np.minimum(idx + 1, S - 1)], prev[idx])
    return DistillGrid(ts=ts[idx], mids=mids, prev=prev2, single=~has_second)


def grid_chain(num_train_timesteps: int, start_steps: int, num_stages: int):
    """The per-stage DistillGrids: start_steps -> ceil(n/2) -> ... (stage k's
    teacher is the stage k-1 student; stage 0's runs the leading grid)."""
    ts, prev = initial_grid(num_train_timesteps, start_steps)
    grids = []
    for _ in range(num_stages):
        g = halve_grid(ts, prev)
        grids.append(g)
        if len(g.ts) < 2:
            break
        ts, prev = g.ts, g.prev
    return grids


def implied_x0_target(schedule: DiffusionSchedule, x_t: torch.Tensor, x_s: torch.Tensor,
                      t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Solve the (eta = 0) DDIM step for the model output that maps x_t to
    x_s. t, s: (B,) integer timesteps (s < 0: terminal)."""
    a_t = schedule.alpha_prod(t.to(torch.long))
    a_s = schedule.alpha_prod_prev(s)
    c2 = torch.sqrt((1.0 - a_s) / (1.0 - a_t))
    denom = torch.sqrt(a_s) - c2 * torch.sqrt(a_t)
    shape = (-1,) + (1,) * (x_t.ndim - 1)
    return (x_s - c2.reshape(shape) * x_t) / denom.reshape(shape)


@dataclass
class DistillState:
    """What a distill step updates, in place: the student (its parameters),
    its AdamW and LR schedule, ``step`` and the student's EMA, which is the
    DEPLOYED weights (see :func:`make_distill_step`)."""

    student: TemporalMapUnet
    optimizer: torch.optim.AdamW
    scheduler: torch.optim.lr_scheduler.LambdaLR
    ema: "EmaState"
    step: int = 0


class DistillDraws(NamedTuple):
    """The random draws of one distill step: ``i`` (B,) indices into the
    grid's student steps, ``noise`` (B, horizon, transition_dim)."""

    i: torch.Tensor
    noise: torch.Tensor


def draw_distill(batch_size: int, n_grid: int, shape, generator: torch.Generator) -> DistillDraws:
    """A step's draws from ``generator``, on its device: the grid indices,
    then the noise."""
    dev = generator.device
    i = torch.randint(0, n_grid, (batch_size,), generator=generator, device=dev)
    return DistillDraws(i, torch.randn((batch_size,) + tuple(shape), generator=generator, device=dev))


def _anchor(x: torch.Tensor) -> torch.Tensor:
    x = x.clone()
    x[:, 0, :ANCHOR_DIMS] = 0.0
    return x


def make_distill_step(
    schedule: DiffusionSchedule,
    grid: DistillGrid,
    *,
    use_cond: GuidanceType = GuidanceType.NO_GUIDANCE,
    free_scale: float = 7.5,
    step_cfg: StepConfig = StepConfig(prediction_type="sample", clip_sample=True),
    lr: float = 1e-4,
    warmup: int = 20,
    snr_weight: bool = False,
    decay_steps: int = 0,
    ema_decay: float = 0.999,
):
    """Build ``(init_state, step)`` for one distillation stage.

    ``init_state(teacher) -> DistillState``: the student a deep copy of the
    teacher module, a fresh AdamW. ``step(state, teacher, batch, draws=None,
    generator=None) -> {"loss", "lr"}``: ``batch`` is the training dict
    {image (B, H, W, 3) normalized float, trajs (B, horizon, 7), target (B,
    2)} on the student's device; ``draws`` a :class:`DistillDraws`, or None
    to draw them from ``generator`` (with neither it refuses).
    ``snr_weight`` applies the truncated-SNR loss weight max(a_t/(1-a_t), 1).

    Deploy ``state.ema.shadow_params``, not the raw parameters, and pass
    ``decay_steps`` = the stage's iterations so the LR decays to 0 by a
    cosine: the raw end-of-stage parameters carry AdamW's last noisy
    updates, which the EMA (diffusers' warmup decay, power 2/3, no delay)
    averages out (JAX ``make_distill_step``'s docstring has the history).
    """
    if step_cfg.prediction_type != "sample":
        raise ValueError("distillation is derived for x0 ('sample') prediction")
    if use_cond == GuidanceType.CLASSIFIER_GUIDANCE:
        raise ValueError(
            "CLASSIFIER_GUIDANCE has no distillation target (in-loop gradient "
            "guidance); its flagship config already plans in 2 steps"
        )
    # lazy: train/state.py imports diffusion.schedule, whose package imports this module
    from ..train.ema import EmaConfig, ema_init, ema_update
    from ..train.state import _nan_scrub_, make_optimizer

    ema_cfg = EmaConfig(decay=ema_decay, update_after_step=0, use_ema_warmup=True, inv_gamma=1.0,
                        power=2.0 / 3.0)
    dev = schedule.alphas_cumprod.device
    ts, mids, prevs = (torch.as_tensor(np.asarray(a, np.int64), device=dev)
                       for a in (grid.ts, grid.mids, grid.prev))
    single = torch.as_tensor(np.asarray(grid.single, bool), device=dev)
    n_grid = len(grid.ts)
    guided = use_cond == GuidanceType.FREE_GUIDANCE

    def init_state(teacher: TemporalMapUnet) -> DistillState:
        student = copy.deepcopy(teacher)
        for m in student.modules():
            m.__dict__.pop("_kernel_params", None)  # the teacher's packs
        student.requires_grad_(True).eval()
        optimizer, scheduler = make_optimizer(student.parameters(), lr, warmup, decay_steps=decay_steps)
        return DistillState(student, optimizer, scheduler, ema_init(student.parameters()), 0)

    def fwd_teacher(teacher, x, feat, t, cond):
        """One teacher x0 prediction; under FREE_GUIDANCE the w-guided
        combination, the map the student must learn."""
        t_f = t.to(torch.float32)
        if guided:
            out_c = teacher(x, time=t_f, cond=cond, img_feature=feat)
            out_u = teacher(x, time=t_f, cond=torch.zeros_like(cond), img_feature=feat)
            return (out_u + free_scale * (out_c - out_u)).to(torch.float32)
        return teacher(x, time=t_f, img_feature=feat).to(torch.float32)

    def step(state: DistillState, teacher: TemporalMapUnet, batch: Dict[str, torch.Tensor],
             draws: Optional[DistillDraws] = None, generator: Optional[torch.Generator] = None) -> dict:
        student = state.student
        trajs = batch["trajs"].to(torch.float32)
        image = batch["image"].to(torch.float32)
        cond = batch["target"].to(torch.float32) if guided else None
        B = trajs.shape[0]
        if draws is None:
            if generator is None:
                raise ValueError("the distill step needs its draws: pass draws=DistillDraws(...) "
                                 "or a torch.Generator")
            draws = draw_distill(B, n_grid, trajs.shape[1:], generator)
        i, noise = draws.i.to(dev, torch.long), draws.noise.to(dev, torch.float32)
        t, m, s, sgl = ts[i], mids[i], prevs[i], single[i]
        m_safe = m.clamp_min(0)
        x_t = _anchor(add_noise(schedule, trajs, noise, t))

        # the teacher's composite: both substeps always, the odd tail by ``single``
        teacher.eval()
        with torch.no_grad():
            tfeat = teacher.encode_image(image)
            out1 = fwd_teacher(teacher, x_t, tfeat, t, cond)
            x_m = _anchor(ddim_step_rows(schedule, step_cfg, out1, t, m_safe, x_t))
            out2 = fwd_teacher(teacher, x_m, tfeat, m_safe, cond)
            x_s_two = ddim_step_rows(schedule, step_cfg, out2, m_safe, s, x_m)
            x_s_one = ddim_step_rows(schedule, step_cfg, out1, t, s, x_t)
            x_s = _anchor(torch.where(sgl[:, None, None], x_s_one, x_s_two))
            z = _anchor(implied_x0_target(schedule, x_t, x_s, t, s).clamp(-1.0, 1.0))

        # the student: one forward (a single conditional pass under CFG)
        student.eval()
        params = list(student.parameters())
        for p in params:
            p.grad = None
        sfeat = student.encode_image(image)
        pred = student(x_t, time=t.to(torch.float32), cond=cond, img_feature=sfeat).to(torch.float32)
        err2 = (pred - z) ** 2
        if snr_weight:
            a_t = schedule.alpha_prod(t)
            w = torch.clamp_min(a_t / (1.0 - a_t), 1.0)
            err2 = err2 * w.reshape((-1,) + (1,) * (err2.ndim - 1))
        loss = torch.mean(err2)
        loss.backward()
        grads = []
        for p in params:
            if p.grad is None:  # as JAX's zero gradient: the weight still decays
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        _nan_scrub_(grads)
        lr_now = state.scheduler.get_last_lr()[0]
        state.optimizer.step()
        state.scheduler.step()
        ema_update(ema_cfg, state.ema, params)
        state.step += 1
        return {"loss": loss.detach(), "lr": lr_now}

    return init_state, step
