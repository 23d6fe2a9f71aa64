"""Exponential moving average of parameters, diffusers-compatible
(counterpart of the JAX package's ``train/ema.py``).

``diffusers.training_utils.EMAModel`` as the reference trains with it
(train.py:146-153: update_after_step 5000, use_ema_warmup): each update
first increments the step, then computes the decay, then moves every shadow
parameter by ``s - (1 - d) (s - p)``. ``shadow_params`` is a list in
``model.parameters()`` order, the reference ``ema_state_dict``'s.

An update is three parts, so that a captured step (``train/program.py``)
replays the device part alone: :func:`ema_begin` computes the decay on the
host and writes ``1 - decay`` into the state's device scalar ``factor``,
:func:`ema_apply` moves the shadow by it, and :func:`ema_end` counts the
step. :func:`ema_update` runs the three.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, NamedTuple, Optional

import numpy as np
import torch

__all__ = ["EmaConfig", "EmaState", "ema_init", "ema_decay_for_step", "ema_begin", "ema_apply", "ema_end",
           "ema_update"]


class EmaConfig(NamedTuple):
    decay: float = 0.9999  # the largest decay (TRAIN.EMA_MAX_DECAY)
    min_decay: float = 0.0
    update_after_step: int = 5000  # the reference's (train.py:148)
    use_ema_warmup: bool = True
    inv_gamma: float = 1.0
    power: float = 0.75


@dataclass
class EmaState:
    shadow_params: List[torch.Tensor]
    optimization_step: int = 0
    factor: Optional[torch.Tensor] = None  # 1 - the next update's decay, float32, on the shadow's device


def ema_init(params: Iterable[torch.Tensor]) -> EmaState:
    """Shadow copies of ``params`` (not aliases), step 0."""
    return EmaState([p.detach().clone() for p in params], 0)


def ema_decay_for_step(cfg: EmaConfig, optimization_step: int) -> float:
    """diffusers ``EMAModel.get_decay``: 0 up to ``update_after_step`` + 1,
    then ``1 - (1 + step / inv_gamma) ** -power`` (warmup) clipped to
    [min_decay, decay]. In float32, as the JAX package computes it."""
    step = max(int(optimization_step) - cfg.update_after_step - 1, 0)
    if step <= 0:
        return 0.0
    warm = np.float32(step)
    one = np.float32(1.0)
    if cfg.use_ema_warmup:
        cur = one - (one + warm / np.float32(cfg.inv_gamma)) ** np.float32(-cfg.power)
    else:
        cur = (one + warm) / (np.float32(10.0) + warm)
    return float(np.float32(max(min(cur, np.float32(cfg.decay)), np.float32(cfg.min_decay))))


def ema_begin(cfg: EmaConfig, state: EmaState) -> float:
    """The next update's decay ``d`` (of step ``optimization_step + 1``),
    with ``1 - d`` written into ``state.factor``. Host work: never inside a
    captured step, whose replays read the scalar."""
    decay = ema_decay_for_step(cfg, state.optimization_step + 1)
    if state.factor is None:
        state.factor = torch.zeros((), dtype=torch.float32, device=state.shadow_params[0].device)
    state.factor.fill_(float(np.float32(1.0) - np.float32(decay)))
    return decay


@torch.no_grad()
def ema_apply(state: EmaState, params: Iterable[torch.Tensor]) -> None:
    """The shadow moves by ``s - f (s - p)``, ``f`` the scalar
    :func:`ema_begin` wrote: device work only."""
    params = [p.detach().to(s.dtype) for s, p in zip(state.shadow_params, params)]
    diff = torch._foreach_sub(state.shadow_params, params)
    torch._foreach_mul_(diff, state.factor)
    torch._foreach_sub_(state.shadow_params, diff)


def ema_end(state: EmaState) -> None:
    state.optimization_step += 1


def ema_update(cfg: EmaConfig, state: EmaState, params: Iterable[torch.Tensor]) -> float:
    """One EMA step, in place: the step is incremented, then the shadow moves
    by ``s - (1 - d) (s - p)``. Returns the decay ``d`` used."""
    decay = ema_begin(cfg, state)
    ema_apply(state, params)
    ema_end(state)
    return decay
