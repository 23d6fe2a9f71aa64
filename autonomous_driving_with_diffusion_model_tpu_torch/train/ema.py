"""Exponential moving average of parameters, diffusers-compatible
(counterpart of the JAX package's ``train/ema.py``).

``diffusers.training_utils.EMAModel`` as the reference trains with it
(train.py:146-153: update_after_step 5000, use_ema_warmup): each update
first increments the step, then computes the decay, then moves every shadow
parameter by ``s - (1 - d) (s - p)``. ``shadow_params`` is a list in
``model.parameters()`` order, the reference ``ema_state_dict``'s.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, NamedTuple

import numpy as np
import torch

__all__ = ["EmaConfig", "EmaState", "ema_init", "ema_decay_for_step", "ema_update"]


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


@torch.no_grad()
def ema_update(cfg: EmaConfig, state: EmaState, params: Iterable[torch.Tensor]) -> float:
    """One EMA step, in place: the step is incremented, then the shadow moves
    by ``s - (1 - d) (s - p)``. Returns the decay ``d`` used."""
    state.optimization_step += 1
    decay = ema_decay_for_step(cfg, state.optimization_step)
    params = [p.detach().to(s.dtype) for s, p in zip(state.shadow_params, params)]
    diff = torch._foreach_sub(state.shadow_params, params)
    torch._foreach_mul_(diff, float(np.float32(1.0) - np.float32(decay)))
    torch._foreach_sub_(state.shadow_params, diff)
    return decay
