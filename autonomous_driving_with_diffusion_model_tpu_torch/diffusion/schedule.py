"""Diffusion noise schedules and timestep tables (counterpart of the JAX
package's ``diffusion/schedule.py``; the scheduler math of diffusers==0.28.0,
which the reference pins). Tables are float32 tensors on the model's device.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple, Union

import numpy as np
import torch

__all__ = [
    "DiffusionSchedule",
    "compute_betas",
    "make_schedule",
    "make_schedule_from_cfg",
    "leading_timesteps",
    "add_noise",
]


def _betas_squaredcos_cap_v2(num_steps: int) -> np.ndarray:
    """Cosine alpha-bar schedule, beta capped at 0.999 (diffusers betas_for_alpha_bar)."""

    def alpha_bar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    return np.asarray(
        [min(1 - alpha_bar((i + 1) / num_steps) / alpha_bar(i / num_steps), 0.999) for i in range(num_steps)],
        dtype=np.float64,
    )


def compute_betas(
    schedule_type: str, num_steps: int, beta_start: float = 1e-4, beta_end: float = 0.02
) -> np.ndarray:
    if schedule_type == "linear":
        return np.linspace(beta_start, beta_end, num_steps, dtype=np.float64)
    if schedule_type == "scaled_linear":
        return np.linspace(beta_start**0.5, beta_end**0.5, num_steps, dtype=np.float64) ** 2
    if schedule_type == "squaredcos_cap_v2":
        return _betas_squaredcos_cap_v2(num_steps)
    raise ValueError(f"Unknown beta schedule: {schedule_type}")


class DiffusionSchedule(NamedTuple):
    betas: torch.Tensor  # (T,)
    alphas_cumprod: torch.Tensor  # (T,)
    final_alpha_cumprod: torch.Tensor  # () — DDIM set_alpha_to_one=True => 1.0
    num_train_timesteps: int

    def alpha_prod(self, t: Union[int, torch.Tensor]) -> torch.Tensor:
        return self.alphas_cumprod[t]

    def alpha_prod_prev(self, prev_t: Union[int, torch.Tensor]) -> torch.Tensor:
        """alphas_cumprod[prev_t], or the final value for prev_t < 0. A host
        ``int`` (the samplers' loop) takes one branch; a tensor of timesteps
        (distillation's per-row ``s``) is clamped, gathered, then selected
        row by row, as the JAX package does (JAX ``schedule.py:58-61``)."""
        if isinstance(prev_t, torch.Tensor):
            prev_t = prev_t.to(device=self.alphas_cumprod.device, dtype=torch.long)
            safe = self.alphas_cumprod[prev_t.clamp_min(0)]
            return torch.where(prev_t >= 0, safe, self.final_alpha_cumprod)
        return self.alphas_cumprod[prev_t] if prev_t >= 0 else self.final_alpha_cumprod

    def to(self, device) -> "DiffusionSchedule":
        return self._replace(
            betas=self.betas.to(device),
            alphas_cumprod=self.alphas_cumprod.to(device),
            final_alpha_cumprod=self.final_alpha_cumprod.to(device),
        )


def make_schedule(
    schedule_type: str = "squaredcos_cap_v2",
    num_train_timesteps: int = 100,
    beta_start: float = 1e-4,
    beta_end: float = 0.02,
    device=None,
) -> DiffusionSchedule:
    betas = compute_betas(schedule_type, num_train_timesteps, beta_start, beta_end)
    alphas_cumprod = np.cumprod(1.0 - betas)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return DiffusionSchedule(f32(betas), f32(alphas_cumprod), f32(1.0), num_train_timesteps)


def make_schedule_from_cfg(cfg, device=None) -> DiffusionSchedule:
    return make_schedule(
        cfg.TRAIN.NOISE_SCHEDULER.TYPE,
        cfg.TRAIN.SAMPLE_STEPS,
        cfg.TRAIN.NOISE_SCHEDULER.BETA_START,
        cfg.TRAIN.NOISE_SCHEDULER.BETA_END,
        device=device,
    )


def leading_timesteps(num_train_timesteps: int, num_inference_steps: int) -> Tuple[np.ndarray, np.ndarray]:
    """(timesteps, prev_timesteps) under diffusers' default "leading" spacing:
    ``(arange(n) * (T // n)).round()[::-1]``, prev = t - T // n."""
    step_ratio = num_train_timesteps // num_inference_steps
    timesteps = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
    return timesteps, timesteps - step_ratio


def add_noise(schedule: DiffusionSchedule, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Forward-noise x0 at the (B,) timesteps t (diffusers add_noise; train.py:234)."""
    ac = schedule.alphas_cumprod[t.to(torch.long)]
    shape = (-1,) + (1,) * (x0.ndim - 1)
    return torch.sqrt(ac).reshape(shape) * x0 + torch.sqrt(1.0 - ac).reshape(shape) * noise
