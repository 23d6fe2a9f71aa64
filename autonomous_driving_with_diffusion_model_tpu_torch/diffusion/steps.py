"""DDIM reverse steps (counterpart of the JAX package's ``diffusion/steps.py``;
reference: scheduler/guidance_ddim_scheduler.py:23-173). Timesteps are
Python ints: the sampler's loop runs on the host and the math on the device.
DDPM and the inpainting blends are a later slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .schedule import DiffusionSchedule

__all__ = [
    "StepConfig",
    "dynamic_threshold",
    "clip_or_threshold",
    "pred_x0_and_eps",
    "ddim_variance",
    "ddim_step",
]


class StepConfig(NamedTuple):
    """Scheduler options (the diffusers config surface the reference uses;
    defaults match diffusers==0.28.0)."""

    prediction_type: str = "sample"  # "epsilon" | "sample" | "v_prediction"
    clip_sample: bool = True
    clip_sample_range: float = 1.0
    thresholding: bool = False
    dynamic_thresholding_ratio: float = 0.995
    sample_max_value: float = 1.0
    eta: float = 0.0


def dynamic_threshold(sample: torch.Tensor, ratio: float, max_value: float) -> torch.Tensor:
    """Imagen dynamic thresholding: per-sample quantile of |x| over all
    non-batch dims (linear interpolation, as ``jnp.quantile``); clamp to
    [-s, s] / s with s in [1, max_value]."""
    b = sample.shape[0]
    flat = sample.reshape(b, -1).abs().to(torch.float32)
    s = torch.quantile(flat, ratio, dim=1).clamp(1.0, max_value)
    s = s.reshape((b,) + (1,) * (sample.ndim - 1))
    return (torch.minimum(torch.maximum(sample, -s), s) / s).to(sample.dtype)


def pred_x0_and_eps(cfg: StepConfig, model_output, sample, alpha_prod_t):
    """Recover (pred_x0, pred_eps) per prediction type (DDIM formula 12)."""
    beta_prod_t = 1.0 - alpha_prod_t
    sa, sb = torch.sqrt(alpha_prod_t), torch.sqrt(beta_prod_t)
    if cfg.prediction_type == "epsilon":
        return (sample - sb * model_output) / sa, model_output
    if cfg.prediction_type == "sample":
        return model_output, (sample - sa * model_output) / sb
    if cfg.prediction_type == "v_prediction":
        return sa * sample - sb * model_output, sa * model_output + sb * sample
    raise ValueError(f"prediction_type {cfg.prediction_type}")


def clip_or_threshold(cfg: StepConfig, pred_x0: torch.Tensor) -> torch.Tensor:
    """The configured x0 post-processing (threshold wins over clip)."""
    if cfg.thresholding:
        return dynamic_threshold(pred_x0, cfg.dynamic_thresholding_ratio, cfg.sample_max_value)
    if cfg.clip_sample:
        return pred_x0.clamp(-cfg.clip_sample_range, cfg.clip_sample_range)
    return pred_x0


def ddim_variance(schedule: DiffusionSchedule, t: int, prev_t: int) -> torch.Tensor:
    ap_t = schedule.alpha_prod(t)
    ap_prev = schedule.alpha_prod_prev(prev_t)
    return ((1.0 - ap_prev) / (1.0 - ap_t)) * (1.0 - ap_t / ap_prev)


def ddim_step(
    schedule: DiffusionSchedule,
    cfg: StepConfig,
    model_output: torch.Tensor,
    t: int,
    prev_t: int,
    sample: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
):
    """One reverse DDIM step; eta > 0 adds ``eta * sqrt(variance) * noise``.
    Returns (prev_sample, pred_x0)."""
    ap_t = schedule.alpha_prod(t)
    ap_prev = schedule.alpha_prod_prev(prev_t)
    pred_x0, pred_eps = pred_x0_and_eps(cfg, model_output, sample, ap_t)
    pred_x0 = clip_or_threshold(cfg, pred_x0)
    std_dev_t = cfg.eta * torch.sqrt(ddim_variance(schedule, t, prev_t))
    prev_sample = torch.sqrt(ap_prev) * pred_x0 + torch.sqrt(1.0 - ap_prev - std_dev_t**2) * pred_eps
    if cfg.eta > 0 and noise is not None:
        prev_sample = prev_sample + std_dev_t * noise
    return prev_sample, pred_x0
