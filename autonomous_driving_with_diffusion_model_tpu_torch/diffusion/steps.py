"""DDPM/DDIM reverse steps and the inpainting blends (counterpart of the JAX
package's ``diffusion/steps.py``; reference:
scheduler/guidance_ddpm_scheduler.py:59-178,
scheduler/guidance_ddim_scheduler.py:23-173, scheduler/inpainting_*.py).
Timesteps are Python ints: the sampler's loop runs on the host and the math
on the device, so every branch on ``t`` or ``prev_t`` is a Python ``if``.
Distillation steps every row from its own timestep: :func:`ddim_step_rows`
takes (B,) tensors ``t`` and ``prev_t`` instead.
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
    "ddpm_variance",
    "ddim_variance",
    "ddpm_step",
    "ddim_step",
    "ddim_step_rows",
    "inpaint_blend_ddpm",
    "inpaint_blend_ddim",
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
    eta: float = 0.0  # DDIM only


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


def _ddpm_alpha_prev(schedule: DiffusionSchedule, prev_t: int) -> torch.Tensor:
    """alphas_cumprod[prev_t], or 1 for prev_t < 0 (DDPM's one, not the
    schedule's ``final_alpha_cumprod``)."""
    if prev_t >= 0:
        return schedule.alphas_cumprod[prev_t]
    return torch.ones((), dtype=schedule.alphas_cumprod.dtype, device=schedule.alphas_cumprod.device)


def ddpm_variance(schedule: DiffusionSchedule, t: int, prev_t: int) -> torch.Tensor:
    """fixed_small posterior variance, clamped at 1e-20 (diffusers _get_variance)."""
    ap_t = schedule.alpha_prod(t)
    ap_prev = _ddpm_alpha_prev(schedule, prev_t)
    variance = (1.0 - ap_prev) / (1.0 - ap_t) * (1.0 - ap_t / ap_prev)
    return variance.clamp_min(1e-20)


def ddim_variance(schedule: DiffusionSchedule, t: int, prev_t: int) -> torch.Tensor:
    ap_t = schedule.alpha_prod(t)
    ap_prev = schedule.alpha_prod_prev(prev_t)
    return ((1.0 - ap_prev) / (1.0 - ap_t)) * (1.0 - ap_t / ap_prev)


def _ddpm_mean(schedule: DiffusionSchedule, cfg: StepConfig, model_output, t, prev_t, sample):
    """(posterior mean of the DDPM step, clipped pred_x0)."""
    ap_t = schedule.alpha_prod(t)
    ap_prev = _ddpm_alpha_prev(schedule, prev_t)
    beta_prod_t = 1.0 - ap_t
    current_alpha_t = ap_t / ap_prev
    pred_x0, _ = pred_x0_and_eps(cfg, model_output, sample, ap_t)
    pred_x0 = clip_or_threshold(cfg, pred_x0)
    x0_coeff = torch.sqrt(ap_prev) * (1.0 - current_alpha_t) / beta_prod_t
    xt_coeff = torch.sqrt(current_alpha_t) * (1.0 - ap_prev) / beta_prod_t
    return x0_coeff * pred_x0 + xt_coeff * sample, pred_x0


def ddpm_step(
    schedule: DiffusionSchedule,
    cfg: StepConfig,
    model_output: torch.Tensor,
    t: int,
    prev_t: int,
    sample: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
):
    """One reverse DDPM step; ``noise`` (standard normal) is added, scaled by
    the posterior std, only where t > 0. Returns (prev_sample, pred_x0)."""
    prev_sample, pred_x0 = _ddpm_mean(schedule, cfg, model_output, t, prev_t, sample)
    if noise is not None and t > 0:
        prev_sample = prev_sample + torch.sqrt(ddpm_variance(schedule, t, prev_t)) * noise
    return prev_sample, pred_x0


def _ddim_update(schedule, cfg, model_output, t, prev_t, sample, use_clipped_model_output=False):
    """(deterministic DDIM update, clipped pred_x0, eta-scaled std, variance)."""
    ap_t = schedule.alpha_prod(t)
    ap_prev = schedule.alpha_prod_prev(prev_t)
    pred_x0, pred_eps = pred_x0_and_eps(cfg, model_output, sample, ap_t)
    pred_x0 = clip_or_threshold(cfg, pred_x0)
    variance = ddim_variance(schedule, t, prev_t)
    std_dev_t = cfg.eta * torch.sqrt(variance)
    if use_clipped_model_output:
        pred_eps = (sample - torch.sqrt(ap_t) * pred_x0) / torch.sqrt(1.0 - ap_t)
    direction = torch.sqrt(1.0 - ap_prev - std_dev_t**2) * pred_eps
    return torch.sqrt(ap_prev) * pred_x0 + direction, pred_x0, std_dev_t, variance


def ddim_step(
    schedule: DiffusionSchedule,
    cfg: StepConfig,
    model_output: torch.Tensor,
    t: int,
    prev_t: int,
    sample: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    use_clipped_model_output: bool = False,
):
    """One reverse DDIM step; eta > 0 adds ``eta * sqrt(variance) * noise``.
    Returns (prev_sample, pred_x0)."""
    prev_sample, pred_x0, std_dev_t, _ = _ddim_update(
        schedule, cfg, model_output, t, prev_t, sample, use_clipped_model_output
    )
    if cfg.eta > 0 and noise is not None:
        prev_sample = prev_sample + std_dev_t * noise
    return prev_sample, pred_x0


def ddim_step_rows(
    schedule: DiffusionSchedule,
    cfg: StepConfig,
    model_output: torch.Tensor,
    t: torch.Tensor,
    prev_t: torch.Tensor,
    sample: torch.Tensor,
) -> torch.Tensor:
    """The deterministic (eta = 0) DDIM step with a timestep per row: ``t``
    and ``prev_t`` are (B,) integer tensors (``prev_t`` < 0: the terminal
    step). The JAX package vmaps its scalar ``ddim_step`` over the rows
    (JAX ``diffusion/distill.py:256-258``); here the (B,) alphas broadcast as
    (B, 1, ..., 1). The x0 clip or dynamic threshold is per row already.
    Returns the prev sample."""
    if cfg.eta != 0:
        raise ValueError(f"ddim_step_rows takes eta = 0 only, got {cfg.eta}")
    shape = (-1,) + (1,) * (sample.ndim - 1)
    ap_t = schedule.alpha_prod(t.to(torch.long)).reshape(shape)
    ap_prev = schedule.alpha_prod_prev(prev_t).reshape(shape)
    pred_x0, pred_eps = pred_x0_and_eps(cfg, model_output, sample, ap_t)
    pred_x0 = clip_or_threshold(cfg, pred_x0)
    return torch.sqrt(ap_prev) * pred_x0 + torch.sqrt(1.0 - ap_prev) * pred_eps


def _blend_known(ap_prev, t, noise, prev_unknown, target_traj, target_mask):
    """RePaint Alg. 1 line 5: the known region re-noised from ``target_traj``
    (no noise at t = 0), blended in by ``target_mask`` (1 = known)."""
    if target_traj is None or target_mask is None:
        return prev_unknown
    prev_known = torch.sqrt(ap_prev) * target_traj
    if t > 0:
        prev_known = prev_known + torch.sqrt(1.0 - ap_prev) * noise
    return target_mask * prev_known + (1.0 - target_mask) * prev_unknown


def inpaint_blend_ddpm(
    schedule: DiffusionSchedule,
    cfg: StepConfig,
    model_output: torch.Tensor,
    t: int,
    prev_t: int,
    sample: torch.Tensor,
    noise: torch.Tensor,
    target_traj: Optional[torch.Tensor] = None,
    target_mask: Optional[torch.Tensor] = None,
):
    """RePaint-style DDPM step (reference: inpainting_ddpm_scheduler.py:10-146):
    the unknown region takes the posterior step (line 8), the known region is
    re-noised from ``target_traj``. Returns (prev_sample, pred_x0)."""
    prev_unknown, pred_x0 = ddpm_step(schedule, cfg, model_output, t, prev_t, sample, noise)
    ap_prev = _ddpm_alpha_prev(schedule, prev_t)
    return _blend_known(ap_prev, t, noise, prev_unknown, target_traj, target_mask), pred_x0


def inpaint_blend_ddim(
    schedule: DiffusionSchedule,
    cfg: StepConfig,
    model_output: torch.Tensor,
    t: int,
    prev_t: int,
    sample: torch.Tensor,
    noise: torch.Tensor,
    target_traj: Optional[torch.Tensor] = None,
    target_mask: Optional[torch.Tensor] = None,
    strict_reference: bool = True,
):
    """RePaint-style DDIM step (reference: inpainting_ddim_scheduler.py:10-153).

    ``strict_reference=True`` reproduces the reference, including its quirk
    of adding the scalar ``variance`` itself to the update
    (inpainting_ddim_scheduler.py:109-128; ``docs/PARITY.md`` "Reference
    quirks reproduced verbatim"); ``False`` gives the textbook eta-scaled
    update without it."""
    prev_unknown, pred_x0, _, variance = _ddim_update(schedule, cfg, model_output, t, prev_t, sample)
    if strict_reference:
        prev_unknown = prev_unknown + variance
    ap_prev = schedule.alpha_prod_prev(prev_t)
    return _blend_known(ap_prev, t, noise, prev_unknown, target_traj, target_mask), pred_x0
