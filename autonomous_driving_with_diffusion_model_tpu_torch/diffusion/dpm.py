"""DPM-Solver++(2M) (counterpart of the JAX package's ``diffusion/dpm.py``).

The reference configures a "dpm" scheduler (interact.py:92-93 sets
``lambda_min_clipped = -5.1``) that its registry lacks; the JAX package
implements what that branch intends: diffusers'
``DPMSolverMultistepScheduler`` with ``algorithm_type="dpmsolver++"``,
``solver_order=2``, data prediction, a first-order final step and the
"linspace" grid with lambda clipping (Lu et al. 2022). This is its copy.
The clip is the caller's: the reference's -5.1, or diffusers' default
-inf, which trims nothing (RDT-1B's 5 steps: 999, 799, 599, 400, 200).

Every per-step coefficient is computed on the host in float64, including the
exact ``sigma -> 0`` terminal limit, and handed to the device once as float32
tensors; each solver step is then three elementwise ops. The first-order
update is the eta = 0 DDIM step.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .schedule import DiffusionSchedule

__all__ = ["DPMCoeffs", "dpm_timesteps", "dpm_coeffs", "dpm_pp_2m_update"]


def _alphas_cumprod(schedule: DiffusionSchedule) -> np.ndarray:
    return schedule.alphas_cumprod.detach().cpu().numpy().astype(np.float64)


def dpm_timesteps(
    schedule: DiffusionSchedule, num_inference_steps: int, lambda_min_clipped: float = -5.1
) -> np.ndarray:
    """The DPMSolverMultistep "linspace" grid: train timesteps whose
    half-log-SNR lies below ``lambda_min_clipped`` are trimmed before the
    linspace, and 0 is dropped (the last step targets sigma = 0 through
    ``prev_timestep = -1``). A strictly decreasing int64 grid."""
    ac = _alphas_cumprod(schedule)
    lam = 0.5 * (np.log(ac) - np.log1p(-ac))
    # lam decreases with t; count the trailing timesteps below the clip
    clipped_idx = int(np.searchsorted(lam[::-1], lambda_min_clipped))
    last_timestep = schedule.num_train_timesteps - clipped_idx
    if last_timestep < 1:
        raise ValueError(f"lambda_min_clipped={lambda_min_clipped} clips every timestep")
    ts = np.linspace(0, last_timestep - 1, num_inference_steps + 1).round()[::-1][:-1].astype(np.int64)
    if np.any(np.diff(ts) >= 0):
        raise ValueError(
            f"num_inference_steps={num_inference_steps} too large for the "
            f"{last_timestep} usable train timesteps (grid has duplicates)"
        )
    return ts


class DPMCoeffs(NamedTuple):
    """Per-step update coefficients, float32 tensors of shape (S,):
    ``x_prev = sigma_ratio * x - phi * (x0 + 0.5 * inv_r * (x0 - x0_prev))``
    with ``sigma_ratio = sigma_prev / sigma_t``, ``phi = alpha_prev *
    expm1(-h)``, ``h = lambda_prev - lambda_t`` and ``inv_r = h / h_prev``,
    0 on first-order steps (the first, the last, and any step whose h is not
    finite: the terminal limit where the update collapses to ``x0``)."""

    sigma_ratio: torch.Tensor
    phi: torch.Tensor
    inv_r: torch.Tensor


def dpm_coeffs(schedule: DiffusionSchedule, timesteps: np.ndarray, prev_timesteps: np.ndarray) -> DPMCoeffs:
    """The per-step tables, computed in float64 on the host and put on the
    schedule's device as float32."""
    ac = _alphas_cumprod(schedule)
    final_ac = float(schedule.final_alpha_cumprod)

    def alpha_sigma(t):
        t = np.asarray(t, np.int64)
        ap = np.where(t >= 0, ac[np.maximum(t, 0)], final_ac)
        return np.sqrt(ap), np.sqrt(1.0 - ap)

    a_t, s_t = alpha_sigma(timesteps)
    a_p, s_p = alpha_sigma(prev_timesteps)
    with np.errstate(divide="ignore", invalid="ignore"):
        h = (np.log(a_p) - np.log(s_p)) - (np.log(a_t) - np.log(s_t))  # +inf at sigma_prev = 0
        sigma_ratio = s_p / s_t
        phi = a_p * np.expm1(-h)  # expm1(-inf) = -1: phi = -alpha_prev exactly
        h_prev = np.concatenate([[np.nan], h[:-1]])
        first_order = np.zeros(len(timesteps), dtype=bool)
        first_order[0] = first_order[-1] = True
        first_order |= ~np.isfinite(h) | ~np.isfinite(h_prev)
        inv_r = np.where(first_order, 0.0, h / h_prev)
    if not (np.isfinite(sigma_ratio).all() and np.isfinite(phi).all() and np.isfinite(inv_r).all()):
        raise ValueError("non-finite DPM-Solver++ coefficients (degenerate grid)")
    dev = schedule.alphas_cumprod.device
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return DPMCoeffs(f32(sigma_ratio), f32(phi), f32(inv_r))


def dpm_pp_2m_update(sample, pred_x0, prev_x0, sigma_ratio, phi, inv_r):
    """One DPM-Solver++(2M) midpoint step (first-order when inv_r == 0)."""
    d = pred_x0 + 0.5 * inv_r * (pred_x0 - prev_x0)
    return sigma_ratio * sample - phi * d
