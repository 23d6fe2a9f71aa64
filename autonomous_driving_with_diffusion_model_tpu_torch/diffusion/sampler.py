"""Trajectory samplers: DDIM, DDPM and DPM-Solver++(2M), with the three
guidance modes and RePaint-style inpainting (counterpart of the JAX
package's ``diffusion/sampler.py``; reference: interact.py:115-168,
e2e_driving/diffusion_agent.py:179-232, train.py:53-103).

The JAX package fuses the loop into one ``lax.scan``; here it is a Python
loop over the timestep grid that queues device work without waiting on it
(the timesteps are host integers, the per-step DPM coefficients device
tensors made once), under ``torch.no_grad()``. As there:

* the perception encoder runs once per plan (``hoist_perception``), or in
  every step for the reference's execution (numerically the same);
* ``init_trajs`` and ``noise_seq`` can be injected, so parity runs share
  their random numbers; otherwise the step noise is drawn before the loop,
  all steps at once, from the caller's ``torch.Generator``;
* every step zeroes the first waypoint's (x, y, yaw), and the result is
  clamped to [-1, 1] with xy scaled to meters;
* the scheduler and guidance math runs in float32 whatever the model
  computes in: a bfloat16 model's output is cast to float32 as it leaves
  the model, and the result is float32.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.constants import ANCHOR_DIMS, MAGIC_NUM, GuidanceType
from .dpm import dpm_coeffs, dpm_pp_2m_update, dpm_timesteps
from .guidance import make_guidance_fn
from .schedule import DiffusionSchedule, leading_timesteps
from .steps import (
    StepConfig,
    clip_or_threshold,
    ddim_step,
    ddim_variance,
    ddpm_step,
    ddpm_variance,
    inpaint_blend_ddim,
    inpaint_blend_ddpm,
    pred_x0_and_eps,
)

__all__ = ["SamplerConfig", "make_sampler", "sampler_from_cfg"]


class SamplerConfig(NamedTuple):
    guidance: GuidanceType = GuidanceType.NO_GUIDANCE
    scheduler: str = "ddim"  # "ddim" | "ddpm" | "dpm" (DPM-Solver++ 2M, diffusion/dpm.py)
    num_steps: int = 100
    step: StepConfig = StepConfig()
    free_scale: float = 1.0
    classifier_scale: float = 0.1
    guidance_step: int = 1
    loss_list: Optional[Sequence] = None
    hoist_perception: bool = True
    scale_to_meters: bool = True
    # RePaint-style inpainting: blend a known trajectory region
    # (target_traj/target_mask at call time) into every reverse step
    inpainting: bool = False
    # explicit denoising grid (strictly decreasing train-timestep indices)
    # overriding the "leading" spacing; prev of the last entry is -1
    timesteps: Optional[Tuple[int, ...]] = None


def _anchor(trajs: torch.Tensor) -> torch.Tensor:
    """Zero the first waypoint's (x, y, yaw) (reference: interact.py:129,164)."""
    trajs = trajs.clone()
    trajs[:, 0, :ANCHOR_DIMS] = 0.0
    return trajs


def _grid(schedule: DiffusionSchedule, cfg: SamplerConfig):
    if cfg.timesteps is not None:
        ts = np.asarray(cfg.timesteps, np.int64)
        if ts.ndim != 1 or len(ts) == 0 or np.any(np.diff(ts) >= 0):
            raise ValueError(f"SamplerConfig.timesteps must be strictly decreasing, got {cfg.timesteps}")
        if ts[0] >= schedule.num_train_timesteps or ts[-1] < 0:
            raise ValueError(f"timesteps out of [0, {schedule.num_train_timesteps}): {cfg.timesteps}")
    elif cfg.scheduler == "dpm":
        ts = dpm_timesteps(schedule, cfg.num_steps)  # the reference's lambda clip, -5.1
    else:
        return leading_timesteps(schedule.num_train_timesteps, cfg.num_steps)
    return ts, np.concatenate([ts[1:], [-1]])


def make_sampler(model, schedule: DiffusionSchedule, cfg: SamplerConfig) -> Callable:
    """``sample(init_trajs, image=None, img_feature=None, target=None,
    noise_seq=None, target_traj=None, target_mask=None, generator=None) -> trajs``.

    * ``init_trajs``  (B, H, D) starting noise;
    * ``image``       (B, h, w, 3) normalized NHWC image, or ``img_feature``
      (B, dim) precomputed;
    * ``target``      (B, 2) ego-frame target point (guided modes);
    * ``noise_seq``   (S, B, H, D) step noise for DDPM, DDIM with eta > 0 and
      inpainting; without it, ``generator`` (a ``torch.Generator``) draws it,
      all S steps before the loop, on its own device;
    * ``target_traj``/``target_mask`` (B, H, D) the known region (inpainting).

    The returned function carries ``num_steps`` and ``needs_noise``.
    """
    if cfg.scheduler not in ("ddim", "ddpm", "dpm"):
        raise ValueError(f"unknown scheduler {cfg.scheduler!r} (expected ddim | ddpm | dpm)")
    use_dpm, use_ddpm = cfg.scheduler == "dpm", cfg.scheduler == "ddpm"
    if use_dpm:
        if cfg.inpainting:
            raise ValueError("inpainting is DDPM/DDIM-only (like the reference)")
        if cfg.step.eta:
            raise ValueError("the dpm solver is a deterministic ODE solve; eta is unsupported")
    if cfg.inpainting and cfg.guidance != GuidanceType.NO_GUIDANCE:
        raise ValueError("inpainting samplers have no guidance hook (like the reference)")
    ts_np, prev_np = _grid(schedule, cfg)
    ts, prev_ts = tuple(int(v) for v in ts_np), tuple(int(v) for v in prev_np)
    num_steps = len(ts)
    needs_noise = use_ddpm or cfg.step.eta > 0 or cfg.inpainting
    # classifier-guidance grad scale: DPM++ shares DDIM's (eta 0) marginals
    var_fn = ddpm_variance if use_ddpm else ddim_variance
    step_fn = ddpm_step if use_ddpm else ddim_step
    blend_fn = inpaint_blend_ddpm if use_ddpm else inpaint_blend_ddim
    coeffs = dpm_coeffs(schedule, ts_np, prev_np) if use_dpm else None
    guide_fn = None
    if cfg.guidance == GuidanceType.CLASSIFIER_GUIDANCE:
        guide_fn = lambda time_embed: make_guidance_fn(
            cfg.loss_list, cfg.classifier_scale, cfg.guidance_step,
            lambda a: model.predict_state(a, time_embed),
        )

    @torch.no_grad()
    def sample(
        init_trajs: torch.Tensor,
        image: Optional[torch.Tensor] = None,
        img_feature: Optional[torch.Tensor] = None,
        target: Optional[torch.Tensor] = None,
        noise_seq: Optional[torch.Tensor] = None,
        target_traj: Optional[torch.Tensor] = None,
        target_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        B = init_trajs.shape[0]
        trajs = _anchor(init_trajs.to(torch.float32))
        if img_feature is None and cfg.hoist_perception:
            img_feature = model.encode_image(image)
        if needs_noise and noise_seq is None:
            if generator is None:
                raise ValueError(
                    f"the {cfg.scheduler} sampler needs step noise: pass noise_seq "
                    f"({num_steps}, B, H, D) or a torch.Generator"
                )
            noise_seq = torch.randn((num_steps,) + tuple(trajs.shape), generator=generator,
                                    dtype=torch.float32, device=generator.device)
        if noise_seq is not None:
            noise_seq = noise_seq.to(trajs.device, torch.float32)
        feat = dict(img_feature=img_feature) if cfg.hoist_perception else dict(img=image)
        free = cfg.guidance == GuidanceType.FREE_GUIDANCE and target is not None
        cfg_target = None
        if free and cfg.free_scale != 1.0:
            # dual batch: [target; zeros] (reference: interact.py:119-127)
            cfg_target = torch.cat([target, torch.zeros_like(target)], dim=0)

        def model_fwd(trajs, t_b):
            if free and cfg_target is None:
                # u + 1*(c - u) == c: one forward per step
                return model(trajs, time=t_b, cond=target, **feat), None
            if cfg_target is not None:
                out = model(torch.cat([trajs, trajs], dim=0), time=t_b, cond=cfg_target, **feat)
                out_cond, out_uncond = out.to(torch.float32).chunk(2, dim=0)
                return out_uncond + cfg.free_scale * (out_cond - out_uncond), None
            if cfg.guidance == GuidanceType.CLASSIFIER_GUIDANCE:
                action, time_embed = model(trajs, time=t_b, return_action_and_time_only=True, **feat)
                state = model.predict_state(action, time_embed)
                return torch.cat([state, action], dim=-1), (action, time_embed)
            return model(trajs, time=t_b, **feat), None

        def guided_output(trajs, t, prev_t):
            t_b = torch.full((B,), float(t), dtype=torch.float32, device=trajs.device)
            model_output, aux = model_fwd(trajs, t_b)
            model_output = model_output.to(torch.float32)
            if cfg.guidance == GuidanceType.CLASSIFIER_GUIDANCE and target is not None:
                action, time_embed = aux
                grad_scale = torch.exp(0.5 * var_fn(schedule, t, prev_t))
                model_output = guide_fn(time_embed)(
                    model_output, action.to(torch.float32), target, grad_scale
                )
            return model_output

        if use_dpm:
            prev_x0 = torch.zeros_like(trajs)  # the multistep's x0 history
            for i, (t, prev_t) in enumerate(zip(ts, prev_ts)):
                model_output = guided_output(trajs, t, prev_t)
                pred_x0, _ = pred_x0_and_eps(cfg.step, model_output, trajs, schedule.alpha_prod(t))
                pred_x0 = clip_or_threshold(cfg.step, pred_x0)
                trajs = _anchor(dpm_pp_2m_update(trajs, pred_x0, prev_x0, coeffs.sigma_ratio[i],
                                                 coeffs.phi[i], coeffs.inv_r[i]))
                prev_x0 = pred_x0
        else:
            for i, (t, prev_t) in enumerate(zip(ts, prev_ts)):
                model_output = guided_output(trajs, t, prev_t)
                noise = noise_seq[i] if noise_seq is not None else None
                if cfg.inpainting:
                    trajs, _ = blend_fn(schedule, cfg.step, model_output, t, prev_t, trajs, noise,
                                        target_traj=target_traj, target_mask=target_mask)
                else:
                    trajs, _ = step_fn(schedule, cfg.step, model_output, t, prev_t, trajs, noise)
                trajs = _anchor(trajs)

        trajs = trajs.clamp(-1.0, 1.0)
        if cfg.scale_to_meters:
            trajs = torch.cat([trajs[..., :2] * MAGIC_NUM, trajs[..., 2:]], dim=-1)
        return trajs

    sample.num_steps = num_steps
    sample.needs_noise = needs_noise
    return sample


def sampler_from_cfg(model, schedule: DiffusionSchedule, cfg, *, for_training_eval: bool = False) -> Callable:
    """The sampler for a framework config.

    ``for_training_eval=True`` is ``train.evaluate``'s (train.py:53-103): the
    training DDPM scheduler (clip, no thresholding), TRAIN.TIME_STEPS steps,
    no conditioning and no meters scaling. Otherwise the closed-loop agents'
    (interact.py:81-94): thresholding on, EVAL.SCHEDULER, EVAL.SAMPLE_STEPS
    or TPU.SAMPLE_TIMESTEPS."""
    step = StepConfig(prediction_type=cfg.TRAIN.NOISE_SCHEDULER.PRED_TYPE, clip_sample=True,
                      thresholding=not for_training_eval)
    if for_training_eval:
        scfg = SamplerConfig(
            scheduler="ddpm",
            num_steps=cfg.TRAIN.TIME_STEPS,
            step=step,
            hoist_perception=bool(cfg.TPU.HOIST_PERCEPTION),
            scale_to_meters=False,
        )
    else:
        scfg = SamplerConfig(
            guidance=GuidanceType[cfg.GUIDANCE.USE_COND],
            scheduler=cfg.EVAL.SCHEDULER,
            num_steps=cfg.EVAL.SAMPLE_STEPS,
            timesteps=tuple(int(t) for t in cfg.TPU.SAMPLE_TIMESTEPS) or None,
            step=step,
            free_scale=cfg.GUIDANCE.FREE_SCALE,
            classifier_scale=cfg.GUIDANCE.CLASSIFIER_SCALE,
            guidance_step=cfg.GUIDANCE.STEP,
            loss_list=cfg.GUIDANCE.LOSS_LIST,
            hoist_perception=bool(cfg.TPU.HOIST_PERCEPTION),
            scale_to_meters=True,
        )
    return make_sampler(model, schedule, scfg)
