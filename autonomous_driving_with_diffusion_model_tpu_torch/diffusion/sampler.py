"""The DDIM trajectory sampler (counterpart of the JAX package's
``diffusion/sampler.py``; reference: interact.py:115-168).

The JAX package fuses the loop into one ``lax.scan``; here it is a Python
loop over the timestep grid that queues device work without waiting on it
(the timesteps are host integers), under ``torch.no_grad()``. As there:

* the perception encoder runs once per plan (``hoist_perception``), or in
  every step for the reference's execution (numerically the same);
* ``init_trajs`` and ``noise_seq`` can be injected, so parity runs share
  their random numbers;
* every step zeroes the first waypoint's (x, y, yaw), and the result is
  clamped to [-1, 1] with xy scaled to meters.

The DDPM and DPM-Solver++ schedulers and inpainting are a later slice.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.constants import ANCHOR_DIMS, MAGIC_NUM, GuidanceType
from .guidance import make_guidance_fn
from .schedule import DiffusionSchedule, leading_timesteps
from .steps import StepConfig, ddim_step, ddim_variance

__all__ = ["SamplerConfig", "make_sampler", "sampler_from_cfg"]


class SamplerConfig(NamedTuple):
    guidance: GuidanceType = GuidanceType.NO_GUIDANCE
    scheduler: str = "ddim"
    num_steps: int = 100
    step: StepConfig = StepConfig()
    free_scale: float = 1.0
    classifier_scale: float = 0.1
    guidance_step: int = 1
    loss_list: Optional[Sequence] = None
    hoist_perception: bool = True
    scale_to_meters: bool = True
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
    if cfg.timesteps is None:
        return leading_timesteps(schedule.num_train_timesteps, cfg.num_steps)
    ts = np.asarray(cfg.timesteps, np.int64)
    if ts.ndim != 1 or len(ts) == 0 or np.any(np.diff(ts) >= 0):
        raise ValueError(f"SamplerConfig.timesteps must be strictly decreasing, got {cfg.timesteps}")
    if ts[0] >= schedule.num_train_timesteps or ts[-1] < 0:
        raise ValueError(f"timesteps out of [0, {schedule.num_train_timesteps}): {cfg.timesteps}")
    return ts, np.concatenate([ts[1:], [-1]])


def make_sampler(model, schedule: DiffusionSchedule, cfg: SamplerConfig) -> Callable:
    """``sample(init_trajs, image=None, img_feature=None, target=None,
    noise_seq=None) -> trajs``.

    * ``init_trajs``  (B, H, D) starting noise;
    * ``image``       (B, h, w, 3) normalized NHWC image, or ``img_feature``
      (B, dim) precomputed;
    * ``target``      (B, 2) ego-frame target point (guided modes);
    * ``noise_seq``   (S, B, H, D) step noise, used when ``step.eta > 0``.
    """
    if cfg.scheduler != "ddim":
        raise NotImplementedError(
            f"scheduler {cfg.scheduler!r}: the port has DDIM; DDPM and DPM-Solver++ are a later slice"
        )
    if cfg.inpainting:
        raise NotImplementedError("inpainting samplers are a later slice of the port")
    ts, prev_ts = (tuple(int(v) for v in a) for a in _grid(schedule, cfg))
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
    ) -> torch.Tensor:
        B = init_trajs.shape[0]
        trajs = _anchor(init_trajs)
        if img_feature is None and cfg.hoist_perception:
            img_feature = model.encode_image(image)
        if cfg.step.eta > 0 and noise_seq is None:
            raise ValueError("step.eta > 0 needs noise_seq (S, B, H, D)")
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
                out_cond, out_uncond = out.chunk(2, dim=0)
                return out_uncond + cfg.free_scale * (out_cond - out_uncond), None
            if cfg.guidance == GuidanceType.CLASSIFIER_GUIDANCE:
                action, time_embed = model(trajs, time=t_b, return_action_and_time_only=True, **feat)
                state = model.predict_state(action, time_embed)
                return torch.cat([state, action], dim=-1), (action, time_embed)
            return model(trajs, time=t_b, **feat), None

        for i, (t, prev_t) in enumerate(zip(ts, prev_ts)):
            t_b = torch.full((B,), float(t), dtype=torch.float32, device=trajs.device)
            model_output, aux = model_fwd(trajs, t_b)
            if cfg.guidance == GuidanceType.CLASSIFIER_GUIDANCE and target is not None:
                # guidance math runs in float32, like all scheduler math here
                action, time_embed = aux
                grad_scale = torch.exp(0.5 * ddim_variance(schedule, t, prev_t))
                model_output = guide_fn(time_embed)(
                    model_output.to(torch.float32), action.to(torch.float32), target, grad_scale
                )
            noise = noise_seq[i] if noise_seq is not None else None
            trajs, _ = ddim_step(schedule, cfg.step, model_output, t, prev_t, trajs, noise)
            trajs = _anchor(trajs)

        trajs = trajs.to(torch.float32).clamp(-1.0, 1.0)
        if cfg.scale_to_meters:
            trajs = torch.cat([trajs[..., :2] * MAGIC_NUM, trajs[..., 2:]], dim=-1)
        return trajs

    return sample


def sampler_from_cfg(model, schedule: DiffusionSchedule, cfg) -> Callable:
    """The closed-loop agents' sampler for a framework config (interact.py:81-94:
    thresholding on, EVAL.SCHEDULER, EVAL.SAMPLE_STEPS or TPU.SAMPLE_TIMESTEPS)."""
    grid = tuple(int(t) for t in cfg.TPU.SAMPLE_TIMESTEPS) or None
    scfg = SamplerConfig(
        guidance=GuidanceType[cfg.GUIDANCE.USE_COND],
        scheduler=cfg.EVAL.SCHEDULER,
        num_steps=cfg.EVAL.SAMPLE_STEPS,
        timesteps=grid,
        step=StepConfig(
            prediction_type=cfg.TRAIN.NOISE_SCHEDULER.PRED_TYPE, clip_sample=True, thresholding=True
        ),
        free_scale=cfg.GUIDANCE.FREE_SCALE,
        classifier_scale=cfg.GUIDANCE.CLASSIFIER_SCALE,
        guidance_step=cfg.GUIDANCE.STEP,
        loss_list=cfg.GUIDANCE.LOSS_LIST,
        hoist_perception=bool(cfg.TPU.HOIST_PERCEPTION),
        scale_to_meters=True,
    )
    return make_sampler(model, schedule, scfg)
