from .guidance import GUIDANCE_LOSSES, build_loss_list, make_guidance_fn, target_guidance_loss
from .sampler import SamplerConfig, make_sampler, sampler_from_cfg
from .schedule import (
    DiffusionSchedule,
    compute_betas,
    leading_timesteps,
    make_schedule,
    make_schedule_from_cfg,
)
from .steps import (
    StepConfig,
    clip_or_threshold,
    ddim_step,
    ddim_variance,
    dynamic_threshold,
    pred_x0_and_eps,
)

__all__ = [
    "GUIDANCE_LOSSES",
    "build_loss_list",
    "make_guidance_fn",
    "target_guidance_loss",
    "SamplerConfig",
    "make_sampler",
    "sampler_from_cfg",
    "DiffusionSchedule",
    "compute_betas",
    "leading_timesteps",
    "make_schedule",
    "make_schedule_from_cfg",
    "StepConfig",
    "clip_or_threshold",
    "ddim_step",
    "ddim_variance",
    "dynamic_threshold",
    "pred_x0_and_eps",
]
