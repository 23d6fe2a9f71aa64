from .distill import (
    DistillDraws,
    DistillGrid,
    DistillState,
    draw_distill,
    grid_chain,
    halve_grid,
    implied_x0_target,
    initial_grid,
    make_distill_step,
)
from .dpm import DPMCoeffs, dpm_coeffs, dpm_pp_2m_update, dpm_timesteps
from .guidance import GUIDANCE_LOSSES, build_loss_list, make_guidance_fn, target_guidance_loss
from .sampler import SamplerConfig, make_sampler, sampler_from_cfg
from .schedule import (
    DiffusionSchedule,
    add_noise,
    compute_betas,
    leading_timesteps,
    make_schedule,
    make_schedule_from_cfg,
)
from .steps import (
    StepConfig,
    clip_or_threshold,
    ddim_step,
    ddim_step_rows,
    ddim_variance,
    ddpm_step,
    ddpm_variance,
    dynamic_threshold,
    inpaint_blend_ddim,
    inpaint_blend_ddpm,
    pred_x0_and_eps,
)

# the scheduler registry (reference: scheduler/__init__.py and the
# SCHEDULER_FUNC maps at interact.py:22-25); "dpm" is dispatched inside
# make_sampler, since its multistep update carries the x0 history
SCHEDULER_FUNC = {"ddpm": ddpm_step, "ddim": ddim_step, "dpm": dpm_pp_2m_update}
INPAINTING_SCHEDULER_FUNC = {"ddpm": inpaint_blend_ddpm, "ddim": inpaint_blend_ddim}

__all__ = [
    "DistillDraws",
    "DistillGrid",
    "DistillState",
    "draw_distill",
    "grid_chain",
    "halve_grid",
    "implied_x0_target",
    "initial_grid",
    "make_distill_step",
    "SCHEDULER_FUNC",
    "INPAINTING_SCHEDULER_FUNC",
    "GUIDANCE_LOSSES",
    "build_loss_list",
    "make_guidance_fn",
    "target_guidance_loss",
    "SamplerConfig",
    "make_sampler",
    "sampler_from_cfg",
    "DiffusionSchedule",
    "add_noise",
    "compute_betas",
    "leading_timesteps",
    "make_schedule",
    "make_schedule_from_cfg",
    "StepConfig",
    "DPMCoeffs",
    "dpm_timesteps",
    "dpm_coeffs",
    "dpm_pp_2m_update",
    "clip_or_threshold",
    "ddpm_step",
    "ddim_step",
    "ddim_step_rows",
    "ddpm_variance",
    "ddim_variance",
    "dynamic_threshold",
    "inpaint_blend_ddpm",
    "inpaint_blend_ddim",
    "pred_x0_and_eps",
]
