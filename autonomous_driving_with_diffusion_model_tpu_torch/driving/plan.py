"""DiffusionPlanner: the closed-loop planning engine (counterpart of the JAX
package's ``driving/plan.py``; reference: interact.py:54-168,
e2e_driving/diffusion_agent.py:45-232).

One plan normalizes the uint8 frame on the device, encodes it once, denoises
K hypotheses in one batch, scores them and returns the best. On the card
that whole plan is one CUDA graph per input shape (``driving/program.py``,
the counterpart of the JAX planner's ``jax.jit(_plan)``): ``plan_begin``
copies the inputs into the graph's buffers, queues its replay on the current
CUDA stream and returns device tensors without waiting; ``plan_fetch``
waits. ``_plan`` is the eager body the graph captures. Weights come from a
seed, or from a reference ``.pth`` (``state_dict`` + EMA shadow overwrite)
or the port's own checkpoint (its EMA shadow), as the distill CLI writes for
other encoders.

Random numbers come from the planner's CPU generator, so the GPU and the CPU
planner of one seed draw the same: the init trajectories, and the step noise
of the samplers that need it (DDPM, DDIM with eta > 0, inpainting), both
drawn once at construction under ``TPU.FIXED_INIT_NOISE`` (the JAX planner's
fixed noise key) and afresh for every plan otherwise, then copied to the
device once per plan. ``init_trajs`` and ``step_noise`` are settable, so a
test can inject the JAX planner's.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

from ..data.augment import normalize_images
from ..diffusion.guidance import target_guidance_loss
from ..diffusion.sampler import sampler_from_cfg
from ..diffusion.schedule import make_schedule_from_cfg
from ..models.scorer import HypothesisScorer, load_scorer
from ..models.temporal_unet import build_model
from ..train.checkpoint import load_eval_state_dict
from ..utils.constants import MAGIC_NUM, GuidanceType
from ..utils.device import resolve_device
from .program import PlanProgram

__all__ = ["DiffusionPlanner", "process_next_waypoint", "agent_to_world", "way_point_to_pixel"]


def way_point_to_pixel(waypoint: float, magic_num: float = 1.0) -> int:
    """Waypoint -> BEV pixel: 256 - 256*w/magic (reference: train.py:48-50,
    diffusion_agent.py:35-37)."""
    return int(256 - waypoint / magic_num * 256)


def process_next_waypoint(next_point, cur_point, yaw):
    """World -> ego-frame target point (reference: interact.py:185-202): rotate
    by theta = yaw + pi/2, then [local_y, -local_x] / magic_num."""
    if math.isnan(yaw):
        yaw = 0.0
    theta = yaw + math.pi / 2.0
    R = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    local = np.asarray(next_point, np.float64) - np.asarray(cur_point, np.float64)
    local = R.T.dot(local.reshape(-1, 2).T).T
    return (np.stack([local[:, 1], -local[:, 0]], axis=-1) / MAGIC_NUM).astype(np.float32)


def agent_to_world(agent_pos, yaw, cur_pos):
    """Ego-frame trajectory (H, 2) in meters -> world xy (reference: interact.py:249-260)."""
    if math.isnan(yaw):
        yaw = 0.0
    theta = yaw + np.pi / 2.0
    agent_pos = np.asarray(agent_pos, np.float64)
    agent_pos = np.stack([-agent_pos[:, 1], agent_pos[:, 0]], axis=-1)
    R = np.array([[np.cos(theta), np.sin(theta)], [-np.sin(theta), np.cos(theta)]])
    return R.T.dot(agent_pos.T).T + np.asarray(cur_pos, np.float64)[None]


class DiffusionPlanner:
    """Planner over the port's model, on ``device`` (None: the card)."""

    magic_num = MAGIC_NUM

    def __init__(self, cfg, checkpoint: Optional[str] = None, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.use_guidance_type = GuidanceType[cfg.GUIDANCE.USE_COND]
        self.model = build_model(cfg, device=self.device, seed=seed)
        ckpt_path = checkpoint or cfg.EVAL.CHECKPOINT
        if ckpt_path:
            if os.path.isdir(str(ckpt_path)):
                raise NotImplementedError(
                    f"{ckpt_path}: the port loads reference .pth checkpoints and its own; export an "
                    "Orbax directory to .pth with the JAX package first"
                )
            # the serving weights: the EMA shadow over the parameters
            self.model.load_state_dict(load_eval_state_dict(str(ckpt_path), cfg), strict=True)
        self.model.requires_grad_(False)  # serving: only the guidance gradient is taken
        self._sample = sampler_from_cfg(self.model, make_schedule_from_cfg(cfg, self.device), cfg)

        # fixed init noise across plans (interact.py:100); K hypotheses draw K
        # rows of it, and the step noise (S, K, H, D) follows it
        self._generator = torch.Generator().manual_seed(seed)
        self.num_hypotheses = max(1, int(cfg.TPU.NUM_HYPOTHESES))
        shape = (self.num_hypotheses, cfg.MODEL.HORIZON, cfg.MODEL.TRANSITION_DIM)
        self._noise_shape = (self._sample.num_steps,) + shape if self._sample.needs_noise else None
        self.init_trajs, self.step_noise = (
            None if a is None else a.to(self.device) for a in self._draw(shape)
        )
        self._fixed_noise = bool(cfg.TPU.FIXED_INIT_NOISE)

        self._needs_target = self.use_guidance_type != GuidanceType.NO_GUIDANCE
        self._hoisted = bool(cfg.TPU.HOIST_PERCEPTION)
        self._scorer = str(cfg.TPU.HYPOTHESIS_SCORER).lower()
        if self._scorer not in ("auto", "guidance_loss", "jerk", "learned"):
            raise ValueError(
                f"TPU.HYPOTHESIS_SCORER={self._scorer!r}; use auto | guidance_loss | jerk | learned"
            )
        if self._scorer == "learned":
            # the outcome-trained net of models/scorer.py (JAX plan.py:121-134)
            path = str(cfg.TPU.SCORER_CHECKPOINT)
            if not path:
                raise ValueError(
                    "TPU.HYPOTHESIS_SCORER=learned needs TPU.SCORER_CHECKPOINT "
                    "(a .npz written by models.scorer.save_scorer)"
                )
            self._scorer_net = HypothesisScorer.from_params(*load_scorer(path)).to(self.device)
        # the plan as one program; its key follows the weights of these modules
        nets = [self.model] + ([self._scorer_net] if self._scorer == "learned" else [])
        self._program = PlanProgram(nets, self.device, getattr(torch, str(cfg.TPU.COMPUTE_DTYPE)))

    def _draw(self, shape):
        """(init trajectories, step noise or None) from the CPU generator."""
        init = torch.randn(shape, generator=self._generator)
        if self._noise_shape is None:
            return init, None
        return init, torch.randn(self._noise_shape, generator=self._generator)

    @torch.no_grad()
    def _plan(self, init_trajs: torch.Tensor, rgb_u8: torch.Tensor, target: torch.Tensor,
              step_noise: Optional[torch.Tensor]):
        """The plan's body, eagerly: the program ``plan_begin`` runs, and the
        plain version it is held against."""
        image = normalize_images(rgb_u8)[None]  # (1, H, W, 3)
        K = init_trajs.shape[0]
        if self._hoisted:
            kwargs = dict(img_feature=self.model.encode_image(image).repeat(K, 1))
        else:  # the reference's execution re-encodes in every step
            kwargs = dict(image=image.repeat(K, 1, 1, 1))
        trajs = self._sample(
            init_trajs, target=target.repeat(K, 1) if self._needs_target else None,
            noise_seq=step_noise, **kwargs
        )
        if self._scorer == "learned":
            score = self._scorer_net(trajs, target[0])
        elif self._scorer == "guidance_loss" and self._needs_target:
            # the TargetGuidance objective per hypothesis, on normalized xy
            score = torch.stack([target_guidance_loss((t / MAGIC_NUM)[None, :, :2], target) for t in trajs])
        elif self._needs_target and self._scorer != "jerk":
            err = trajs[:, -1, :2] / MAGIC_NUM - target[0][None]
            score = (err * err).sum(-1)
        else:  # comfort: least squared jerk over the xy path
            jerk = torch.diff(trajs[..., :2], n=2, dim=1)
            score = (jerk * jerk).sum((1, 2))
        return trajs, torch.argmin(score)

    def plan(self, rgb_u8: np.ndarray, target: Optional[np.ndarray] = None) -> np.ndarray:
        """rgb_u8: (H, W, 3) uint8 frame; target: (2,) or (1, 2) ego-frame
        normalized target point. Returns the (1, horizon, 7) best trajectory,
        xy in meters."""
        trajs, best = self.plan_hypotheses(rgb_u8, target)
        return trajs[best][None]

    def plan_hypotheses(self, rgb_u8: np.ndarray, target: Optional[np.ndarray] = None):
        """All K hypotheses: ((K, horizon, 7) numpy trajectories, best index)."""
        trajs, best = self.plan_begin(rgb_u8, target)
        return trajs.cpu().numpy(), int(best)

    def plan_begin(self, rgb_u8: np.ndarray, target: Optional[np.ndarray] = None):
        """Queue a plan without waiting: returns device tensors (trajs, best),
        copies that a later plan does not overwrite."""
        if self._fixed_noise:
            init, noise = self.init_trajs, self.step_noise
        else:
            init, noise = self._draw(self.init_trajs.shape)
        tgt = np.zeros((1, 2), np.float32) if target is None else np.asarray(target, np.float32).reshape(1, 2)
        return self._program(self._plan, init, torch.from_numpy(np.ascontiguousarray(rgb_u8, np.uint8)),
                             torch.from_numpy(tgt), noise)

    def plan_fetch(self, handle) -> np.ndarray:
        """Wait on a ``plan_begin`` handle; the (1, horizon, 7) trajectory ``plan`` returns."""
        trajs, best = handle
        return trajs.cpu().numpy()[int(best)][None]

    @staticmethod
    def post_process_control_interact(throttle_res, steer_res, brake_res):
        """reference: interact.py:218-229 (zeroes steer on hard brake)."""
        if brake_res < 0.05:
            brake_res = 0.0
        if throttle_res > brake_res:
            brake_res = 0.0
        if brake_res > 0.5:
            brake_res, steer_res, throttle_res = 1.0, 0.0, 0.0
        return np.array([throttle_res, steer_res, brake_res])

    @staticmethod
    def post_process_control_leaderboard(throttle_res, steer_res, brake_res):
        """reference: diffusion_agent.py:270-278 (keeps steer and brake value)."""
        if brake_res < 0.05:
            brake_res = 0.0
        if throttle_res > brake_res:
            brake_res = 0.0
        if brake_res > 0.5:
            throttle_res = 0.0
        return throttle_res, steer_res, brake_res
