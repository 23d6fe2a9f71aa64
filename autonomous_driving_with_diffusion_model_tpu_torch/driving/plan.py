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

Tracing (``utils/profiling.py``): ``plan_begin`` is the host span ``plan``,
whose request is the planner's plan sequence number and whose attributes are
the program's key and the port kernels' launches of its replay; the
program's spans are its children (``driving/program.py``). ``plan_fetch``
and ``plan_hypotheses`` wait inside ``plan.fetch``. ``_plan`` marks the
device spans of the graph: ``plan.encode`` (normalization and the encoder,
once, under ``TPU.HOIST_PERCEPTION``), ``plan.denoise`` (the sampler: every
step's U-Net forward, the guidance's combine and the update) and
``plan.score`` (the scorer and the argmin).

Under ``MODEL.ARCH`` ``conditional_unet1d`` (Diffusion Policy's CNN,
``models/conditional_unet1d.py``) a plan conditions on the last
``MODEL.N_OBS_STEPS`` requests: the planner keeps their (frame, target)
pairs, oldest first, and the first request after construction or
:meth:`DiffusionPlanner.reset_history` fills the history with copies of
itself, as Diffusion Policy's env runner pads its first observation. The
program takes the history as its frame (N_OBS_STEPS, H, W, 3) and target
(N_OBS_STEPS, 2) inputs; ``plan.encode`` scales the frames to [0, 1] (uint8
/ 255, as Diffusion Policy feeds images) and encodes both, with their
targets, into the plan's conditioning.

Under ``MODEL.ARCH`` ``rdt`` (RDT-1B, ``models/rdt.py``) the history is
RDT's image history (``MODEL.N_OBS_STEPS`` frames), and a plan also takes the
episode's instruction: (tokens (``MODEL.RDT.LANG_SLOTS``, ``LANG_DIM``),
boolean mask), set by :meth:`DiffusionPlanner.reset_history` and held on the
device, a third input buffer of the program. ``plan.encode`` preprocesses the
frames (RDT's square pad and resize), runs SigLIP over every image slot (the
real camera's frames and the background image in the other cameras' slots)
and the condition adaptors, with the current target in the state token;
``plan.denoise`` turns the conditions into every DiT block's cross-attention
keys and values once (``RDTRunner.condition_kv``), then runs DPM-Solver++
over the 64-step chunk in RDT's action space on them, whose transition
channels the planner reads. One hypothesis, no guidance.

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
from collections import deque
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
from ..utils import profiling
from ..utils.constants import MAGIC_NUM, GuidanceType
from ..utils.device import resolve_device
from .program import PlanProgram, describe

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
        # the sampled vector: the transition, or RDT's unified action
        width = int(getattr(self.model, "action_dim", cfg.MODEL.TRANSITION_DIM))
        shape = (self.num_hypotheses, cfg.MODEL.HORIZON, width)
        self._noise_shape = (self._sample.num_steps,) + shape if self._sample.needs_noise else None
        self.init_trajs, self.step_noise = (
            None if a is None else a.to(self.device) for a in self._draw(shape)
        )
        self._fixed_noise = bool(cfg.TPU.FIXED_INIT_NOISE)

        self._needs_target = self.use_guidance_type != GuidanceType.NO_GUIDANCE
        self._hoisted = bool(cfg.TPU.HOIST_PERCEPTION)
        # the model's observation history (Diffusion Policy's CNN); 0: none (one frame)
        self._obs_steps = int(getattr(self.model, "n_obs_steps", 0))
        if self._obs_steps and (not self._hoisted or self._needs_target):
            raise ValueError(f"MODEL.ARCH {cfg.MODEL.ARCH} plans with TPU.HOIST_PERCEPTION on and no guidance")
        self._history: deque = deque(maxlen=max(1, self._obs_steps))
        # the (tokens, width) of the instruction the model plans under (RDT-1B); None: none
        self._instruction_shape = getattr(self.model, "instruction_shape", None)
        self._instruction = None  # its (tokens, mask) on the device
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
        self.plans = 0  # plans begun: the next plan's request

    def _draw(self, shape):
        """(init trajectories, step noise or None) from the CPU generator."""
        init = torch.randn(shape, generator=self._generator)
        if self._noise_shape is None:
            return init, None
        return init, torch.randn(self._noise_shape, generator=self._generator)

    def reset_history(self, instruction=None) -> None:
        """Forget the observation history (a new episode); the next request
        pads it with copies of itself. ``instruction`` (a model with an
        ``instruction_shape``, RDT-1B): the episode's (tokens (LANG_SLOTS,
        LANG_DIM), mask (LANG_SLOTS,)), arrays or tensors, the mask True on
        the instruction's tokens; None keeps the one set before."""
        self._history.clear()
        if instruction is not None:
            if self._instruction_shape is None:
                raise ValueError(f"MODEL.ARCH {self.cfg.MODEL.ARCH} takes no instruction")
            tokens, mask = (torch.as_tensor(a) for a in instruction)
            slots, width = self._instruction_shape
            if tokens.shape != (slots, width) or mask.shape != (slots,) or not mask.any():
                raise ValueError(f"the instruction: tokens ({slots}, {width}) and a mask "
                                 f"({slots},) with a token, not {tuple(tokens.shape)} and {tuple(mask.shape)}")
            self._instruction = (tokens.to(self.device, torch.float32), mask.to(self.device, torch.bool))

    def _observe(self, frame: np.ndarray, target: np.ndarray):
        """Add one request to the history: the (N_OBS_STEPS, H, W, 3) frames
        and (N_OBS_STEPS, 2) targets of the plan, oldest first."""
        if not self._history:
            self._history.extend([(frame, target)] * (self._history.maxlen - 1))
        self._history.append((frame, target))
        frames = np.stack([f for f, _ in self._history])
        targets = np.concatenate([t for _, t in self._history])
        self._history.extend(zip(frames, targets[:, None]))  # rows of these copies, not the caller's buffers
        return frames, targets

    @torch.no_grad()
    def _plan(self, init_trajs: torch.Tensor, rgb_u8: torch.Tensor, target: torch.Tensor,
              step_noise: Optional[torch.Tensor], *instruction: torch.Tensor):
        """The plan's body, eagerly: the program ``plan_begin`` runs, and the
        plain version it is held against. Under an instruction (RDT-1B) the
        conditions' cross-attention keys and values are made once, at the
        start of ``plan.denoise``, where the DiT's work counts them."""
        profiling.mark("plan.encode" if self._hoisted else "plan.denoise", steps=self._sample.num_steps)
        K = init_trajs.shape[0]
        if instruction:  # the frames, the target and the instruction (RDT-1B's conditions)
            cond = self.model.encode_obs(rgb_u8, target[-1:], *instruction)
            profiling.mark("plan.denoise")
            cond = self.model.condition_kv(cond)  # every block's keys and values, once a plan
            actions = self._sample(init_trajs, img_feature=cond)
            return self._choose(self.model.transitions(actions), target[-1:])
        if self._obs_steps:  # the history's frames and targets: the plan's conditioning
            obs = self.model.encode_obs(rgb_u8.to(torch.float32) / 255.0, target)
            profiling.mark("plan.denoise")
            trajs = self._sample(init_trajs, noise_seq=step_noise, img_feature=obs.repeat(K, 1))
            return self._choose(trajs, target[-1:])
        image = normalize_images(rgb_u8)[None]  # (1, H, W, 3)
        if self._hoisted:
            kwargs = dict(img_feature=self.model.encode_image(image).repeat(K, 1))
            profiling.mark("plan.denoise")
        else:  # the reference's execution re-encodes in every step
            kwargs = dict(image=image.repeat(K, 1, 1, 1))
        trajs = self._sample(
            init_trajs, target=target.repeat(K, 1) if self._needs_target else None,
            noise_seq=step_noise, **kwargs
        )
        return self._choose(trajs, target)

    def _choose(self, trajs: torch.Tensor, target: torch.Tensor):
        """(trajs, the index of the best): the scorer's choice among the K
        hypotheses, inside the ``plan.score`` span."""
        profiling.mark("plan.score")
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
        best = torch.argmin(score)
        profiling.mark_end()
        return trajs, best

    def plan(self, rgb_u8: np.ndarray, target: Optional[np.ndarray] = None) -> np.ndarray:
        """rgb_u8: (H, W, 3) uint8 frame; target: (2,) or (1, 2) ego-frame
        normalized target point. Returns the (1, horizon, 7) best trajectory,
        xy in meters."""
        trajs, best = self.plan_hypotheses(rgb_u8, target)
        return trajs[best][None]

    def plan_hypotheses(self, rgb_u8: np.ndarray, target: Optional[np.ndarray] = None):
        """All K hypotheses: ((K, horizon, 7) numpy trajectories, best index)."""
        trajs, best = self.plan_begin(rgb_u8, target)
        with profiling.span("plan.fetch", request=self.plans - 1):
            return trajs.cpu().numpy(), int(best)

    def plan_begin(self, rgb_u8: np.ndarray, target: Optional[np.ndarray] = None):
        """Queue a plan without waiting: returns device tensors (trajs, best),
        copies that a later plan does not overwrite."""
        request, self.plans = self.plans, self.plans + 1
        with profiling.span("plan", request=request) as sp:
            if self._fixed_noise:
                init, noise = self.init_trajs, self.step_noise
            else:
                init, noise = self._draw(self.init_trajs.shape)
            tgt = np.zeros((1, 2), np.float32) if target is None else np.asarray(target, np.float32).reshape(1, 2)
            frame = np.ascontiguousarray(rgb_u8, np.uint8)
            if self._obs_steps:
                frame, tgt = self._observe(frame, tgt)
            extra = ()
            if self._instruction_shape is not None:
                if self._instruction is None:
                    raise ValueError(f"MODEL.ARCH {self.cfg.MODEL.ARCH} plans under an instruction: "
                                     "reset_history(instruction=(tokens, mask)) first")
                extra = self._instruction
            out = self._program(self._plan, init, torch.from_numpy(frame), torch.from_numpy(tgt), noise, extra)
            if sp:
                prog = self._program
                launches = prog.programs[prog.key].launches
                sp.set(key=describe(prog.key), launches=dict(launches))
                if extra:  # the replay's softmax attention calls, cross-attention keys and tokens projected to them
                    sp.set(**{"rdt.attention": launches.get("attention", 0),
                              "rdt.cross_keys": launches.get("attention.cross_keys", 0),
                              "rdt.cross_kv": launches.get("attention.cross_kv", 0)})
            return out

    def plan_fetch(self, handle) -> np.ndarray:
        """Wait on a ``plan_begin`` handle; the (1, horizon, 7) trajectory ``plan`` returns."""
        trajs, best = handle
        with profiling.span("plan.fetch"):
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
