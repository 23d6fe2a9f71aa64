"""A plan in plain PyTorch: normalize the uint8 frame, encode it, denoise K
hypotheses with DDIM (classifier-free guidance's dual batch where the
configuration asks for it), score them, pick the best, scale to meters.

The reference repository's closed-loop agent (interact.py:54-168) with the
scheduler math of diffusers 0.28.0, which it pins: the squared-cosine beta
schedule, "leading" timestep spacing, the x0 ("sample") prediction with
dynamic thresholding, DDIM with eta 0, and the first waypoint's (x, y, yaw)
zeroed before every step. Plans are computed many at once, in blocks of
rows; each row is the plan of one request.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import numpy as np
import torch

__all__ = ["MAGIC_NUM", "IMAGENET_MEAN", "IMAGENET_STD", "alphas_cumprod", "leading_timesteps",
           "normalize", "plan_batch", "precision"]

MAGIC_NUM = 23.315  # meters per normalized trajectory unit (temporal.py:195)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
ANCHOR_DIMS = 3


@contextmanager
def precision(kind: str):
    """Matrix products and convolutions in ``"float32"`` or in ``"tf32"``
    (the card's tensor-float format, 10-bit mantissa) inside the block."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    on = {"float32": False, "tf32": True}[kind]
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def alphas_cumprod(num_train_timesteps: int, schedule: str, device) -> torch.Tensor:
    """diffusers' cumulative alphas, computed in float64, stored float32."""
    if schedule != "squaredcos_cap_v2":
        raise ValueError(f"the reference implements the squaredcos_cap_v2 schedule, not {schedule!r}")
    bar = lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
    n = num_train_timesteps
    betas = np.array([min(1 - bar((i + 1) / n) / bar(i / n), 0.999) for i in range(n)])
    return torch.tensor(np.cumprod(1.0 - betas), dtype=torch.float32, device=device)


def leading_timesteps(num_train_timesteps: int, steps: int):
    ratio = num_train_timesteps // steps
    ts = [int(round(i * ratio)) for i in range(steps)][::-1]
    return ts, [t - ratio for t in ts]


def normalize(frames_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (or [0, 255] float) NHWC -> ImageNet-normalized float32."""
    mean = torch.tensor(IMAGENET_MEAN, device=frames_u8.device)
    std = torch.tensor(IMAGENET_STD, device=frames_u8.device)
    return (frames_u8.float() / 255.0 - mean) / std


def _anchor(x):
    x = x.clone()
    x[:, 0, :ANCHOR_DIMS] = 0.0
    return x


def _threshold(x0, ratio: float, max_value: float):
    """Imagen's dynamic thresholding per row (diffusers
    ``_threshold_sample``)."""
    s = torch.quantile(x0.reshape(x0.shape[0], -1).abs(), ratio, dim=1).clamp(1.0, max_value)
    s = s.reshape(-1, 1, 1)
    return torch.clamp(x0, -s, s) / s


def _scores(trajs, targets, guided: bool, scorer: str):
    """(rows, K) scores, lower is better: the squared distance of the
    endpoint to the target (guided, ``auto``), else the squared jerk of
    the xy path."""
    if scorer not in ("auto", "jerk"):
        raise ValueError(f"the reference implements the auto and jerk scorers, not {scorer!r}")
    if guided and scorer == "auto":
        err = trajs[:, :, -1, :2] / MAGIC_NUM - targets[:, None, :]
        return (err * err).sum(-1)
    jerk = trajs[..., 2:, :2] - 2 * trajs[..., 1:-1, :2] + trajs[..., :-2, :2]
    return (jerk * jerk).sum((-2, -1))


@torch.no_grad()
def plan_batch(model, cfg: dict, frames_u8: torch.Tensor, targets: torch.Tensor, init: torch.Tensor):
    """Plans of N requests: ``frames_u8`` (N, H, W, 3), ``targets`` (N, 2)
    normalized ego-frame points, ``init`` (K, horizon, transition) the
    starting noise every plan shares. Returns ((N, K, horizon, transition)
    trajectories with xy in meters, (N, K) scores, (N,) best index)."""
    N, K = frames_u8.shape[0], init.shape[0]
    guided = cfg["GUIDANCE"]["USE_COND"] == "FREE_GUIDANCE"
    scale = float(cfg["GUIDANCE"]["FREE_SCALE"])
    if cfg["GUIDANCE"]["USE_COND"] not in ("NO_GUIDANCE", "FREE_GUIDANCE") or cfg["EVAL"]["SCHEDULER"] != "ddim":
        raise ValueError("the reference plans with DDIM, without guidance or with classifier-free guidance")
    if float(cfg["EVAL"]["ETA"]) != 0 or cfg["TRAIN"]["NOISE_SCHEDULER"]["PRED_TYPE"] != "sample":
        raise ValueError("the reference plans with eta 0 and the sample prediction")
    ac = alphas_cumprod(cfg["TRAIN"]["SAMPLE_STEPS"], cfg["TRAIN"]["NOISE_SCHEDULER"]["TYPE"], init.device)
    ts, prev = leading_timesteps(cfg["TRAIN"]["SAMPLE_STEPS"], cfg["EVAL"]["SAMPLE_STEPS"])

    feature = model.encode(normalize(frames_u8)).repeat_interleave(K, 0)  # (N K, dim)
    target = targets.float().repeat_interleave(K, 0)
    x = _anchor(init.float().repeat(N, 1, 1))
    dual = guided and scale != 1.0
    for t, p in zip(ts, prev):
        tb = torch.full((x.shape[0],), float(t), device=x.device)
        if dual:  # [conditioned; unconditioned] in one batch (interact.py:119-127)
            out = model(torch.cat([x, x]), torch.cat([tb, tb]), torch.cat([feature, feature]),
                        torch.cat([target, torch.zeros_like(target)]))
            cond, uncond = out.chunk(2)
            out = uncond + scale * (cond - uncond)
        else:
            out = model(x, tb, feature, target if guided else None)
        a_t = ac[t]
        a_prev = ac[p] if p >= 0 else torch.ones((), device=x.device)
        eps = (x - a_t.sqrt() * out) / (1 - a_t).sqrt()
        x0 = _threshold(out, 0.995, 1.0)
        x = _anchor(a_prev.sqrt() * x0 + (1 - a_prev).sqrt() * eps)
    x = x.clamp(-1.0, 1.0)
    x = torch.cat([x[..., :2] * MAGIC_NUM, x[..., 2:]], dim=-1).reshape(N, K, *x.shape[1:])
    scores = _scores(x, targets.float(), guided, str(cfg["TPU"]["HYPOTHESIS_SCORER"]).lower())
    return x, scores, scores.argmin(dim=1)
