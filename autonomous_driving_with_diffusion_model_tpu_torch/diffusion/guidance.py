"""Classifier guidance: target-waypoint loss and gradient update (counterpart
of the JAX package's ``diffusion/guidance.py``; reference:
control/guidance_loss.py:6-22, control/guidance.py:17-59).

The gradient is ``torch.autograd.grad`` under ``torch.enable_grad()``, with
the model output x and the action as leaves. The action's gradient flows
through the state-prediction head only: the U-Net output is a constant to it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = ["target_guidance_loss", "build_loss_list", "make_guidance_fn", "GUIDANCE_LOSSES"]


def target_guidance_loss(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Softmin-weighted squared distance of trajectory points to the target
    waypoint(s). x: (B, H, D) with xy first; target: (N, 2) or (1, N, 2).

    If the trajectory endpoint is closer to the anchor than the target is,
    the distance to trajectory point 0 is used instead of the nearest point
    (the reference's erratic-update guard).
    """
    while target.ndim < x.ndim:
        target = target[None]
    loss_weight = torch.softmax(-torch.linalg.norm(target, dim=-1), dim=-1)  # (1, N)
    dist = ((x[..., None, :, :2] - target[..., :, None, :]) ** 2).sum(-1)  # (B, N, H)
    target_to_agent = torch.linalg.norm(target - x[:, 0, :2][:, None, :], dim=-1)  # (B, N)
    final_to_agent = torch.linalg.norm(x[:, -1, :2] - x[:, 0, :2], dim=-1)  # (B,)
    choose = torch.where(
        final_to_agent[:, None] < target_to_agent, torch.zeros_like(target_to_agent, dtype=torch.long),
        dist.argmin(dim=-1),
    )
    chosen = torch.gather(dist, -1, choose[..., None])[..., 0]  # (B, N)
    return (chosen * loss_weight).mean(dim=-1).sum()


GUIDANCE_LOSSES = {"TargetGuidance": target_guidance_loss}


def build_loss_list(loss_list_cfg):
    """Resolve [[ClassName, kwargs-flat-list], ...] (reference: guidance.py:17-27)."""
    fns = []
    for name, flat_kwargs in loss_list_cfg or []:
        if name not in GUIDANCE_LOSSES:
            raise KeyError(f"Unknown guidance loss: {name}")
        base = GUIDANCE_LOSSES[name]
        it = iter(flat_kwargs or [])
        kwargs = dict(zip(it, it))
        fns.append((lambda x, t, _b=base, _k=kwargs: _b(x, t, **_k)) if kwargs else base)
    return fns


def make_guidance_fn(
    loss_list_cfg,
    classifier_scale: float,
    guidance_step: int = 1,
    state_pred_fn: Optional[Callable] = None,
):
    """``guide(x, action, target, grad_scale) -> new_x`` for the full (B, H, 7)
    model output x. ``state_pred_fn(action) -> state`` is the anchored
    state-prediction head; with it the action gradient flows through the
    transformer (the reference's eval-time graph, interact.py:158)."""
    loss_fns = build_loss_list(loss_list_cfg)

    def grads(x, action, target):
        if not loss_fns:
            return torch.zeros_like(x), torch.zeros_like(action)
        with torch.enable_grad():
            x_in = x.detach().requires_grad_(True)
            a_in = action.detach().requires_grad_(True)
            z = x_in
            if state_pred_fn is not None:
                # value x; d/dx the direct gradient; d/daction through the
                # state head and the concat (the reference's autograd.grad
                # over [x_guidance, action])
                x_graph = torch.cat([state_pred_fn(a_in), a_in], dim=-1)
                z = x_in + (x_graph - x_graph.detach())
            loss = sum(fn(z, target) for fn in loss_fns)
            gx, ga = torch.autograd.grad(loss, [x_in, a_in], allow_unused=True)
        return gx, torch.zeros_like(action) if ga is None else ga

    def guide(x, action, target, grad_scale):
        for _ in range(guidance_step):
            x_grad, action_grad = grads(x, action, target)
            grad = torch.cat([x_grad[..., :-3], action_grad], dim=-1)
            if grad_scale is not None:
                grad = grad * grad_scale
            x = torch.cat(
                [x[..., :-3] - (classifier_scale / 15.0) * grad[..., :-3], x[..., -3:] - classifier_scale * grad[..., -3:]],
                dim=-1,
            )
        return x.clamp(-1.0, 1.0)

    return guide
