"""Work counted from shapes for Diffusion Policy's CNN planner
(``perfbench/reference/diffusion_policy.py``), on the ``meta`` device as
``work.py`` counts the temporal U-Net's: the operations of a plan, and each
FiLM residual-block call's operations and bytes, with the keys the plan
readers take (``flops``, ``residual_bound_s``, ``forwards``) and the weight
bytes ``weight_stream_share.plan`` takes (``weight_bytes``).

A block call's bytes are its input, the conditioning, its output and every
weight and bias once (both 5-tap convolutions, the FiLM projection's 2C
columns and biases, the norms, the 1x1 residual projection).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn

from .reference.diffusion_policy import ConditionalResidualBlock1D, build_reference
from .work import _layer_flops

__all__ = ["unet_parameters", "block_work", "forward_flops", "plan_work"]

LAYERS = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d)


def unet_parameters(model_cfg: dict) -> int:
    """The U-Net's parameters (the encoder's left out): every one a forward
    reads."""
    model = build_reference(model_cfg, "meta")
    return sum(p.numel() for p in model.parameters()) - sum(p.numel() for p in model.perception.parameters())


def _forward(model, model_cfg: dict, batch: int) -> None:
    obs = model_cfg["N_OBS_STEPS"] * (model_cfg["OBS_FEATURE_DIM"] + 2)
    with torch.no_grad():
        model(torch.zeros(batch, model_cfg["HORIZON"], model_cfg["TRANSITION_DIM"], device="meta"),
              torch.zeros(batch, device="meta"), torch.zeros(batch, obs, device="meta"))


def block_work(model_cfg: dict, batch: int, elem_bytes: int = 4) -> List[Tuple[int, int, int]]:
    """(operations, bytes, weight bytes) of each residual-block call of one
    U-Net forward at ``batch``: both 5-tap convolutions, the FiLM projection
    and the 1x1 residual projection."""
    model = build_reference(model_cfg, "meta")
    calls = []

    def hook(mod, args, out):
        x, cond = args  # (B, Cin, L), (B, E)
        B, cin, L = x.shape
        C, E = out.shape[1], cond.shape[1]
        has_res = isinstance(mod.residual_conv, nn.Conv1d)
        ops = 2 * B * (L * 5 * cin * C + L * 5 * C * C + E * 2 * C + (L * cin * C if has_res else 0))
        weights = 5 * cin * C + 5 * C * C + E * 2 * C + 8 * C + ((cin + 1) * C if has_res else 0)
        calls.append((ops, elem_bytes * (x.numel() + cond.numel() + weights + B * L * C), elem_bytes * weights))

    hooks = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, ConditionalResidualBlock1D)]
    _forward(model, model_cfg, batch)
    for hk in hooks:
        hk.remove()
    return calls


def forward_flops(model_cfg: dict, image_hw, batch: int) -> Dict[str, int]:
    """Operations of one plan's encoder (its N_OBS_STEPS frames of
    ``image_hw``) and of one U-Net forward of ``batch`` trajectories."""
    model = build_reference(model_cfg, "meta")
    counts = {"encoder": 0, "unet": 0}
    part = ["encoder"]
    hooks = [m.register_forward_hook(
        lambda m, a, o: counts.__setitem__(part[0], counts[part[0]] + _layer_flops(m, a[0], o)))
        for m in model.modules() if isinstance(m, LAYERS)]
    with torch.no_grad():
        n = model_cfg["N_OBS_STEPS"]
        model.perception(torch.zeros(n, 3, *image_hw, device="meta"))
    part[0] = "unet"
    _forward(model, model_cfg, batch)
    for hk in hooks:
        hk.remove()
    return counts


def plan_work(cfg: dict, rates: Dict[str, float]) -> Dict[str, float]:
    """One plan's operations (the encoder once over the history's frames,
    each denoising step's U-Net forward at K rows), the summed roofline
    bound, in seconds, of its residual-block calls in float32, and their
    weight bytes."""
    rows = int(cfg["TPU"]["NUM_HYPOTHESES"])
    steps = int(cfg["EVAL"]["SAMPLE_STEPS"])
    f = forward_flops(cfg["MODEL"], (cfg["TRAIN"]["IMAGE_HEIGHT"], cfg["TRAIN"]["IMAGE_WIDTH"]), rows)
    calls = block_work(cfg["MODEL"], rows)
    bound = sum(max(ops / rates["fp32_flops"], nbytes / rates["bytes_s"]) for ops, nbytes, _ in calls)
    return {"flops": float(f["encoder"] + steps * f["unet"]), "residual_bound_s": steps * bound, "forwards": steps,
            "weight_bytes": float(steps * sum(w for _, _, w in calls))}
