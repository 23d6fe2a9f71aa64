"""Work counted from shapes: the operations of a forward pass, the roofline
bound of the residual-block kernel, and the card's data-sheet peaks.

Operations are counted on the plain reference model run on the ``meta``
device (shapes only, no memory, no time): two per multiply-add of every
convolution, transposed convolution and linear layer. Normalisation,
activations and the sampler's elementwise update are left out; they are
under 1% of a forward's operations. What the counts depend on is the
configuration's shapes alone, so they read the same whatever implements
the layers.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn

from .reference.models import ResidualTemporalMapBlock, build_reference

__all__ = ["card_rates", "forward_flops", "residual_block_work", "plan_work", "train_step_flops"]


def card_rates(name: str) -> Dict[str, float]:
    """Data-sheet peaks of the named H100 part: memory bytes/s, float32
    FLOP/s (outside the tensor cores) and dense bfloat16 FLOP/s."""
    if "PCIe" in name:
        return {"bytes_s": 2.0e12, "fp32_flops": 51e12, "bf16_flops": 756e12}
    if "NVL" in name:
        return {"bytes_s": 3.9e12, "fp32_flops": 60e12, "bf16_flops": 835e12}
    return {"bytes_s": 3.35e12, "fp32_flops": 67e12, "bf16_flops": 989e12}  # SXM


def _layer_flops(mod: nn.Module, inp: torch.Tensor, out: torch.Tensor) -> int:
    if isinstance(mod, nn.Linear):
        return 2 * out.numel() * mod.in_features
    if isinstance(mod, (nn.Conv1d, nn.Conv2d)):
        return 2 * out.numel() * (mod.in_channels // mod.groups) * math.prod(mod.kernel_size)
    if isinstance(mod, nn.ConvTranspose1d):
        return 2 * inp.numel() * mod.out_channels * math.prod(mod.kernel_size)
    return 0


def forward_flops(model_cfg: dict, free_guidance: bool, image_hw, batch: int) -> Dict[str, int]:
    """Operations of one encoder forward of ``batch`` images of
    ``image_hw`` and of one U-Net forward of ``batch`` trajectories, and
    of the encoder's first convolution (whose input needs no gradient)."""
    model = build_reference(model_cfg, free_guidance, "meta")
    counts = {"encoder": 0, "unet": 0, "first_conv": 0}
    part = ["encoder"]
    hooks = [m.register_forward_hook(lambda m, a, o: counts.__setitem__(part[0], counts[part[0]] + _layer_flops(m, a[0], o)))
             for m in model.modules() if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d))]
    hooks.append(model.perception.conv1.register_forward_hook(
        lambda m, a, o: counts.__setitem__("first_conv", _layer_flops(m, a[0], o))))
    with torch.no_grad():
        h, w = image_hw
        feature = model.encode(torch.zeros(batch, h, w, 3, device="meta"))
        part[0] = "unet"
        x = torch.zeros(batch, model_cfg["HORIZON"], model_cfg["TRANSITION_DIM"], device="meta")
        model(x, torch.zeros(batch, device="meta"), feature,
              torch.zeros(batch, 2, device="meta") if free_guidance else None)
    for hk in hooks:
        hk.remove()
    return counts


def residual_block_work(model_cfg: dict, batch: int, elem_bytes: int = 4):
    """(operations, bytes) of each residual-block call of one U-Net
    forward at ``batch``, as the fused kernel must do them: both 5-tap
    convolutions, the conditioning projection and the 1x1 residual
    projection; every input, weight and the output moved once."""
    model = build_reference(model_cfg, False, "meta")
    calls = []

    def hook(mod, args, out):
        x, t = args  # (B, Cin, L), (B, E)
        B, cin, L = x.shape
        C, E = out.shape[1], t.shape[1]
        has_res = isinstance(mod.residual_conv, nn.Conv1d)
        ops = 2 * B * (L * 5 * cin * C + L * 5 * C * C + E * C + (L * cin * C if has_res else 0))
        weights = 5 * cin * C + 5 * C * C + E * C + 7 * C + ((cin + 1) * C if has_res else 0)
        nbytes = elem_bytes * (x.numel() + t.numel() + weights + B * L * C)
        calls.append((ops, nbytes))

    hooks = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, ResidualTemporalMapBlock)]
    with torch.no_grad():
        dim = model_cfg["DIM"]
        x = torch.zeros(batch, model_cfg["HORIZON"], model_cfg["TRANSITION_DIM"], device="meta")
        model(x, torch.zeros(batch, device="meta"), torch.zeros(batch, dim, device="meta"))
    for hk in hooks:
        hk.remove()
    return calls


def plan_work(cfg: dict, rates: Dict[str, float]) -> Dict[str, float]:
    """One plan's operations (the encoder once, each denoising step's
    U-Net forward at K rows, twice as many under classifier-free guidance's
    dual batch) and the summed roofline bound, in seconds, of its
    residual-block calls in float32."""
    free = cfg["GUIDANCE"]["USE_COND"] == "FREE_GUIDANCE"
    rows = int(cfg["TPU"]["NUM_HYPOTHESES"]) * (2 if free and float(cfg["GUIDANCE"]["FREE_SCALE"]) != 1.0 else 1)
    steps = int(cfg["EVAL"]["SAMPLE_STEPS"])
    image_hw = (cfg["TRAIN"]["IMAGE_HEIGHT"], cfg["TRAIN"]["IMAGE_WIDTH"])
    flops = forward_flops(cfg["MODEL"], free, image_hw, 1)["encoder"]
    flops += steps * forward_flops(cfg["MODEL"], free, image_hw, rows)["unet"]
    bound = sum(max(ops / rates["fp32_flops"], nbytes / rates["bytes_s"])
                for ops, nbytes in residual_block_work(cfg["MODEL"], rows))
    return {"flops": float(flops), "residual_bound_s": steps * bound, "forwards": steps}


def train_step_flops(cfg: dict) -> float:
    """One training step's operations at TRAIN.BATCH_SIZE: the forward,
    and a backward of twice its operations (the gradients of the inputs
    and of the weights), less the input gradient of the first convolution,
    which nothing needs."""
    free = cfg["TRAIN"]["USE_COND"] == "FREE_GUIDANCE"
    f = forward_flops(cfg["MODEL"], free, (cfg["TRAIN"]["IMAGE_HEIGHT"], cfg["TRAIN"]["IMAGE_WIDTH"]),
                      int(cfg["TRAIN"]["BATCH_SIZE"]))
    return float(3 * (f["encoder"] + f["unet"]) - f["first_conv"])
