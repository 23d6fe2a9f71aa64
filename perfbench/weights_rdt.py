"""The weights of the ``rdt_1b-plan`` cell, made from its seed on the device,
as one state dict in the names of ``perfbench/reference/rdt.py`` (which the
program shares), float32 values each exactly a bfloat16: the program holds
them in bfloat16 and the reference computes with the same values in
float32, so that the comparison measures computation and not the rounding
of the weights.

Every tensor is a uniform draw of its own, in name order, from one
generator on the device, scaled by its kind (``perfbench/weights.py`` names
its kinds after the ResNet's and U-Net's modules, which RDT's do not
match):

* a norm's weight (RMSNorm, LayerNorm): gamma in [0.5, 1.0]; its bias: beta
  in [-0.1, 0.1];
* a position table (RDT's ``*_pos_embed``, SigLIP's
  ``position_embedding``): in [-0.1, 0.1];
* a linear layer's or convolution's weight and bias: uniform +-1/sqrt(fan_in),
  PyTorch's default.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

__all__ = ["make_state_dict", "kind"]


def kind(name: str, shape) -> str:
    """``gamma``, ``beta``, ``table`` or ``fan_in``."""
    leaf = name.rsplit(".", 1)[-1]
    if "norm" in name.rsplit(".", 1)[0] and len(shape) == 1:
        return "gamma" if leaf == "weight" else "beta"
    if leaf.endswith("pos_embed") or name.endswith("position_embedding.weight"):
        return "table"
    return "fan_in"


def make_state_dict(template: Dict[str, torch.Tensor], seed: int, device) -> Dict[str, torch.Tensor]:
    """Values for every entry of ``template`` (a state dict of the
    reference model, on any device, the meta device included), drawn from
    ``seed`` on ``device``: float32 tensors holding bfloat16 values."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for name in sorted(template):
        shape = template[name].shape
        u = torch.rand(shape, generator=gen, device=device)
        k = kind(name, shape)
        if k == "fan_in":
            weight = template[name.rsplit(".", 1)[0] + ".weight"]
            b = 1.0 / math.sqrt(math.prod(weight.shape[1:]))
            lo, hi = -b, b
        else:
            lo, hi = {"gamma": (0.5, 1.0), "beta": (-0.1, 0.1), "table": (-0.1, 0.1)}[k]
        out[name] = (u * (hi - lo) + lo).to(torch.bfloat16).to(torch.float32)
    return out
