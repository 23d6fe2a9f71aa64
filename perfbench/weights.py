"""The weights of a cell, made from its seed on the device, as one state dict
in the reference's names, which the program and the plain reference both
load.

Two draws from a generator on the device cover every tensor: one standard
normal vector for the ResNet's convolutions, one uniform vector for the
rest, each cut into the tensors in name order and scaled per tensor. The
scales are PyTorch's and torchvision's initialisers (kaiming-normal fan-out
convolutions, uniform +-1/sqrt(fan_in) for the linear and 1-d
convolution layers). The normalisation layers are drawn too, so that their
affine parameters and the BatchNorm statistics that frozen BatchNorm
applies are not the identity: gamma in [0.5, 1.0], beta in [-0.1, 0.1],
running mean in [-0.1, 0.1], running variance in [0.5, 1.5].
"""

from __future__ import annotations

import math
from typing import Dict

import torch

__all__ = ["make_state_dict"]


def _kind(name: str, shape) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "num_batches_tracked":
        return "count"
    if leaf in ("running_mean", "running_var"):
        return leaf
    if len(shape) == 4:
        return "conv2d"
    norm = ".bn" in name or "downsample.1." in name or ".block.2." in name
    if norm:
        return "gamma" if leaf == "weight" else "beta"
    return "fan_in"


def make_state_dict(template: Dict[str, torch.Tensor], seed: int, device) -> Dict[str, torch.Tensor]:
    """Values for every entry of ``template`` (a state dict of the
    reference model, on any device, the meta device included), drawn from
    ``seed`` on ``device`` in float32 (the counts as int64 zeros)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    kinds = {k: _kind(k, v.shape) for k, v in template.items()}
    sizes = lambda pred: sum(v.numel() for k, v in template.items() if pred(kinds[k]))
    normal = torch.randn(sizes(lambda kd: kd == "conv2d"), generator=gen, device=device)
    uniform = torch.rand(sizes(lambda kd: kd not in ("conv2d", "count")), generator=gen, device=device)
    out, n_at, u_at = {}, 0, 0
    for name in sorted(template):
        shape, kind = template[name].shape, kinds[name]
        n = math.prod(shape)
        if kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
            continue
        if kind == "conv2d":
            std = math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
            out[name] = (normal[n_at:n_at + n] * std).reshape(shape)
            n_at += n
            continue
        u = uniform[u_at:u_at + n].reshape(shape)
        u_at += n
        if kind == "fan_in":
            fan_in = math.prod(template[_weight_of(name, template)].shape[1:])
            b = 1.0 / math.sqrt(fan_in)
            out[name] = u * (2 * b) - b
        else:
            lo, hi = {"gamma": (0.5, 1.0), "beta": (-0.1, 0.1), "running_mean": (-0.1, 0.1),
                      "running_var": (0.5, 1.5)}[kind]
            out[name] = u * (hi - lo) + lo
    return out


def _weight_of(name: str, template) -> str:
    """The weight whose fan-in scales ``name`` (a weight or its bias)."""
    base = name.rsplit(".", 1)[0] + ".weight"
    return base if base in template else name
