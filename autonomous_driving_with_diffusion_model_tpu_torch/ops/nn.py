"""Core neural-net ops in plain PyTorch (counterpart of the JAX package's
``ops/nn.py``).

Activations keep the JAX package's channels-last layouts at every function
boundary: trajectories (B, L, C), images (B, H, W, C). Weights are in the
layout of the reference torch ``state_dict``: Conv1d (Cout, Cin, K),
ConvTranspose1d (Cin, Cout, K), Conv2d (Cout, Cin/groups, Kh, Kw). The
functions transpose activations to PyTorch's channels-first layout around the
library call and back.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = [
    "mish",
    "sinusoidal_pos_emb",
    "group_norm",
    "channel_layer_norm",
    "conv1d",
    "conv1d_transpose",
    "conv2d",
    "dense",
    "layer_norm",
]


def mish(x: torch.Tensor) -> torch.Tensor:
    """``x * tanh(softplus(x))`` (reference: nn.Mish)."""
    return F.mish(x)


def sinusoidal_pos_emb(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal timestep embedding (reference: modeling/helpers.py:62-74).

    t: (B,) -> (B, dim) with [sin | cos] halves, computed in float32.
    """
    half_dim = dim // 2
    scale = math.log(10000.0) / (half_dim - 1)
    freqs = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=t.device) * -scale)
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def group_norm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int,
    eps: float = 1e-5,
) -> torch.Tensor:
    """GroupNorm over channels-last input, statistics in float32 (two-pass,
    biased variance; reference: nn.GroupNorm in helpers.py:95-112).

    x: (..., L, C).
    """
    orig_dtype = x.dtype
    *batch, L, C = x.shape
    xg = x.to(torch.float32).reshape(*batch, L, num_groups, C // num_groups)
    var, mean = torch.var_mean(xg, dim=(-3, -1), keepdim=True, correction=0)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    out = xg.reshape(*batch, L, C) * gamma.to(torch.float32) + beta.to(torch.float32)
    return out.to(orig_dtype)


def channel_layer_norm(
    x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """Per-position LayerNorm over channels with biased variance (reference's
    custom ``LayerNorm``, modeling/helpers.py:129-139). x: (..., L, C);
    gamma/beta of any shape holding C values (the reference keeps (1, C, 1))."""
    orig_dtype = x.dtype
    x32 = x.to(torch.float32)
    var, mean = torch.var_mean(x32, dim=-1, keepdim=True, correction=0)
    out = (x32 - mean) / torch.sqrt(var + eps) * gamma.reshape(-1) + beta.reshape(-1)
    return out.to(orig_dtype)


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Linear layer in ``x.dtype``; w: (out, in), torch ``nn.Linear`` layout."""
    return F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Last-dim LayerNorm (torch ``nn.LayerNorm``) in float32, returned in
    ``x.dtype`` (JAX ``TorchLayerNorm``)."""
    out = F.layer_norm(x.to(torch.float32), (x.shape[-1],), gamma.to(torch.float32), beta.to(torch.float32), eps)
    return out.to(x.dtype)


def conv1d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding: int = 0,
) -> torch.Tensor:
    """1-D convolution. x: (B, L, Cin); w: (Cout, Cin, K) -> (B, L', Cout)."""
    out = F.conv1d(
        x.transpose(1, 2), w.to(x.dtype), None if b is None else b.to(x.dtype), stride, padding
    )
    return out.transpose(1, 2)


def conv1d_transpose(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    stride: int = 2,
    padding: int = 1,
) -> torch.Tensor:
    """1-D transposed convolution, torch ``nn.ConvTranspose1d`` semantics
    (reference helpers.py:86-92 uses (4, 2, 1): doubles the length).
    x: (B, L, Cin); w: (Cin, Cout, K)."""
    out = F.conv_transpose1d(
        x.transpose(1, 2), w.to(x.dtype), None if b is None else b.to(x.dtype), stride, padding
    )
    return out.transpose(1, 2)


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding: int = 0,
    groups: int = 1,
) -> torch.Tensor:
    """2-D convolution. x: (B, H, W, Cin); w: (Cout, Cin/groups, Kh, Kw)."""
    out = F.conv2d(
        x.permute(0, 3, 1, 2),
        w.to(x.dtype),
        None if b is None else b.to(x.dtype),
        stride,
        padding,
        1,
        groups,
    )
    return out.permute(0, 2, 3, 1)
