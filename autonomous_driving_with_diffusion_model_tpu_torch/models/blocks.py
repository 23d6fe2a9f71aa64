"""Temporal U-Net building blocks (counterpart of the JAX package's
``models/blocks.py``).

Activations flow channels-last, (B, horizon, channels), as in the JAX
package. Parameters carry the reference torch ``state_dict`` names and
layouts (modeling/helpers.py, modeling/temporal.py), registered in the
reference order, so a reference ``.pth`` loads with ``strict=True``. Index
slots the reference fills with parameter-free modules (``Rearrange``,
``Mish``) hold ``nn.Identity`` here, only to keep the numbering.

``Conv1dBlock`` and ``ResidualTemporalMapBlock`` run through the CUDA kernels
of ``ops/kernels.py`` on a CUDA device (their plain versions on the CPU).
The kernels take (K, Cin, C) weights: each block packs its parameters into
that layout once per compute dtype and repacks only after a parameter
changed (``load_state_dict``, ``.to()``, an in-place update such as an
optimizer step), never per call. Under autograd (training) the pack is built
afresh on each call and differentiably, so the gradient reaches the
parameters through it; the kernels' gradient is ``ops/kernels.py:Recompute``.
A CUDA graph's replay writes weights without bumping their ``_version``:
the programs bump it after every replay (``ops/program.py``), so the
cached packs follow.

Parameters stay float32 in every model. A bfloat16 model (JAX
``TPU.COMPUTE_DTYPE``) computes in bfloat16: activations are bfloat16, and
each layer casts its weights to the activation's dtype where the JAX package
casts them, while normalisation and softmax run in float32 (``ops/nn.py``).
The kernels take every operand in x's dtype, so in a bfloat16 model the
GroupNorm gamma and beta reach them rounded to bfloat16, where the JAX model
keeps them float32: a relative change of at most 2^-9 in each, the size of
the bfloat16 rounding of the block's output (``tests/test_torch_bf16.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels import fused_conv1d_gn_mish, fused_residual_block
from ..ops.program import tensors_key
from ..ops.nn import channel_layer_norm, conv1d, conv1d_transpose, dense, layer_norm, mish, sinusoidal_pos_emb

__all__ = [
    "Conv1dBlock",
    "ResidualTemporalMapBlock",
    "Downsample1d",
    "Upsample1d",
    "SinusoidalPosEmb",
    "TimeMLP",
    "CondMLP",
    "LinearAttention",
    "PreNormAttention",
    "TransformerEncoderLayer",
    "TrajPredict",
    "dropout",
    "DropoutDraws",
]


def _packed(module: nn.Module, dtype: torch.dtype, build: Callable[[], Tuple]) -> Tuple[Tuple, bool]:
    """``(pack, cached)``: ``build()`` (kernel-layout copies of ``module``'s
    parameters) cast to the compute dtype ``dtype``, cached per dtype until a
    parameter changes storage, type, device or version; ``cached`` is True
    when the pack was made before this call (a pack made now was written by
    the kernels right before the block's own). When autograd records and a
    parameter needs a gradient, the copies are made on every call, in the
    graph."""
    pack = lambda: tuple(None if a is None else a.to(dtype).contiguous() for a in build())
    params = list(module.parameters())
    if torch.is_grad_enabled() and any(p.requires_grad for p in params):
        return pack(), False
    key = (tensors_key(params), tuple((p.dtype, p.device) for p in params))
    caches = module.__dict__.setdefault("_kernel_params", {})
    cache = caches.get(dtype)
    cached = cache is not None and cache[0] == key
    if not cached:
        with torch.no_grad():
            cache = (key, pack())
        caches[dtype] = cache
    return cache[1], cached


def _kio(w: torch.Tensor) -> torch.Tensor:
    """torch Conv1d weight (C, Cin, K) -> kernel layout (K, Cin, C)."""
    return w.permute(2, 1, 0)


class Conv1dBlock(nn.Module):
    """Conv1d(k, pad k//2) -> GroupNorm(8) -> Mish (reference: helpers.py:95-112,
    ``block.0`` conv, ``block.2`` norm); one ``fused_conv1d_gn_mish`` call."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 5, n_groups: int = 8):
        super().__init__()
        self.n_groups = n_groups
        self.block = nn.ModuleList(
            [
                nn.Conv1d(cin, cout, kernel_size, padding=kernel_size // 2),
                nn.Identity(),
                nn.GroupNorm(n_groups, cout),
            ]
        )

    def kernel_params(self, dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, ...]:
        conv, _, norm = self.block
        return _packed(
            self, dtype,
            lambda: (_kio(conv.weight), conv.bias, norm.weight, norm.bias),
        )[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b, g, be = self.kernel_params(x.dtype)
        return fused_conv1d_gn_mish(x.contiguous(), w, b, g, be, n_groups=self.n_groups)


class ResidualTemporalMapBlock(nn.Module):
    """Two Conv1dBlocks with a per-channel conditioning bias and a residual
    path (reference: modeling/temporal.py:23-55): one ``fused_residual_block``
    call."""

    def __init__(self, cin: int, cout: int, embed_dim: int, kernel_size: int = 5):
        super().__init__()
        self.blocks = nn.ModuleList(
            [Conv1dBlock(cin, cout, kernel_size), Conv1dBlock(cout, cout, kernel_size)]
        )
        self.time_mlp = nn.Sequential(nn.Mish(), nn.Linear(embed_dim, cout))
        self.residual_conv = nn.Conv1d(cin, cout, 1) if cin != cout else nn.Identity()

    def _cond_linear(self) -> nn.Linear:
        """The conditioning's projection."""
        return self.time_mlp[1]

    def _build(self) -> Tuple:
        (c1, _, n1), (c2, _, n2) = self.blocks[0].block, self.blocks[1].block
        lin = self._cond_linear()
        res = self.residual_conv
        has_res = isinstance(res, nn.Conv1d)
        return (
            _kio(c1.weight), c1.bias, n1.weight, n1.bias, lin.weight.t(), lin.bias,
            _kio(c2.weight), c2.bias, n2.weight, n2.bias,
            _kio(res.weight) if has_res else None, res.bias if has_res else None,
        )

    def kernel_params(self, dtype: torch.dtype = torch.float32) -> Tuple:
        return _packed(self, dtype, self._build)[0]

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        params, cached = _packed(self, x.dtype, self._build)
        return fused_residual_block(x.contiguous(), t.contiguous(), *params, weights_cached=cached)


class Downsample1d(nn.Module):
    """Stride-2 conv halving the horizon (reference: helpers.py:77-83)."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv1d(dim, dim, 3, 2, 1)

    def forward(self, x):
        return conv1d(x, self.conv.weight, self.conv.bias, stride=2, padding=1)


class Upsample1d(nn.Module):
    """ConvTranspose1d(4, 2, 1) doubling the horizon (reference: helpers.py:86-92)."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.ConvTranspose1d(dim, dim, 4, 2, 1)

    def forward(self, x):
        return conv1d_transpose(x, self.conv.weight, self.conv.bias, stride=2, padding=1)


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t):
        return sinusoidal_pos_emb(t, self.dim)


class TimeMLP(nn.Sequential):
    """SinusoidalPosEmb -> Linear(4d) -> Mish -> Linear(d) (reference: temporal.py:93-98);
    the float32 embedding is cast to the compute dtype ``dtype``."""

    def __init__(self, dim: int):
        super().__init__(
            SinusoidalPosEmb(dim), nn.Linear(dim, dim * 4), nn.Mish(), nn.Linear(dim * 4, dim)
        )

    def forward(self, t: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        x = self[0](t).to(dtype)
        return dense(mish(dense(x, self[1].weight, self[1].bias)), self[3].weight, self[3].bias)


class CondMLP(nn.Sequential):
    """Linear(d) -> Mish -> Linear(d) on the 2-d target point (reference: temporal.py:87-92)."""

    def __init__(self, dim: int, cond_dim: int = 2):
        super().__init__(nn.Linear(cond_dim, dim), nn.Mish(), nn.Linear(dim, dim))

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        return dense(mish(dense(c, self[0].weight, self[0].bias)), self[2].weight, self[2].bias)


class LinearAttention(nn.Module):
    """Linear attention over the horizon (reference: helpers.py:153-172): keys
    softmaxed over the sequence, context = k^T v per head, then queried."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = nn.Conv1d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Conv1d(hidden, dim, 1)

    def forward(self, x):
        B, L, _ = x.shape
        qkv = conv1d(x, self.to_qkv.weight)
        # heads are the slow axis of the channel dim ("(h c) d" in the reference)
        q, k, v = (a.reshape(B, L, self.heads, self.dim_head) for a in qkv.chunk(3, dim=-1))
        q = q * self.dim_head**-0.5
        k = torch.softmax(k.to(torch.float32), dim=1).to(q.dtype)
        context = torch.einsum("bnhd,bnhe->bhde", k, v)
        out = torch.einsum("bhde,bnhd->bnhe", context, q).reshape(B, L, -1)
        return conv1d(out, self.to_out.weight, self.to_out.bias)


class _ChannelLayerNorm(nn.Module):
    """The reference's channel LayerNorm, parameters ``g``/``b`` of shape (1, C, 1)."""

    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(1, dim, 1))
        self.b = nn.Parameter(torch.zeros(1, dim, 1))

    def forward(self, x):
        return channel_layer_norm(x, self.g, self.b)


class _PreNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = _ChannelLayerNorm(dim)
        self.fn = LinearAttention(dim)

    def forward(self, x):
        return self.fn(self.norm(x))


class PreNormAttention(nn.Module):
    """Residual(PreNorm(LinearAttention)) (reference: helpers.py:120-150);
    parameters ``fn.norm.g``, ``fn.norm.b``, ``fn.fn.to_qkv``, ``fn.fn.to_out``."""

    def __init__(self, dim: int):
        super().__init__()
        self.fn = _PreNorm(dim)

    def forward(self, x):
        return self.fn(x) + x


class _SelfAttention(nn.Module):
    """torch ``nn.MultiheadAttention``'s parameters (packed q/k/v in_proj)."""

    def __init__(self, dim: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)


def dropout(x: torch.Tensor, rate: float, training: bool, generator=None) -> torch.Tensor:
    """Inverted dropout (flax ``nn.Dropout``): each element kept with
    probability 1 - rate and scaled by 1 / (1 - rate), in training only. The
    mask is drawn from ``generator`` (None: the default generator) on the
    generator's device, or taken from a :class:`DropoutDraws`."""
    if not training or rate == 0.0:
        return x
    if isinstance(generator, DropoutDraws):
        u = generator.rand(x.shape)
    else:
        dev = x.device if generator is None else generator.device
        u = torch.rand(x.shape, generator=generator, device=dev)
    keep = u >= rate
    return x * keep.to(x.device, x.dtype) / (1.0 - rate)


class DropoutDraws:
    """The uniform draws of a forward's dropout masks, in the order it takes
    them: drawn from ``generator`` at first use and kept (``draws``), or
    given beforehand, so that a captured step reads them from fixed buffers.
    ``get_state`` / ``set_state`` move the cursor, as a generator's state
    moves, so a recompute (``TPU.REMAT``) takes the first pass's draws
    again."""

    def __init__(self, generator: Optional[torch.Generator] = None, draws=()):
        self.generator = generator
        self.draws = list(draws)
        self.pos = 0

    @property
    def device(self) -> torch.device:
        return self.draws[0].device if self.draws else self.generator.device

    def rand(self, shape) -> torch.Tensor:
        if self.pos == len(self.draws):
            if self.generator is None:
                raise RuntimeError(f"dropout draw {self.pos} of shape {tuple(shape)} was not given")
            self.draws.append(torch.rand(shape, generator=self.generator, device=self.generator.device))
        u = self.draws[self.pos]
        if tuple(u.shape) != tuple(shape):
            raise RuntimeError(f"dropout draw {self.pos} has shape {tuple(u.shape)}, the forward takes {tuple(shape)}")
        self.pos += 1
        return u

    def get_state(self) -> int:
        return self.pos

    def set_state(self, pos: int) -> None:
        self.pos = pos


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer with torch ``nn.TransformerEncoderLayer``'s
    parameters (batch_first, SiLU): x = norm1(x + MHA(x)); x = norm2(x + FF(x)).
    Dropout (``dropout_rate``, torch's 0.1) acts in training mode at the four
    places JAX ``blocks.py:332-344`` drops: the attention probabilities, the
    attention output, the feed-forward hidden and its output. JAX
    ``TorchLayerNorm`` is ``nn.LayerNorm`` here."""

    def __init__(self, dim: int, num_heads: int = 4, ff_dim: int = 256, dropout_rate: float = 0.1):
        super().__init__()
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.self_attn = _SelfAttention(dim)
        self.linear1 = nn.Linear(dim, ff_dim)
        self.linear2 = nn.Linear(ff_dim, dim)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)

    def forward(self, x, generator=None):
        B, L, D = x.shape
        hd = D // self.num_heads
        drop = lambda a: dropout(a, self.dropout_rate, self.training, generator)
        qkv = dense(x, self.self_attn.in_proj_weight, self.self_attn.in_proj_bias)
        q, k, v = (a.reshape(B, L, self.num_heads, hd).transpose(1, 2) for a in qkv.chunk(3, dim=-1))
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(hd)
        probs = drop(torch.softmax(scores.to(torch.float32), dim=-1).to(x.dtype))
        attn = torch.einsum("bhqk,bhkd->bhqd", probs, v).transpose(1, 2).reshape(B, L, D)
        out_proj = self.self_attn.out_proj
        x = layer_norm(x + drop(dense(attn, out_proj.weight, out_proj.bias)), self.norm1.weight, self.norm1.bias)
        h = drop(F.silu(dense(x, self.linear1.weight, self.linear1.bias)))
        h = drop(dense(h, self.linear2.weight, self.linear2.bias))
        return layer_norm(x + h, self.norm2.weight, self.norm2.bias)


class _Encoder(nn.Module):
    """torch ``nn.TransformerEncoder``'s parameter names: ``layers.i``, ``norm``."""

    def __init__(self, dim: int, num_heads: int, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(
            [TransformerEncoderLayer(dim, num_heads, dim * 4) for _ in range(num_layers)]
        )
        self.norm = nn.LayerNorm(dim)

    def forward(self, x, generator=None):
        for layer in self.layers:
            x = layer(x, generator)
        return layer_norm(x, self.norm.weight, self.norm.bias)


class TrajPredict(nn.Module):
    """Transformer predicting the 4-d state sequence from actions (reference:
    modeling/helpers.py:22-59): actions (B, L, 3) + time embedding -> (B, L, 4)."""

    def __init__(self, in_dim: int = 3, out_dim: int = 4, hidden_dim: int = 64,
                 num_heads: int = 4, num_layers: int = 2):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.input_proj = nn.Linear(in_dim, hidden_dim)
        self.encoder_traj = _Encoder(hidden_dim, num_heads, num_layers)
        self.output_proj = nn.Linear(hidden_dim, out_dim)

    def forward(self, x, time_embed, generator=None):
        """``generator``: the dropout masks' (training mode only)."""
        L = x.shape[1]
        pos = sinusoidal_pos_emb(torch.arange(L, dtype=torch.float32, device=x.device), self.hidden_dim)
        h = dense(x, self.input_proj.weight, self.input_proj.bias)
        h = h + pos[None].to(h.dtype) + time_embed[:, None, :].to(h.dtype)
        return dense(self.encoder_traj(h, generator), self.output_proj.weight, self.output_proj.bias)
