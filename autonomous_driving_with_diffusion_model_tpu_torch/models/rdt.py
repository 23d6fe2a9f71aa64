"""RDT-1B, the Robotics Diffusion Transformer (Liu et al., "RDT-1B: a
Diffusion Foundation Model for Bimanual Manipulation", ICLR 2025;
github.com/thu-ml/RoboticsDiffusionTransformer, ``configs/base.yaml``,
``models/rdt/{model,blocks}.py``, ``models/rdt_runner.py``), on the port's
planner: ``MODEL.ARCH`` ``rdt``.

:class:`RDTRunner` holds what one plan runs:

* ``vision``: SigLIP's tower (``models/siglip.py``) over the plan's image
  slots: ``MODEL.N_OBS_STEPS`` frames x ``MODEL.RDT.CAMERAS`` cameras, the
  real cameras first in each frame's group and RDT's background image in the
  others, ``(S // patch)^2`` tokens each;
* the condition adaptors (``lang_adaptor``, ``img_adaptor``,
  ``state_adaptor``: ``mlp<n>x_gelu``, a Linear to the hidden width, then
  n - 1 times GELU(tanh) and a Linear);
* ``model``, the DiT: the tokens ``[t, ctrl_freq, state, actions]``, each
  of ``t`` and ``ctrl_freq`` from a timestep embedder (a 256-wide [cos |
  sin] sinusoid, Linear, SiLU, Linear), plus a position table; ``depth``
  blocks of ``x += SelfAttn(RMSNorm(x))``, ``x += CrossAttn(RMSNorm(x), c,
  mask)``, ``x += MLP(RMSNorm(x))`` (q/k/v with biases and RMSNorm over the
  head dim on q and k; the MLP hidden-wide with GELU(tanh)), the condition
  ``c`` the instruction's tokens with their padding mask in even blocks and
  the image tokens in odd ones, each plus its position table; a final
  RMSNorm and MLP to the action width, of which the last ``horizon`` tokens
  are the action chunk.

The action and state vectors live in RDT's unified ``STATE_DIM``-wide space
with a mask: the driving transition's 7 channels (x, y, yaw, speed,
throttle, steer, brake) sit at ``MODEL.RDT.ACTION_SLOTS``, the target point
at ``MODEL.RDT.TARGET_SLOTS``; the mask is 1 on both, and the state vector
holds the target there and zeros elsewhere (the ego frame's origin; the
request carries no speed). The state token and each step's action tokens
are the vector concatenated with the mask, through ``state_adaptor``.

Parameter names follow RDT's (``model.t_embedder.mlp``, ``model.blocks.<i>
.{norm1, attn.qkv, attn.q_norm, attn.k_norm, attn.proj, norm2,
cross_attn.{q, kv, q_norm, k_norm, proj}, norm3, ffn.fc1, ffn.fc2}``,
``model.final_layer.{norm_final, ffn_final}``, ``model.{x, lang_cond,
img_cond}_pos_embed``), with the vision tower as ``vision``. The model
holds its weights in the compute dtype (bfloat16, as RDT's inference runs);
RMSNorm and LayerNorm run in float32 and the softmax accumulates in float32
inside ``F.scaled_dot_product_attention``.

The model serves only: the train and distill CLIs refuse it; one
hypothesis, no guidance. The planner encodes a plan's conditions once
(:meth:`RDTRunner.encode_obs`), turns them into every block's
cross-attention keys and values once (:meth:`RDTRunner.condition_kv`: the
position table added, ``kv``, ``k_norm``), and the sampler calls the model
each step on them; RDT computes them again in every step, and
:meth:`RDT.forward` still does so when it is given the conditions alone.
"""

from __future__ import annotations

import math
import re
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from ..ops.nn import attention, count_cross_kv, dense, gelu_tanh, rms_norm
from ..utils.constants import MAGIC_NUM
from .siglip import SiglipVisionTower, background, square_resize

__all__ = ["RDTCondition", "RDT", "RDTRunner", "adaptor_depth", "FREQ_EMBED"]

FREQ_EMBED = 256  # the timestep embedders' sinusoid width
NORM_EPS = 1e-6


def adaptor_depth(name: str) -> int:
    """The Linear layers of an ``mlp<n>x_gelu`` adaptor."""
    m = re.fullmatch(r"mlp(\d+)x_gelu", name)
    if m is None:
        raise ValueError(f"adaptor {name!r}: RDT's adaptors are mlp<n>x_gelu")
    return int(m.group(1))


class RDTCondition(NamedTuple):
    """A plan's adapted conditions, each (B, tokens, hidden) in the compute
    dtype: the state token, the instruction with its (B, 1, 1, L) boolean
    padding mask, and the image tokens; ``kv``, once
    :meth:`RDTRunner.condition_kv` has made it, each block's
    cross-attention (k, v) of its condition."""

    state: torch.Tensor
    lang: torch.Tensor
    lang_mask: torch.Tensor
    img: torch.Tensor
    kv: Optional[Tuple[Tuple[torch.Tensor, torch.Tensor], ...]] = None


def _adaptor(in_features: int, hidden: int, name: str) -> nn.Sequential:
    layers = [nn.Linear(in_features, hidden)]
    for _ in range(adaptor_depth(name) - 1):
        layers += [nn.GELU(approximate="tanh"), nn.Linear(hidden, hidden)]
    return nn.Sequential(*layers)


def _adapt(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    x = dense(x, seq[0].weight, seq[0].bias)
    for lin in seq[2::2]:
        x = dense(gelu_tanh(x), lin.weight, lin.bias)
    return x


class RmsNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, NORM_EPS)


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(FREQ_EMBED, hidden), nn.SiLU(), nn.Linear(hidden, hidden))

    def forward(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """t (B,) -> (B, hidden): [cos | sin] of t times 10000^(-i / 128),
        in float32, then the MLP in ``dtype``."""
        half = FREQ_EMBED // 2
        freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
        args = t.to(torch.float32)[:, None] * freqs[None]
        x = torch.cat([torch.cos(args), torch.sin(args)], dim=-1).to(dtype)
        x = torch.nn.functional.silu(dense(x, self.mlp[0].weight, self.mlp[0].bias))
        return dense(x, self.mlp[2].weight, self.mlp[2].bias)


class Mlp(nn.Module):
    def __init__(self, width: int, hidden: int, out: int):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(width, hidden), nn.Linear(hidden, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(gelu_tanh(dense(x, self.fc1.weight, self.fc1.bias)), self.fc2.weight, self.fc2.bias)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, N, C) -> (B, heads, N, C / heads)."""
    return x.reshape(x.shape[0], x.shape[1], heads, -1).transpose(1, 2)


def _merge(o: torch.Tensor) -> torch.Tensor:
    """(B, heads, N, d) -> (B, N, heads x d)."""
    return o.transpose(1, 2).reshape(o.shape[0], o.shape[2], -1)


class Attention(nn.Module):
    """Self-attention, timm's ``Attention`` with ``qkv_bias`` and ``qk_norm``
    (RMSNorm)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.q_norm, self.k_norm = RmsNorm(dim // heads), RmsNorm(dim // heads)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (_heads(p, self.heads) for p in dense(x, self.qkv.weight, self.qkv.bias).chunk(3, dim=-1))
        o = attention(self.q_norm(q), self.k_norm(k), v)
        return dense(_merge(o), self.proj.weight, self.proj.bias)


class CrossAttention(nn.Module):
    """RDT's ``CrossAttention``: q from x, k and v from the condition, QK-norm,
    the condition's boolean mask (B, 1, 1, L) where it has one."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.q_norm, self.k_norm = RmsNorm(dim // heads), RmsNorm(dim // heads)
        self.proj = nn.Linear(dim, dim)

    def keys_values(self, c: torch.Tensor, pos: torch.Tensor):
        """The condition c (B, L, dim) as the attention reads it: c plus its
        position table ``pos`` through ``kv``, k RMS-normalised over the
        head dim; (k, v), each contiguous (B, heads, L, dim / heads).
        Counts the B x L tokens (``attention.cross_kv``)."""
        count_cross_kv(c.shape[0] * c.shape[1])
        k, v = (_heads(p, self.heads) for p in dense(c + pos, self.kv.weight, self.kv.bias).chunk(2, dim=-1))
        return self.k_norm(k.contiguous()), v.contiguous()

    def forward(self, x: torch.Tensor, kv, mask=None) -> torch.Tensor:
        """x (B, N, dim); ``kv`` the condition's (k, v) from
        :meth:`keys_values`."""
        q = _heads(dense(x, self.q.weight, self.q.bias), self.heads)
        o = attention(self.q_norm(q), *kv, mask, cross=True)
        return dense(_merge(o), self.proj.weight, self.proj.bias)


class RDTBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm1 = RmsNorm(dim)
        self.attn = Attention(dim, heads)
        self.cross_attn = CrossAttention(dim, heads)
        self.norm2 = RmsNorm(dim)
        self.ffn = Mlp(dim, dim, dim)
        self.norm3 = RmsNorm(dim)

    def forward(self, x: torch.Tensor, kv, mask=None) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        x = x + self.cross_attn(self.norm2(x), kv, mask)
        return x + self.ffn(self.norm3(x))


class FinalLayer(nn.Module):
    def __init__(self, dim: int, out: int):
        super().__init__()
        self.norm_final = RmsNorm(dim)
        self.ffn_final = Mlp(dim, dim, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ffn_final(self.norm_final(x))


class RDT(nn.Module):
    """RDT's DiT: ``forward(x, freq, t, lang_c, img_c, lang_mask)`` with x the
    (B, 1 + horizon, hidden) state and action tokens; the blocks read their
    conditions' keys and values from ``kv`` (:meth:`condition_kv`), made
    from ``lang_c`` and ``img_c`` where it is not given."""

    def __init__(self, out: int, horizon: int, hidden: int, depth: int, heads: int, max_lang_len: int,
                 img_len: int):
        super().__init__()
        self.horizon = horizon
        self.t_embedder = TimestepEmbedder(hidden)
        self.freq_embedder = TimestepEmbedder(hidden)
        self.x_pos_embed = nn.Parameter(torch.zeros(1, horizon + 3, hidden))
        self.lang_cond_pos_embed = nn.Parameter(torch.zeros(1, max_lang_len, hidden))
        self.img_cond_pos_embed = nn.Parameter(torch.zeros(1, img_len, hidden))
        self.blocks = nn.ModuleList([RDTBlock(hidden, heads) for _ in range(depth)])
        self.final_layer = FinalLayer(hidden, out)

    def condition_kv(self, lang_c: torch.Tensor, img_c: torch.Tensor):
        """Every block's cross-attention (k, v) of its condition
        (:meth:`CrossAttention.keys_values`), with the condition's position
        table: block i's of ``lang_c`` if i is even, of ``img_c`` if odd."""
        conds = ((lang_c, self.lang_cond_pos_embed[:, :lang_c.shape[1]]), (img_c, self.img_cond_pos_embed))
        return tuple(block.cross_attn.keys_values(*conds[i % 2]) for i, block in enumerate(self.blocks))

    def forward(self, x, freq, t, lang_c, img_c, lang_mask, kv=None):
        dt = x.dtype
        B = x.shape[0]
        t = self.t_embedder(t, dt)[:, None].expand(B, -1, -1)
        freq = self.freq_embedder(freq, dt)[:, None].expand(B, -1, -1)
        x = torch.cat([t, freq, x], dim=1) + self.x_pos_embed
        kv = self.condition_kv(lang_c, img_c) if kv is None else kv
        masks = (lang_mask, None)
        for i, block in enumerate(self.blocks):
            x = block(x, kv[i], masks[i % 2])
        return self.final_layer(x)[:, -self.horizon:]


class RDTRunner(nn.Module):
    """The planner's model for ``MODEL.ARCH`` ``rdt``: the vision tower, the
    adaptors and the DiT (module docstring).

    What the planner and the sampler read of it: ``instruction_shape``, the
    (tokens, width) of the instruction a plan takes beside its frames and
    target; ``action_space_sampler``, that the sampler runs as RDT's runner
    sets up diffusers' DPMSolverMultistepScheduler, in the model's action
    space: the x0 prediction neither clipped nor thresholded, no lambda clip,
    no step zeroing the first waypoint, no clamp and no scaling to meters."""

    action_space_sampler = True

    def __init__(self, cfg):
        super().__init__()
        r = cfg.MODEL.RDT
        self.n_obs_steps = int(cfg.MODEL.N_OBS_STEPS)  # RDT's img_history_size
        self.cameras, self.real_cameras = int(r.CAMERAS), int(r.REAL_CAMERAS)
        if not 1 <= self.real_cameras <= self.cameras:
            raise ValueError(f"MODEL.RDT.REAL_CAMERAS {self.real_cameras}: 1 to CAMERAS ({self.cameras})")
        self.action_dim = int(r.STATE_DIM)
        self.instruction_shape = (int(r.LANG_SLOTS), int(r.LANG_DIM))
        self.ctrl_freq = float(r.CTRL_FREQ)
        slots = [int(s) for s in (*r.ACTION_SLOTS, *r.TARGET_SLOTS)]
        if len(r.ACTION_SLOTS) != cfg.MODEL.TRANSITION_DIM or len(r.TARGET_SLOTS) != 2 or len(set(slots)) != len(
                slots) or not all(0 <= s < self.action_dim for s in slots):
            raise ValueError(f"MODEL.RDT.ACTION_SLOTS / TARGET_SLOTS {slots}: TRANSITION_DIM and 2 distinct "
                             f"slots of the {self.action_dim}-wide action")
        hidden = int(r.HIDDEN)
        self.vision = SiglipVisionTower(r.VISION_WIDTH, r.VISION_DEPTH, r.VISION_HEADS, r.VISION_MLP,
                                        r.IMAGE_SIZE, r.PATCH)
        img_len = self.n_obs_steps * self.cameras * self.vision.tokens
        self.lang_adaptor = _adaptor(int(r.LANG_DIM), hidden, r.LANG_ADAPTOR)
        self.img_adaptor = _adaptor(int(r.VISION_WIDTH), hidden, r.IMG_ADAPTOR)
        self.state_adaptor = _adaptor(2 * self.action_dim, hidden, r.STATE_ADAPTOR)
        self.model = RDT(self.action_dim, int(cfg.MODEL.HORIZON), hidden, int(r.DEPTH), int(r.HEADS),
                         int(r.MAX_LANG_LEN), img_len)
        self._slots = slots
        # device tensors made once: a captured plan may not copy from the host
        self.register_buffer("action_mask", self._action_mask(), persistent=False)
        self.register_buffer("action_slots", torch.tensor(slots[:-2]), persistent=False)
        self.register_buffer("target_slots", torch.tensor(slots[-2:]), persistent=False)

    def _action_mask(self) -> torch.Tensor:
        mask = torch.zeros(self.action_dim)
        mask[self._slots] = 1.0
        return mask

    @torch.no_grad()
    def init_rest(self, generator: torch.Generator) -> None:
        """What ``models.temporal_unet.init_parameters`` leaves, for a model
        made on the ``meta`` device and materialised empty: the position
        tables (RDT's and SigLIP's) drawn normal(0, 0.02) from ``generator``
        on its device, every RMSNorm's gain set to 1, the action mask and
        slots."""
        for p in (self.model.x_pos_embed, self.model.lang_cond_pos_embed, self.model.img_cond_pos_embed,
                  self.vision.embeddings.position_embedding.weight):
            p.copy_(torch.empty(p.shape, device=generator.device).normal_(0.0, 0.02, generator=generator))
        for mod in self.modules():
            if isinstance(mod, RmsNorm):
                mod.weight.fill_(1.0)
        self.action_mask.copy_(self._action_mask())
        self.action_slots.copy_(torch.tensor(self._slots[:-2]))
        self.target_slots.copy_(torch.tensor(self._slots[-2:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.model.x_pos_embed.dtype

    def encode_obs(self, frames_u8: torch.Tensor, target: torch.Tensor, lang: torch.Tensor,
                   lang_mask: torch.Tensor) -> RDTCondition:
        """A plan's conditions: ``frames_u8`` (N_OBS_STEPS, H, W, 3), oldest
        first, each frame the real camera's (the slots of the other cameras
        hold the background image); ``target`` (1, 2); the instruction
        ``lang`` (L, LANG_DIM) and its boolean ``lang_mask`` (L,)."""
        dt = self.dtype
        size = self.vision.image_size
        real = square_resize(frames_u8, size)
        bg = background(size, frames_u8.device)
        slots = []
        for frame in real.reshape(-1, self.real_cameras, size, size, 3):  # a frame's group of cameras
            slots += [*frame, *[bg] * (self.cameras - self.real_cameras)]
        tokens = self.vision(torch.stack(slots).to(dt))
        img = _adapt(self.img_adaptor, tokens.reshape(1, -1, tokens.shape[-1]))
        state = torch.zeros((1, 1, self.action_dim), dtype=torch.float32, device=frames_u8.device)
        state = state.index_copy(2, self.target_slots, target.to(torch.float32)[None])
        mask = self.action_mask.to(torch.float32).expand_as(state)
        state = _adapt(self.state_adaptor, torch.cat([state, mask], -1).to(dt))
        lang = _adapt(self.lang_adaptor, lang.to(dt)[None])
        return RDTCondition(state, lang, lang_mask.to(torch.bool).reshape(1, 1, 1, -1), img)

    def condition_kv(self, cond: RDTCondition) -> RDTCondition:
        """``cond`` with every block's cross-attention keys and values of
        its conditions (``kv``), which the steps of a plan then read."""
        return cond._replace(kv=self.model.condition_kv(cond.lang, cond.img))

    def forward(self, x: torch.Tensor, time: torch.Tensor, img_feature: RDTCondition) -> torch.Tensor:
        """The x0 prediction of one step: x (B, horizon, STATE_DIM) the noisy
        action chunk; time (B,); ``img_feature`` the plan's conditions (the
        sampler's name for them), with their keys and values where
        :meth:`condition_kv` made them -> (B, horizon, STATE_DIM)."""
        c, dt, B = img_feature, self.dtype, x.shape[0]
        mask = self.action_mask.to(dt).expand(B, x.shape[1], -1)
        actions = _adapt(self.state_adaptor, torch.cat([x.to(dt), mask], -1))
        tokens = torch.cat([c.state.expand(B, -1, -1), actions], dim=1)
        freq = torch.full((B,), self.ctrl_freq, dtype=torch.float32, device=x.device)
        kv = None if c.kv is None else tuple((k.expand(B, -1, -1, -1), v.expand(B, -1, -1, -1)) for k, v in c.kv)
        return self.model(tokens, freq, time, c.lang.expand(B, -1, -1), c.img.expand(B, -1, -1), c.lang_mask, kv)

    def transitions(self, actions: torch.Tensor) -> torch.Tensor:
        """The driving transitions of an action chunk: (B, horizon,
        TRANSITION_DIM) read from ``ACTION_SLOTS``, xy in meters."""
        x = actions.index_select(-1, self.action_slots).to(torch.float32)
        return torch.cat([x[..., :2] * MAGIC_NUM, x[..., 2:]], dim=-1)
