"""RDT-1B's planner in plain PyTorch: SigLIP's vision tower, the condition
adaptors, the diffusion transformer and a DPM-Solver++ plan, float32,
written from the published description (Liu et al., "RDT-1B: a Diffusion
Foundation Model for Bimanual Manipulation", ICLR 2025;
github.com/thu-ml/RoboticsDiffusionTransformer ``configs/base.yaml``,
``models/rdt/{model,blocks}.py``, ``models/rdt_runner.py``; SigLIP
so400m-patch14-384 as ``transformers``' ``SiglipVisionTransformer``;
diffusers' ``DPMSolverMultistepScheduler``). It imports nothing but torch,
numpy and the standard library; TF32 is the caller's to turn off
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``). Attention is written out: ``softmax(q
k^T / sqrt(d) + mask) v`` by matrix products.

* Images: a frame padded to a square with the processor's mean colour
  (127), centred; resized to 384 x 384, bicubic with antialiasing
  (``F.interpolate``), in float32 without rounding to uint8; scaled to [0,
  1], then ``(x - 0.5) / 0.5``. A plan's image slots are, frame by frame
  (oldest first), the real cameras' frames then RDT's background image
  (the mean colour) for each absent camera.
* SigLIP: a 14 x 14 stride-14 convolution, a learned position table, 27
  pre-LayerNorm layers (eps 1e-6; 16-head attention with biases; fc1,
  GELU(tanh), fc2), the post-LayerNorm; every patch token is kept.
* Adaptors ``mlp<n>x_gelu``: Linear to the hidden width, then n - 1 times
  GELU(tanh) and Linear. Language from the instruction's tokens, images
  from SigLIP's tokens, the state and each action token from ``[vector |
  mask]``.
* DiT: tokens ``[t, ctrl_freq, state, actions]`` plus a position table;
  ``t`` and ``ctrl_freq`` each through a timestep embedder ([cos | sin] of
  256 frequencies 10000^(-i / 128), Linear, SiLU, Linear); blocks of
  ``x += SelfAttn(RMSNorm(x))``, ``x += CrossAttn(RMSNorm(x), c, mask)``,
  ``x += MLP(RMSNorm(x))`` (RMSNorm eps 1e-6 with a weight; q/k/v biased;
  RMSNorm over the head dim on q and k; the MLP hidden-wide, GELU(tanh)),
  ``c`` the language tokens with their mask in even blocks and the image
  tokens in odd ones, each plus its position table; a final RMSNorm and MLP
  to the action width; the last ``horizon`` tokens are the x0 prediction.
* Sampler: diffusers' DPMSolverMultistepScheduler (``dpmsolver++``, order 2,
  ``sample`` prediction, no thresholding, ``lower_order_final``, final sigma
  0) on 1000 ``squaredcos_cap_v2`` training steps, the "linspace" grid with
  ``lambda_min_clipped`` -inf; its coefficients in float64. The result is
  multiplied by the action mask, as RDT's runner does.

Departures from the published description, each this system's:

* one real camera; the other two cameras' slots hold the background image,
  as RDT's inference fills an absent camera;
* the action is the system's 7-wide transition, read from fixed slots of
  the 128-wide unified vector, xy scaled to meters (23.315 m a unit); the
  target point sits in two more slots of the state vector (zeros elsewhere);
  the mask is 1 on those nine slots;
* the instruction is a seeded stand-in for T5-v1.1-XXL's embedding at its
  published width, in a fixed number of slots with a padding mask;
* the sampler's state stays float32 between steps (RDT casts it to
  bfloat16);
* weights are random, made by the caller.

``plan_batch``'s ``variant`` plants a fault or the precision control, for
setting the cell's limit: ``"mask_ignored"`` (the language mask left out),
``"alternation_swapped"`` (odd blocks take the language, even ones the
images), ``"t_off_by_one"`` (the model told the grid's next timestep, the
last step 0) and ``"float8"`` (every linear layer's and convolution's input
and weight rounded to float8 e4m3 with a per-tensor scale, the precision
below the configuration's bfloat16; it rounds the model's weights in place).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["MAGIC_NUM", "RDTReference", "build_reference", "preprocess", "dpm_grid", "plan_batch", "VARIANTS"]

MAGIC_NUM = 23.315  # meters per normalized trajectory unit
MEAN, STD = 0.5, 0.5
EPS = 1e-6
VARIANTS = ("sound", "mask_ignored", "alternation_swapped", "t_off_by_one", "float8")


def _attend(q, k, v, mask=None):
    """q (B, h, N, d), k and v (B, h, L, d), mask (B, L) bool or None."""
    s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    if mask is not None:
        s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    return torch.softmax(s, dim=-1) @ v


def _split(x, heads):
    B, N, C = x.shape
    return x.reshape(B, N, heads, C // heads).permute(0, 2, 1, 3)


def _join(o):
    B, h, N, d = o.shape
    return o.permute(0, 2, 1, 3).reshape(B, N, h * d)


# ------------------------------------------------------------------ SigLIP


class SiglipEmbeddings(nn.Module):
    def __init__(self, width, image_size, patch):
        super().__init__()
        self.patch_embedding = nn.Conv2d(3, width, patch, patch)
        self.position_embedding = nn.Embedding((image_size // patch) ** 2, width)

    def forward(self, images):  # (B, 3, S, S)
        x = self.patch_embedding(images).flatten(2).transpose(1, 2)
        return x + self.position_embedding.weight


class SiglipAttention(nn.Module):
    def __init__(self, width, heads):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (nn.Linear(width, width) for _ in range(4))

    def forward(self, x):
        o = _attend(_split(self.q_proj(x), self.heads), _split(self.k_proj(x), self.heads),
                    _split(self.v_proj(x), self.heads))
        return self.out_proj(_join(o))


class SiglipMLP(nn.Module):
    def __init__(self, width, mlp):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(width, mlp), nn.Linear(mlp, width)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class SiglipLayer(nn.Module):
    def __init__(self, width, heads, mlp):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(width, eps=EPS)
        self.self_attn = SiglipAttention(width, heads)
        self.layer_norm2 = nn.LayerNorm(width, eps=EPS)
        self.mlp = SiglipMLP(width, mlp)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class SiglipEncoder(nn.Module):
    def __init__(self, width, depth, heads, mlp):
        super().__init__()
        self.layers = nn.ModuleList([SiglipLayer(width, heads, mlp) for _ in range(depth)])


class SiglipTower(nn.Module):
    def __init__(self, width, depth, heads, mlp, image_size, patch):
        super().__init__()
        self.embeddings = SiglipEmbeddings(width, image_size, patch)
        self.encoder = SiglipEncoder(width, depth, heads, mlp)
        self.post_layernorm = nn.LayerNorm(width, eps=EPS)

    def forward(self, images):
        x = self.embeddings(images)
        for layer in self.encoder.layers:
            x = layer(x)
        return self.post_layernorm(x)


# ------------------------------------------------------------------ RDT


class RmsNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + EPS) * self.weight


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden, freq=256):
        super().__init__()
        self.freq = freq
        self.mlp = nn.Sequential(nn.Linear(freq, hidden), nn.SiLU(), nn.Linear(hidden, hidden))

    def forward(self, t):  # (B,)
        half = self.freq // 2
        freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
        args = t.float()[:, None] * freqs[None]
        return self.mlp(torch.cat([torch.cos(args), torch.sin(args)], dim=-1))


class Mlp(nn.Module):
    def __init__(self, width, hidden, out):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(width, hidden), nn.Linear(hidden, out)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class SelfAttention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.q_norm, self.k_norm = RmsNorm(dim // heads), RmsNorm(dim // heads)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        q, k, v = self.qkv(x).reshape(B, N, 3, self.heads, C // self.heads).permute(2, 0, 3, 1, 4)
        return self.proj(_join(_attend(self.q_norm(q), self.k_norm(k), v)))


class CrossAttention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.q_norm, self.k_norm = RmsNorm(dim // heads), RmsNorm(dim // heads)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, c, mask=None):
        B, L, C = c.shape
        q = _split(self.q(x), self.heads)
        k, v = self.kv(c).reshape(B, L, 2, self.heads, C // self.heads).permute(2, 0, 3, 1, 4)
        return self.proj(_join(_attend(self.q_norm(q), self.k_norm(k), v, mask)))


class RDTBlock(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.norm1 = RmsNorm(dim)
        self.attn = SelfAttention(dim, heads)
        self.cross_attn = CrossAttention(dim, heads)
        self.norm2 = RmsNorm(dim)
        self.ffn = Mlp(dim, dim, dim)
        self.norm3 = RmsNorm(dim)

    def forward(self, x, c, mask=None):
        x = x + self.attn(self.norm1(x))
        x = x + self.cross_attn(self.norm2(x), c, mask)
        return x + self.ffn(self.norm3(x))


class FinalLayer(nn.Module):
    def __init__(self, dim, out):
        super().__init__()
        self.norm_final = RmsNorm(dim)
        self.ffn_final = Mlp(dim, dim, out)

    def forward(self, x):
        return self.ffn_final(self.norm_final(x))


class DiT(nn.Module):
    def __init__(self, out, horizon, hidden, depth, heads, max_lang_len, img_len):
        super().__init__()
        self.horizon = horizon
        self.t_embedder = TimestepEmbedder(hidden)
        self.freq_embedder = TimestepEmbedder(hidden)
        self.x_pos_embed = nn.Parameter(torch.zeros(1, horizon + 3, hidden))
        self.lang_cond_pos_embed = nn.Parameter(torch.zeros(1, max_lang_len, hidden))
        self.img_cond_pos_embed = nn.Parameter(torch.zeros(1, img_len, hidden))
        self.blocks = nn.ModuleList([RDTBlock(hidden, heads) for _ in range(depth)])
        self.final_layer = FinalLayer(hidden, out)

    def forward(self, x, freq, t, lang_c, img_c, lang_mask, swapped=False):
        t = self.t_embedder(t)[:, None]
        freq = self.freq_embedder(freq)[:, None]
        x = torch.cat([t, freq, x], dim=1) + self.x_pos_embed
        lang_c = lang_c + self.lang_cond_pos_embed[:, :lang_c.shape[1]]
        img_c = img_c + self.img_cond_pos_embed
        for i, block in enumerate(self.blocks):
            language = (i % 2 == 0) != swapped
            x = block(x, lang_c, lang_mask) if language else block(x, img_c)
        return self.final_layer(x)[:, -self.horizon:]


def _adaptor(in_features, hidden, name):
    depth = int(name[len("mlp"):-len("x_gelu")])
    layers = [nn.Linear(in_features, hidden)]
    for _ in range(depth - 1):
        layers += [nn.GELU(approximate="tanh"), nn.Linear(hidden, hidden)]
    return nn.Sequential(*layers)


class RDTReference(nn.Module):
    """SigLIP, the three adaptors and the DiT, named as the program names
    them (``vision``, ``lang_adaptor``, ``img_adaptor``, ``state_adaptor``,
    ``model``)."""

    def __init__(self, m):
        super().__init__()
        r = m["RDT"]
        self.cameras, self.real = int(r["CAMERAS"]), int(r["REAL_CAMERAS"])
        self.image_size, self.width = int(r["IMAGE_SIZE"]), int(r["STATE_DIM"])
        self.ctrl_freq = float(r["CTRL_FREQ"])
        self.action_slots, self.target_slots = list(r["ACTION_SLOTS"]), list(r["TARGET_SLOTS"])
        img_len = int(m["N_OBS_STEPS"]) * self.cameras * (self.image_size // int(r["PATCH"])) ** 2
        hidden = int(r["HIDDEN"])
        self.vision = SiglipTower(r["VISION_WIDTH"], r["VISION_DEPTH"], r["VISION_HEADS"], r["VISION_MLP"],
                                  self.image_size, r["PATCH"])
        self.lang_adaptor = _adaptor(r["LANG_DIM"], hidden, r["LANG_ADAPTOR"])
        self.img_adaptor = _adaptor(r["VISION_WIDTH"], hidden, r["IMG_ADAPTOR"])
        self.state_adaptor = _adaptor(2 * self.width, hidden, r["STATE_ADAPTOR"])
        self.model = DiT(self.width, int(m["HORIZON"]), hidden, r["DEPTH"], r["HEADS"], r["MAX_LANG_LEN"], img_len)

    def mask(self, device):
        out = torch.zeros(self.width, device=device)
        out[self.action_slots + self.target_slots] = 1.0
        return out


def build_reference(model_cfg: dict, device=None) -> RDTReference:
    """The network of a configuration's ``MODEL`` group, in eval mode,
    parameters uninitialized: load a state dict into it."""
    if model_cfg.get("ARCH") != "rdt":
        raise ValueError("the reference covers MODEL.ARCH rdt")
    with torch.device(device or "cpu"):
        model = RDTReference(model_cfg)
    return model.eval()


# ------------------------------------------------------------------ plan


def preprocess(frames_u8, size):
    """(N, H, W, 3) uint8 -> (N, 3, size, size): padded to a square with the
    mean colour, resized, normalized."""
    x = frames_u8.float().permute(0, 3, 1, 2) / 255.0
    h, w = x.shape[-2:]
    side = max(h, w)
    top, left = (side - h) // 2, (side - w) // 2
    canvas = torch.full((x.shape[0], 3, side, side), 127 / 255.0, device=x.device)
    canvas[:, :, top:top + h, left:left + w] = x
    x = F.interpolate(canvas, size=(size, size), mode="bicubic", antialias=True, align_corners=False)
    return (x - MEAN) / STD


def dpm_grid(num_train_timesteps: int, steps: int):
    """The linspace grid (no lambda clip) and, per step, (alpha_t, sigma_t,
    lambda_t) of the step's timestep and of the one it steps to (the last
    to sigma 0), in float64 from the squaredcos_cap_v2 schedule."""
    bar = lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
    n = num_train_timesteps
    betas = np.array([min(1 - bar((i + 1) / n) / bar(i / n), 0.999) for i in range(n)])
    ac = np.cumprod(1.0 - betas)
    ts = np.linspace(0, n - 1, steps + 1).round()[::-1][:-1].astype(np.int64)
    sig = np.sqrt((1 - ac[ts]) / ac[ts])
    alpha = 1.0 / np.sqrt(sig ** 2 + 1.0)
    sigma = sig * alpha
    alpha = np.append(alpha, 1.0)  # the final sigma is 0
    sigma = np.append(sigma, 0.0)
    with np.errstate(divide="ignore"):
        lam = np.log(alpha) - np.log(sigma)
    return ts, alpha, sigma, lam


def _float8(model):
    """Round every linear layer's and convolution's weight (in place) and
    input to float8 e4m3 with a per-tensor scale (amax / 448)."""

    def q(x):
        s = x.abs().amax().clamp_min(1e-12) / 448.0
        return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s

    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            mod.weight.data.copy_(q(mod.weight.data))
            mod.register_forward_pre_hook(lambda m, args: (q(args[0]),) + tuple(args[1:]))


@torch.no_grad()
def plan_batch(model, cfg: dict, frames_u8, targets, init, lang, lang_mask, variant: str = "sound"):
    """Plans of N requests, each over its own history: ``frames_u8`` (N,
    n_obs, H, W, 3) and ``targets`` (N, n_obs, 2), oldest first (the state
    takes the newest target); ``init`` (N, K, horizon, STATE_DIM) the
    starting noise; ``lang`` (N, L, LANG_DIM) and ``lang_mask`` (N, L) the
    instruction. Returns ((N, K, horizon, 7) trajectories with xy in
    meters, (N, K) scores (the xy path's squared jerk), (N,) best index)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    sched = cfg["TRAIN"]["NOISE_SCHEDULER"]
    if cfg["EVAL"]["SCHEDULER"] != "dpm" or sched["PRED_TYPE"] != "sample" or sched["TYPE"] != "squaredcos_cap_v2":
        raise ValueError("the reference plans with DPM-Solver++, sample prediction, squaredcos_cap_v2")
    if variant == "float8":
        _float8(model)
    dev = init.device
    N, K = init.shape[:2]
    n_obs = frames_u8.shape[1]
    S = model.image_size
    real = preprocess(frames_u8.reshape(-1, *frames_u8.shape[2:]), S).reshape(N, n_obs, model.real, 3, S, S)
    bg = torch.full((N, n_obs, model.cameras - model.real, 3, S, S), (127 / 255.0 - MEAN) / STD, device=dev)
    images = torch.cat([real, bg], dim=2).reshape(-1, 3, S, S)
    tokens = model.vision(images)
    img_c = model.img_adaptor(tokens.reshape(N, -1, tokens.shape[-1])).repeat_interleave(K, 0)
    lang_c = model.lang_adaptor(lang.float()).repeat_interleave(K, 0)
    mask = lang_mask.bool().repeat_interleave(K, 0)
    if variant == "mask_ignored":
        mask = torch.ones_like(mask)
    amask = model.mask(dev)
    state = torch.zeros(N, 1, model.width, device=dev)
    state[:, 0, model.target_slots] = targets[:, -1].float()
    state_c = model.state_adaptor(torch.cat([state, amask.expand_as(state)], -1)).repeat_interleave(K, 0)
    ts, alpha, sigma, lam = dpm_grid(int(cfg["TRAIN"]["SAMPLE_STEPS"]), int(cfg["EVAL"]["SAMPLE_STEPS"]))
    shown = list(ts[1:]) + [0] if variant == "t_off_by_one" else list(ts)
    x = init.float().reshape(N * K, *init.shape[2:])
    freq = torch.full((N * K,), model.ctrl_freq, device=dev)
    last = len(ts) - 1
    prev_x0 = None
    for i, t in enumerate(ts):
        actions = model.state_adaptor(torch.cat([x, amask.expand_as(x)], -1))
        x0 = model.model(torch.cat([state_c, actions], 1), freq, torch.full((N * K,), float(shown[i]), device=dev),
                         lang_c, img_c, mask, swapped=variant == "alternation_swapped")
        h = lam[i + 1] - lam[i]
        ratio, phi = sigma[i + 1] / sigma[i], alpha[i + 1] * math.expm1(-h)
        if i == 0 or i == last:  # first order: the first step, and the last (lower_order_final)
            x = ratio * x - phi * x0
        else:  # the 2M midpoint: D1 = (h / h_prev) (x0 - x0_prev)
            r = h / (lam[i] - lam[i - 1])
            x = ratio * x - phi * x0 - 0.5 * phi * r * (x0 - prev_x0)
        prev_x0 = x0
    x = (x * amask)[..., model.action_slots]
    x = torch.cat([x[..., :2] * MAGIC_NUM, x[..., 2:]], dim=-1).reshape(N, K, *x.shape[1:])
    jerk = x[..., 2:, :2] - 2 * x[..., 1:-1, :2] + x[..., :-2, :2]
    scores = (jerk * jerk).sum((-2, -1))
    return x, scores, scores.argmin(dim=1)
