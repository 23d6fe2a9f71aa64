"""Diffusion Policy's CNN planner in plain PyTorch: the image encoder, the
conditional 1-D U-Net and a DDPM plan over an observation history, float32,
channels-first, written from the published description (Chi et al.,
"Diffusion Policy", RSS 2023; github.com/real-stanford/diffusion_policy,
``image_pusht_diffusion_policy_cnn.yaml``,
``model/diffusion/conditional_unet1d.py``,
``policy/diffusion_unet_hybrid_image_policy.py`` and robomimic's
``VisualCore``, ``ResNet18Conv`` and ``SpatialSoftmax``). It imports
nothing but torch, numpy and the standard library; TF32 is the caller's to
turn off (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``).

* Encoder: torchvision's ResNet-18 without its pooling and head, every
  BatchNorm a ``GroupNorm(C / 16, C)``; a 1x1 convolution to 32 keypoint
  maps, a softmax over each map's positions (temperature 1), each map's
  expected (x, y) on a ``linspace(-1, 1)`` grid, flattened (x0, y0, x1, ...),
  then ``Linear(64, 64)``. An observation is ``[feature | target point]``.
* U-Net: ``down_dims`` = DIM x DIM_MULTS, kernel 5, GroupNorm 8; a block is
  ``Conv1dBlock(ci, co)``, FiLM from ``Linear(cond_dim, 2 co)`` of
  ``mish(cond)`` (scale first, then shift), ``Conv1dBlock(co, co)`` and the
  residual (a 1x1 convolution where ``ci != co``); ``cond = [step embedding
  (Linear(512, 128) . Mish . Linear(128, 512) of a 128-wide sinusoidal
  embedding) | the observations, oldest first]``.
* Sampler: diffusers' ``DDPMScheduler`` with 100 training steps,
  ``squaredcos_cap_v2``, epsilon prediction, x0 clipped to [-1, 1],
  ``fixed_small`` variance, noise added where t > 0.

Departures from the published description, each this system's:

* the frame is the system's 900x256 camera frame, uncropped (Diffusion
  Policy's PushT evaluates an 84x84 crop), scaled uint8 / 255;
* the action is the system's 7-wide transition (PushT's is 2-d), the
  low-dimensional observation the 2-d target point (PushT's ``agent_pos``);
* the planner's conventions: the first waypoint's (x, y, yaw) is zeroed
  before the first step and after every step, the result is clamped to
  [-1, 1] and its xy scaled to meters (23.315 m a unit); K hypotheses a
  plan, scored by the squared jerk of their xy path (Diffusion Policy draws
  one);
* parameter names: a ``Conv1dBlock``'s GroupNorm sits at ``block.2`` and
  the encoder is ``perception`` (the program's names), with
  ``cond_encoder.1`` the FiLM projection;
* weights are random, made by the caller.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["MAGIC_NUM", "KeypointResNet18", "ConditionalUnet1D", "build_reference", "alphas_cumprod",
           "plan_batch"]

MAGIC_NUM = 23.315  # meters per normalized trajectory unit
ANCHOR_DIMS = 3
TARGET_DIM = 2

# ------------------------------------------------------------------ encoder


class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.GroupNorm(planes // 16, planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.GroupNorm(planes // 16, planes)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(nn.Conv2d(cin, planes, 1, stride, bias=False),
                                            nn.GroupNorm(planes // 16, planes))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class KeypointResNet18(nn.Module):
    """robomimic's ``VisualCore``: the GroupNorm ResNet-18 trunk, the spatial
    softmax, the linear layer. Takes (B, 3, H, W) in [0, 1]."""

    def __init__(self, feature_dim: int = 64, num_keypoints: int = 32):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.GroupNorm(4, 64)
        cin = 64
        for stage, planes in enumerate((64, 128, 256, 512)):
            setattr(self, f"layer{stage + 1}", nn.Sequential(
                BasicBlock(cin, planes, 2 if stage > 0 else 1), BasicBlock(planes, planes, 1)))
            cin = planes
        self.keypoints = nn.Conv2d(512, num_keypoints, 1)
        self.fc = nn.Linear(2 * num_keypoints, feature_dim)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        maps = self.keypoints(self.layer4(self.layer3(self.layer2(self.layer1(x)))))
        B, K, H, W = maps.shape
        attn = F.softmax(maps.reshape(B * K, H * W), dim=-1)
        pos_x, pos_y = np.meshgrid(np.linspace(-1.0, 1.0, W), np.linspace(-1.0, 1.0, H))
        pos_x = torch.from_numpy(pos_x.reshape(1, H * W)).float().to(x.device)
        pos_y = torch.from_numpy(pos_y.reshape(1, H * W)).float().to(x.device)
        xy = torch.cat([(pos_x * attn).sum(1, keepdim=True), (pos_y * attn).sum(1, keepdim=True)], dim=1)
        return self.fc(xy.reshape(B, 2 * K))


# ------------------------------------------------------------------ U-Net


class Conv1dBlock(nn.Module):
    def __init__(self, cin: int, cout: int, kernel_size: int = 5, n_groups: int = 8):
        super().__init__()
        self.block = nn.Sequential(nn.Conv1d(cin, cout, kernel_size, padding=kernel_size // 2), nn.Identity(),
                                   nn.GroupNorm(n_groups, cout), nn.Mish())

    def forward(self, x):
        return self.block(x)


class ConditionalResidualBlock1D(nn.Module):
    def __init__(self, cin: int, cout: int, cond_dim: int, kernel_size: int = 5):
        super().__init__()
        self.out_channels = cout
        self.blocks = nn.ModuleList([Conv1dBlock(cin, cout, kernel_size), Conv1dBlock(cout, cout, kernel_size)])
        self.cond_encoder = nn.Sequential(nn.Mish(), nn.Linear(cond_dim, 2 * cout))
        self.residual_conv = nn.Conv1d(cin, cout, 1) if cin != cout else nn.Identity()

    def forward(self, x, cond):
        out = self.blocks[0](x)
        embed = self.cond_encoder(cond).reshape(cond.shape[0], 2, self.out_channels, 1)
        out = embed[:, 0] * out + embed[:, 1]
        out = self.blocks[1](out)
        return out + self.residual_conv(x)


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        half = self.dim // 2
        scale = math.log(10000) / (half - 1)
        freqs = torch.exp(torch.arange(half, device=x.device, dtype=torch.float32) * -scale)
        args = x.float()[:, None] * freqs[None, :]
        return torch.cat((args.sin(), args.cos()), dim=-1)


class Downsample1d(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv1d(dim, dim, 3, 2, 1)

    def forward(self, x):
        return self.conv(x)


class Upsample1d(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.ConvTranspose1d(dim, dim, 4, 2, 1)

    def forward(self, x):
        return self.conv(x)


class ConditionalUnet1D(nn.Module):
    """The denoiser over (B, transition, horizon) trajectories with the
    image encoder ``perception``; ``forward`` takes the observations'
    features, ``encode`` makes them."""

    def __init__(self, transition_dim: int, dim: int, dim_mults, step_embed_dim: int, n_obs_steps: int,
                 feature_dim: int, num_keypoints: int):
        super().__init__()
        self.perception = KeypointResNet18(feature_dim, num_keypoints)
        dims = [transition_dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        cond_dim = step_embed_dim + n_obs_steps * (feature_dim + TARGET_DIM)
        self.diffusion_step_encoder = nn.Sequential(
            SinusoidalPosEmb(step_embed_dim), nn.Linear(step_embed_dim, 4 * step_embed_dim), nn.Mish(),
            nn.Linear(4 * step_embed_dim, step_embed_dim))
        self.down_modules = nn.ModuleList()
        for i, (d_in, d_out) in enumerate(in_out):
            last = i == len(in_out) - 1
            self.down_modules.append(nn.ModuleList([
                ConditionalResidualBlock1D(d_in, d_out, cond_dim), ConditionalResidualBlock1D(d_out, d_out, cond_dim),
                Downsample1d(d_out) if not last else nn.Identity()]))
        mid = dims[-1]
        self.mid_modules = nn.ModuleList([ConditionalResidualBlock1D(mid, mid, cond_dim),
                                          ConditionalResidualBlock1D(mid, mid, cond_dim)])
        self.up_modules = nn.ModuleList()
        for d_in, d_out in reversed(in_out[1:]):
            self.up_modules.append(nn.ModuleList([
                ConditionalResidualBlock1D(2 * d_out, d_in, cond_dim), ConditionalResidualBlock1D(d_in, d_in, cond_dim),
                Upsample1d(d_in)]))
        self.final_conv = nn.Sequential(Conv1dBlock(dims[1], dims[1]), nn.Conv1d(dims[1], transition_dim, 1))

    def encode(self, frames_u8, targets):
        """(N, n_obs, H, W, 3) uint8 frames and (N, n_obs, 2) targets ->
        (N, n_obs x (feature + 2)) observation features, oldest first."""
        N, n_obs = frames_u8.shape[:2]
        images = frames_u8.reshape(N * n_obs, *frames_u8.shape[2:]).permute(0, 3, 1, 2).float() / 255.0
        feats = self.perception(images)
        return torch.cat([feats, targets.reshape(N * n_obs, -1).float()], dim=-1).reshape(N, -1)

    def forward(self, x, time, obs):
        """x (B, horizon, transition); time (B,); obs (B, n_obs x (feature + 2))."""
        cond = torch.cat([self.diffusion_step_encoder(time), obs], dim=-1)
        x = x.transpose(1, 2)
        h = []
        for res1, res2, down in self.down_modules:
            x = res2(res1(x, cond), cond)
            h.append(x)
            x = down(x)
        for mid in self.mid_modules:
            x = mid(x, cond)
        for res1, res2, up in self.up_modules:
            x = torch.cat((x, h.pop()), dim=1)
            x = up(res2(res1(x, cond), cond))
        return self.final_conv(x).transpose(1, 2)


def build_reference(model_cfg: dict, device=None) -> ConditionalUnet1D:
    """The network of a configuration's ``MODEL`` group, in eval mode,
    parameters uninitialized: load a state dict into it."""
    if model_cfg.get("ARCH") != "conditional_unet1d" or model_cfg.get("PERCEPTION") != "resnet18_gn_keypoints":
        raise ValueError("the reference covers MODEL.ARCH conditional_unet1d with resnet18_gn_keypoints")
    with torch.device(device or "cpu"):
        model = ConditionalUnet1D(model_cfg["TRANSITION_DIM"], model_cfg["DIM"], tuple(model_cfg["DIM_MULTS"]),
                                  model_cfg["STEP_EMBED_DIM"], model_cfg["N_OBS_STEPS"], model_cfg["OBS_FEATURE_DIM"],
                                  model_cfg["NUM_KEYPOINTS"])
    return model.eval()


# ------------------------------------------------------------------ plan


def alphas_cumprod(num_train_timesteps: int, device) -> torch.Tensor:
    """diffusers' ``squaredcos_cap_v2`` cumulative alphas, computed in
    float64, stored float32."""
    bar = lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
    n = num_train_timesteps
    betas = np.array([min(1 - bar((i + 1) / n) / bar(i / n), 0.999) for i in range(n)])
    return torch.tensor(np.cumprod(1.0 - betas), dtype=torch.float32, device=device)


def _anchor(x):
    x = x.clone()
    x[:, 0, :ANCHOR_DIMS] = 0.0
    return x


@torch.no_grad()
def plan_batch(model, cfg: dict, frames_u8, targets, init, noise):
    """Plans of N requests, each over its own history and draws:
    ``frames_u8`` (N, n_obs, H, W, 3), ``targets`` (N, n_obs, 2), oldest
    first; ``init`` (N, K, horizon, transition) the starting noise and
    ``noise`` (N, steps, K, horizon, transition) each step's. Returns ((N, K,
    horizon, transition) trajectories with xy in meters, (N, K) scores, (N,)
    best index)."""
    if (cfg["EVAL"]["SCHEDULER"] != "ddpm" or cfg["TRAIN"]["NOISE_SCHEDULER"]["PRED_TYPE"] != "epsilon"
            or cfg["TRAIN"]["NOISE_SCHEDULER"]["TYPE"] != "squaredcos_cap_v2" or cfg["EVAL"]["THRESHOLDING"]):
        raise ValueError("the reference plans with DDPM, epsilon prediction, squaredcos_cap_v2 and clipping")
    N, K = init.shape[:2]
    T, steps = int(cfg["TRAIN"]["SAMPLE_STEPS"]), int(cfg["EVAL"]["SAMPLE_STEPS"])
    ac = alphas_cumprod(T, init.device)
    ratio = T // steps
    ts = [i * ratio for i in range(steps)][::-1]
    obs = model.encode(frames_u8, targets).repeat_interleave(K, 0)  # (N K, obs)
    x = _anchor(init.float().reshape(N * K, *init.shape[2:]))
    for i, t in enumerate(ts):
        eps = model(x, torch.full((N * K,), float(t), device=x.device), obs)
        a_t = ac[t]
        a_prev = ac[t - ratio] if t - ratio >= 0 else torch.ones((), device=x.device)
        beta_t, beta_prev = 1 - a_t, 1 - a_prev
        cur_alpha = a_t / a_prev
        x0 = ((x - beta_t.sqrt() * eps) / a_t.sqrt()).clamp(-1.0, 1.0)
        x = (a_prev.sqrt() * (1 - cur_alpha) / beta_t) * x0 + (cur_alpha.sqrt() * beta_prev / beta_t) * x
        if t > 0:
            var = (beta_prev / beta_t * (1 - cur_alpha)).clamp_min(1e-20)
            x = x + var.sqrt() * noise[:, i].float().reshape(N * K, *x.shape[1:])
        x = _anchor(x)
    x = x.clamp(-1.0, 1.0)
    x = torch.cat([x[..., :2] * MAGIC_NUM, x[..., 2:]], dim=-1).reshape(N, K, *x.shape[1:])
    jerk = x[..., 2:, :2] - 2 * x[..., 1:-1, :2] + x[..., :-2, :2]
    scores = (jerk * jerk).sum((-2, -1))
    return x, scores, scores.argmin(dim=1)
