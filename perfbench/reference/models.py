"""The planner's networks in plain PyTorch: ResNet-34 and the temporal
U-Net, float32, channels-first, as the reference repository writes them
(modeling/resnet.py, modeling/temporal.py, modeling/helpers.py of
Justin900429/autonomous_driving_with_diffusion_model).

Module and parameter names are the reference's ``state_dict`` names, so
one state dict loads into this model and into the program under test.
Parameter-free slots (``Rearrange``, ``Mish``) keep their indices.

Written from the published description, with no kernel, cache or batching
of the program. Departures from the reference: no attention (``USE_ATTN``
is off in every configuration the benchmark runs) and no classifier-guidance
head; ``forward`` takes the image feature, which the planner computes once
per plan (the reference computes the same feature in every step).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["ResNet34", "TemporalUnet", "build_reference"]


# ------------------------------------------------------------------ ResNet-34


class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(nn.Conv2d(cin, planes, 1, stride, bias=False), nn.BatchNorm2d(planes))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet34(nn.Module):
    """torchvision's resnet34 with its head re-pointed to ``num_classes``
    (modeling/temporal.py:83-84). Takes (B, 3, H, W)."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512), (3, 4, 6, 3))):
            layers = []
            for i in range(blocks):
                layers.append(BasicBlock(cin, planes, 2 if stage > 0 and i == 0 else 1))
                cin = planes
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layers))
        self.fc = nn.Linear(512, num_classes)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.fc(torch.flatten(F.adaptive_avg_pool2d(x, 1), 1))


# ------------------------------------------------------------------ U-Net


class Rearrange(nn.Module):
    """einops ``Rearrange`` between (B, C, L) and (B, C, 1, L), or a
    trailing axis for the time bias: parameter-free."""

    def __init__(self, kind: str):
        super().__init__()
        self.kind = kind

    def forward(self, x):
        if self.kind == "add_h":
            return x[:, :, None, :]
        if self.kind == "drop_h":
            return x[:, :, 0, :]
        return x[:, :, None]  # "batch t -> batch t 1"


class Conv1dBlock(nn.Module):
    """Conv1d -> GroupNorm(8) -> Mish (helpers.py:95-112)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 5, n_groups: int = 8):
        super().__init__()
        self.block = nn.Sequential(
            nn.Conv1d(cin, cout, kernel_size, padding=kernel_size // 2),
            Rearrange("add_h"),
            nn.GroupNorm(n_groups, cout),
            Rearrange("drop_h"),
            nn.Mish(),
        )

    def forward(self, x):
        return self.block(x)


class ResidualTemporalMapBlock(nn.Module):
    """Two Conv1dBlocks, the conditioning's bias between them, a residual
    path (temporal.py:23-55)."""

    def __init__(self, cin: int, cout: int, embed_dim: int):
        super().__init__()
        self.blocks = nn.ModuleList([Conv1dBlock(cin, cout), Conv1dBlock(cout, cout)])
        self.time_mlp = nn.Sequential(nn.Mish(), nn.Linear(embed_dim, cout), Rearrange("t"))
        self.residual_conv = nn.Conv1d(cin, cout, 1) if cin != cout else nn.Identity()

    def forward(self, x, t):
        out = self.blocks[0](x) + self.time_mlp(t)
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


class TemporalUnet(nn.Module):
    """The denoiser (temporal.py:58-258) over (B, horizon, transition)
    trajectories, conditioned on time embedding || image feature, with the
    target MLP of classifier-free guidance where ``free_guidance``."""

    def __init__(self, horizon: int, transition_dim: int, dim: int, dim_mults, free_guidance: bool):
        super().__init__()
        dims = [transition_dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        embed_dim = 2 * dim
        self.free_guidance = free_guidance
        self.perception = ResNet34(num_classes=dim)
        if free_guidance:
            self.cond_mlp = nn.Sequential(nn.Linear(2, dim), nn.Mish(), nn.Linear(dim, dim))
        self.time_mlp = nn.Sequential(SinusoidalPosEmb(dim), nn.Linear(dim, dim * 4), nn.Mish(),
                                      nn.Linear(dim * 4, dim))
        self.downs = nn.ModuleList()
        for i, (d_in, d_out) in enumerate(in_out):
            last = i == len(in_out) - 1
            self.downs.append(nn.ModuleList([
                ResidualTemporalMapBlock(d_in, d_out, embed_dim),
                ResidualTemporalMapBlock(d_out, d_out, embed_dim),
                nn.Identity(),
                Downsample1d(d_out) if not last else nn.Identity(),
            ]))
        mid = dims[-1]
        self.mid_block1 = ResidualTemporalMapBlock(mid, mid, embed_dim)
        self.mid_block2 = ResidualTemporalMapBlock(mid, mid, embed_dim)
        self.ups = nn.ModuleList()
        for d_in, d_out in reversed(in_out[1:]):
            self.ups.append(nn.ModuleList([
                ResidualTemporalMapBlock(d_out * 2, d_in, embed_dim),
                ResidualTemporalMapBlock(d_in, d_in, embed_dim),
                nn.Identity(),
                Upsample1d(d_in),
            ]))
        self.final_conv = nn.Sequential(Conv1dBlock(dim, dim), nn.Conv1d(dim, transition_dim, 1))

    def encode(self, image_nhwc):
        """Normalized (B, H, W, 3) images -> (B, dim) features."""
        return self.perception(image_nhwc.permute(0, 3, 1, 2))

    def forward(self, x, time, feature, cond=None):
        """x (B, horizon, transition); time (B,); feature (B, dim); cond
        (B, 2) target points under classifier-free guidance."""
        t = self.time_mlp(time)
        if self.free_guidance:
            if cond is None:
                cond = torch.zeros(x.shape[0], 2, device=x.device)
            t = t + self.cond_mlp(cond)
        t = torch.cat([t, feature], dim=-1)
        x = x.transpose(1, 2)
        skips = []
        for res1, res2, _, down in self.downs:
            x = res2(res1(x, t), t)
            skips.append(x)
            x = down(x)
        x = self.mid_block2(self.mid_block1(x, t), t)
        for res1, res2, _, up in self.ups:
            x = torch.cat((x, skips.pop()), dim=1)
            x = up(res2(res1(x, t), t))
        return self.final_conv(x).transpose(1, 2)


def build_reference(model_cfg: dict, free_guidance: bool, device=None) -> TemporalUnet:
    """The reference network of a configuration's ``MODEL`` group, in eval
    mode (BatchNorm on its running statistics, as ``BN_MODE`` frozen
    trains), parameters uninitialized: load a state dict into it."""
    if model_cfg.get("USE_ATTN") or model_cfg.get("PERCEPTION", "resnet34") != "resnet34":
        raise ValueError("the reference covers ResNet-34 perception without attention")
    with torch.device(device or "cpu"):
        model = TemporalUnet(model_cfg["HORIZON"], model_cfg["TRANSITION_DIM"], model_cfg["DIM"],
                             tuple(model_cfg["DIM_MULTS"]), free_guidance)
    return model.eval()
