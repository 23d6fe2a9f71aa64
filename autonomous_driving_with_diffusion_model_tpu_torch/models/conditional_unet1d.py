"""Diffusion Policy's CNN denoiser (Chi et al., RSS 2023;
github.com/real-stanford/diffusion_policy,
``diffusion_policy/model/diffusion/conditional_unet1d.py``), on the port's
blocks and kernels: ``MODEL.ARCH`` ``conditional_unet1d``.

The U-Net denoises a (B, horizon, transition_dim) trajectory conditioned on
``cond = [step embedding | observation features]``, the features being the
last ``N_OBS_STEPS`` observations in time order, each ``[image feature |
target point]`` (:meth:`ConditionalUnet1D.encode_obs`). It keeps the port's
topology at ``dims = [transition_dim, DIM x DIM_MULTS...]``: two
:class:`ConditionalResidualBlock1D` a level, ``Downsample1d`` after every
level but the last, two mid blocks, up levels over the reversed
``in_out[1:]``, each ending in ``Upsample1d``, then ``Conv1dBlock`` and a
1x1 convolution. Each residual block is one ``fused_residual_block`` call
with the FiLM epilogue; the head is one ``fused_conv1d_gn_mish`` call.

Parameter names follow Diffusion Policy's (``diffusion_step_encoder``,
``down_modules``, ``mid_modules``, ``up_modules``, ``final_conv``; a block's
``blocks``, ``cond_encoder``, ``residual_conv``), except that a
``Conv1dBlock``'s GroupNorm sits at ``block.2`` (the port's
``Conv1dBlock``, whose slot 1 holds the reference's ``Rearrange``) and the
image encoder is ``perception`` (``models/resnet.py:KeypointResNet``).

The model serves only: the train and distill CLIs refuse it, and it takes no
guidance. Its forward takes the observation features, which the planner
computes once a plan (``driving/plan.py``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.nn import conv1d
from .blocks import Conv1dBlock, Downsample1d, ResidualTemporalMapBlock, TimeMLP, Upsample1d
from .resnet import PERCEPTION_BUILDERS

__all__ = ["ConditionalResidualBlock1D", "ConditionalUnet1D", "TARGET_DIM"]

TARGET_DIM = 2  # the target point, an observation's low-dimensional part


class ConditionalResidualBlock1D(ResidualTemporalMapBlock):
    """``Conv1dBlock(cin, cout)``, FiLM from ``Linear(cond_dim, 2 cout)`` of
    ``mish(cond)`` (scale the first ``cout`` outputs, shift the last), then
    ``Conv1dBlock(cout, cout)`` plus the residual (a 1x1 convolution where
    ``cin != cout``): one ``fused_residual_block`` call, FiLM because its
    projection has 2 ``cout`` outputs."""

    def __init__(self, cin: int, cout: int, cond_dim: int):
        nn.Module.__init__(self)
        self.blocks = nn.ModuleList([Conv1dBlock(cin, cout), Conv1dBlock(cout, cout)])
        self.cond_encoder = nn.Sequential(nn.Mish(), nn.Linear(cond_dim, 2 * cout))
        self.residual_conv = nn.Conv1d(cin, cout, 1) if cin != cout else nn.Identity()

    def _cond_linear(self) -> nn.Linear:
        return self.cond_encoder[1]


class ConditionalUnet1D(nn.Module):
    """Diffusion Policy's ``ConditionalUnet1D`` with ``obs_as_global_cond``
    and ``cond_predict_scale``, and its image encoder."""

    def __init__(
        self,
        transition_dim: int = 7,
        dim: int = 512,
        dim_mults=(1, 2, 4),
        step_embed_dim: int = 128,
        n_obs_steps: int = 2,
        feature_dim: int = 64,
        num_keypoints: int = 32,
        perception_name: str = "resnet18_gn_keypoints",
    ):
        super().__init__()
        if perception_name != "resnet18_gn_keypoints":
            raise ValueError(f"MODEL.ARCH conditional_unet1d encodes with resnet18_gn_keypoints, "
                             f"not {perception_name!r}")
        self.n_obs_steps = n_obs_steps  # the observations a plan conditions on
        self.perception = PERCEPTION_BUILDERS[perception_name](feature_dim, num_keypoints)
        dims = [transition_dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        cond_dim = step_embed_dim + n_obs_steps * (feature_dim + TARGET_DIM)
        block = lambda cin, cout: ConditionalResidualBlock1D(cin, cout, cond_dim)

        self.diffusion_step_encoder = TimeMLP(step_embed_dim)
        self.down_modules = nn.ModuleList()
        for ind, (dim_in, dim_out) in enumerate(in_out):
            is_last = ind >= len(in_out) - 1
            self.down_modules.append(nn.ModuleList([
                block(dim_in, dim_out), block(dim_out, dim_out),
                Downsample1d(dim_out) if not is_last else nn.Identity(),
            ]))
        mid = dims[-1]
        self.mid_modules = nn.ModuleList([block(mid, mid), block(mid, mid)])
        self.up_modules = nn.ModuleList()
        for dim_in, dim_out in reversed(in_out[1:]):
            self.up_modules.append(nn.ModuleList([
                block(dim_out * 2, dim_in), block(dim_in, dim_in), Upsample1d(dim_in),
            ]))
        start = dims[1]
        self.final_conv = nn.Sequential(Conv1dBlock(start, start), nn.Conv1d(start, transition_dim, 1))

    def encode_obs(self, images: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """The global conditioning of one plan: ``images`` (N_OBS_STEPS, H,
        W, 3) in [0, 1] and ``targets`` (N_OBS_STEPS, 2), oldest first ->
        (1, N_OBS_STEPS x (feature_dim + 2)), ``[feature_0 | target_0 |
        feature_1 | target_1 | ...]``."""
        feats = self.perception(images)
        return torch.cat([feats, targets.to(feats.dtype)], dim=-1).reshape(1, -1)

    def forward(self, x: torch.Tensor, time: torch.Tensor, img_feature: torch.Tensor) -> torch.Tensor:
        """Denoise one step: x (B, horizon, transition_dim); time (B,);
        ``img_feature`` (B, N_OBS_STEPS x (feature_dim + 2)), the observation
        features from :meth:`encode_obs` (the sampler's name for them)."""
        t = self.diffusion_step_encoder(time)
        g = torch.cat([t, img_feature.to(t.dtype)], dim=-1)
        h = []
        for res1, res2, down in self.down_modules:
            x = res2(res1(x, g), g)
            h.append(x)
            x = down(x)
        for mid in self.mid_modules:
            x = mid(x, g)
        for res1, res2, up in self.up_modules:
            x = torch.cat([x, h.pop()], dim=-1)
            x = up(res2(res1(x, g), g))
        block, conv = self.final_conv
        return conv1d(block(x), conv.weight, conv.bias)
