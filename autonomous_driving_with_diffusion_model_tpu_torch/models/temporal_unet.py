"""Temporal trajectory U-Net denoiser (counterpart of the JAX package's
``models/temporal_unet.py``; reference: modeling/temporal.py:58-258).

A 1-D U-Net over the planning horizon conditioned on (timestep embedding ||
image feature), with three guidance variants:

* NO_GUIDANCE          final conv head to ``transition_dim`` channels;
* FREE_GUIDANCE        an extra ``cond_mlp`` on the 2-d target point added
                       into the time embedding (classifier-free guidance);
* CLASSIFIER_GUIDANCE  a 3-channel action head + the ``TrajPredict``
                       transformer predicting the 4-d state from the actions.

Parameters are registered in the reference order (perception, [cond_mlp],
time_mlp, downs, ups, mid_block1, [mid_attn], mid_block2, [act_conv +
state_pred | final_conv]), so ``model.parameters()`` zips against an EMA
``shadow_params`` list. Trajectories are (B, horizon, channels).

``compute_dtype`` bfloat16 is the JAX model's ``dtype`` (JAX
``temporal_unet.py:276-278``): parameters stay float32, the inputs are cast
to bfloat16 where the model takes them (trajectory, time embedding, target
point, image, the state head's actions), each layer casts its weights to
them, and the output is bfloat16 (``models/blocks.py``, ``ops/nn.py``).

Training mode is ``model.train(bn_mode=...)`` (JAX's ``train=``,
``deterministic=False``): dropout acts in ``TrajPredict``, and the encoder's
BatchNorm uses batch statistics under ``bn_mode="train"`` or its running
statistics under ``"frozen"`` (JAX ``TPU.BN_MODE``, whose default is
``frozen``). :func:`build_model` returns an eval model, for serving.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from ..ops.nn import conv1d
from ..utils.constants import MAGIC_NUM, GuidanceType
from ..utils.device import resolve_device, use_float32_math
from .blocks import (
    CondMLP,
    Conv1dBlock,
    Downsample1d,
    PreNormAttention,
    ResidualTemporalMapBlock,
    TimeMLP,
    TrajPredict,
    Upsample1d,
)
from .resnet import PERCEPTION_BUILDERS

__all__ = ["TemporalMapUnet", "build_model", "init_parameters", "BN_MODES"]

BN_MODES = ("train", "frozen")


class TemporalMapUnet(nn.Module):
    magic_num = MAGIC_NUM

    def __init__(
        self,
        horizon: int = 16,
        transition_dim: int = 7,
        attention: bool = False,
        dim: int = 64,
        dim_mults=(1, 2, 4, 8),
        use_cond: GuidanceType = GuidanceType.NO_GUIDANCE,
        perception_name: str = "resnet34",
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if perception_name not in PERCEPTION_BUILDERS:
            raise ValueError(f"MODEL.PERCEPTION={perception_name!r}: expected one of {sorted(PERCEPTION_BUILDERS)}")
        self.use_cond = use_cond
        self.compute_dtype = compute_dtype
        dims = [transition_dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        n_res = len(in_out)
        time_dim = dim
        embed_dim = 2 * dim  # time embedding || image feature

        self.perception = PERCEPTION_BUILDERS[perception_name](num_classes=time_dim)
        if use_cond == GuidanceType.FREE_GUIDANCE:
            self.cond_mlp = CondMLP(time_dim)
        self.time_mlp = TimeMLP(time_dim)

        self.downs = nn.ModuleList()
        self.ups = nn.ModuleList()
        for ind, (dim_in, dim_out) in enumerate(in_out):
            is_last = ind >= n_res - 1
            self.downs.append(
                nn.ModuleList(
                    [
                        ResidualTemporalMapBlock(dim_in, dim_out, embed_dim),
                        ResidualTemporalMapBlock(dim_out, dim_out, embed_dim),
                        PreNormAttention(dim_out) if attention else nn.Identity(),
                        Downsample1d(dim_out) if not is_last else nn.Identity(),
                    ]
                )
            )
        mid_dim = dims[-1]
        for ind, (dim_in, dim_out) in enumerate(reversed(in_out[1:])):
            # every up level upsamples (is_last never holds here, as in the
            # reference); the attention takes dim_in, the width it is fed (the
            # reference builds it with dim_out and crashes with attention on)
            self.ups.append(
                nn.ModuleList(
                    [
                        ResidualTemporalMapBlock(dim_out * 2, dim_in, embed_dim),
                        ResidualTemporalMapBlock(dim_in, dim_in, embed_dim),
                        PreNormAttention(dim_in) if attention else nn.Identity(),
                        Upsample1d(dim_in),
                    ]
                )
            )
            final_up_dim = dim_in
        self.mid_block1 = ResidualTemporalMapBlock(mid_dim, mid_dim, embed_dim)
        if attention:
            self.mid_attn = PreNormAttention(mid_dim)
        self.mid_block2 = ResidualTemporalMapBlock(mid_dim, mid_dim, embed_dim)

        if use_cond == GuidanceType.CLASSIFIER_GUIDANCE:
            if dim != 64:
                # TrajPredict's hidden width 64 is a reference contract
                # (temporal.py:187) and the time embedding is added to it
                raise ValueError(f"the classifier-guidance variant needs MODEL.DIM == 64, got {dim}")
            self.act_conv = nn.Sequential(Conv1dBlock(final_up_dim, final_up_dim), nn.Conv1d(final_up_dim, 3, 1))
            self.state_pred = TrajPredict(in_dim=3, out_dim=transition_dim - 3, hidden_dim=64, num_layers=2)
        else:
            self.final_conv = nn.Sequential(
                Conv1dBlock(final_up_dim, final_up_dim), nn.Conv1d(final_up_dim, transition_dim, 1)
            )

    @property
    def device(self) -> torch.device:
        return self.time_mlp[1].weight.device

    def train(self, mode: bool = True, bn_mode: str = "train") -> "TemporalMapUnet":
        """``nn.Module.train``; in training mode ``bn_mode="frozen"`` keeps the
        encoder's BatchNorms in eval mode (running statistics, never
        updated) while dropout acts."""
        if bn_mode not in BN_MODES:
            raise ValueError(f"TPU.BN_MODE must be 'train' or 'frozen', got {bn_mode!r}")
        super().train(mode)
        if mode and bn_mode == "frozen":
            for m in self.perception.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.eval()
        return self

    def encode_image(self, img: torch.Tensor) -> torch.Tensor:
        """Run the perception encoder once: NHWC image -> (B, dim) feature."""
        return self.perception(img.to(self.compute_dtype))

    def _unet(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        skips = []
        for res1, res2, attn, down in self.downs:
            x = attn(res2(res1(x, cond), cond))
            skips.append(x)
            x = down(x)
        x = self.mid_block1(x, cond)
        if hasattr(self, "mid_attn"):
            x = self.mid_attn(x)
        x = self.mid_block2(x, cond)
        # skips[0] (full horizon) is never popped: a reference quirk kept as is
        for res1, res2, attn, up in self.ups:
            x = torch.cat([x, skips.pop()], dim=-1)
            x = up(attn(res2(res1(x, cond), cond)))
        return x

    @staticmethod
    def _head(seq: nn.Sequential, h: torch.Tensor) -> torch.Tensor:
        block, conv = seq
        return conv1d(block(h), conv.weight, conv.bias)

    def forward(
        self,
        x: torch.Tensor,
        img: Optional[torch.Tensor] = None,
        time: Optional[torch.Tensor] = None,
        cond: Optional[torch.Tensor] = None,
        img_feature: Optional[torch.Tensor] = None,
        return_action_and_time_only: bool = False,
        dropout_generator: Optional[torch.Generator] = None,
    ):
        """Denoise one step.

        x: (B, horizon, transition_dim); img: (B, H, W, 3) normalized NHWC
        image, or ``img_feature`` (B, dim) from :meth:`encode_image`;
        time: (B,); cond: (B', 2) target point for FREE_GUIDANCE, where B' may
        be 2B for the dual-batch CFG (time and image features are then tiled,
        as in reference temporal.py:206-212); ``dropout_generator``: the
        state head's dropout masks, in training mode.
        """
        if img_feature is None:
            img_feature = self.encode_image(img)
        cdt = self.compute_dtype
        time_embed = self.time_mlp(time, cdt)
        if self.use_cond == GuidanceType.FREE_GUIDANCE:
            if cond is None:
                cond = torch.zeros((x.shape[0], 2), dtype=cdt, device=x.device)
            if time_embed.shape[0] != cond.shape[0]:
                time_embed = time_embed.repeat(cond.shape[0] // time_embed.shape[0], 1)
            if img_feature.shape[0] != cond.shape[0]:
                img_feature = img_feature.repeat(cond.shape[0] // img_feature.shape[0], 1)
            time_embed = time_embed + self.cond_mlp(cond.to(cdt))

        cond_input = torch.cat([time_embed, img_feature.to(time_embed.dtype)], dim=-1)
        h = self._unet(x.to(cdt), cond_input)

        if self.use_cond == GuidanceType.CLASSIFIER_GUIDANCE:
            action = self._head(self.act_conv, h)  # (B, horizon, 3)
            if return_action_and_time_only:
                return action, time_embed
            state = self.predict_state(action.detach(), time_embed, dropout_generator)
            return torch.cat([state, action], dim=-1)
        return self._head(self.final_conv, h)

    def predict_state(self, action: torch.Tensor, time_embed: torch.Tensor,
                      dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Classifier-guidance state head on its own (reference:
        interact.py:158-159): the first waypoint's state is zero."""
        state = self.state_pred(action[:, :-1].to(self.compute_dtype), time_embed, dropout_generator)
        return torch.cat([torch.zeros_like(state[:, :1]), state], dim=1)


# ------------------------------------------------------------------ init


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter from ``generator`` with PyTorch's default
    initialisers (torchvision's kaiming-normal for the ResNet convs), and
    reset BatchNorm running statistics. Parameters are drawn on the CPU in
    ``named_parameters`` order, so a seed gives the same weights everywhere."""

    def fill(p: torch.Tensor, draw) -> None:
        p.copy_(draw(torch.empty(p.shape, dtype=torch.float32)).to(p.dtype))

    uniform = lambda b: (lambda t: t.uniform_(-b, b, generator=generator))
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            std = math.sqrt(2.0 / (mod.out_channels * mod.kernel_size[0] * mod.kernel_size[1]))
            fill(mod.weight, lambda t: t.normal_(0.0, std, generator=generator))
        elif isinstance(mod, (nn.Conv1d, nn.ConvTranspose1d, nn.Linear)):
            bound = 1.0 / math.sqrt(mod.weight[0].numel())  # torch's fan_in
            fill(mod.weight, uniform(bound))
            if mod.bias is not None:
                fill(mod.bias, uniform(bound))
        elif isinstance(mod, (nn.BatchNorm2d, nn.GroupNorm, nn.LayerNorm)):
            mod.weight.fill_(1.0)
            mod.bias.fill_(0.0)
            if isinstance(mod, nn.BatchNorm2d):
                mod.reset_running_stats()
        elif hasattr(mod, "in_proj_weight"):
            bound = math.sqrt(6.0 / sum(mod.in_proj_weight.shape))  # xavier-uniform
            fill(mod.in_proj_weight, uniform(bound))
            mod.in_proj_bias.fill_(0.0)
    return model


def build_model(cfg, device=None, seed: int = 0) -> TemporalMapUnet:
    """Construct the denoiser from a config (reference: modeling/temporal.py:248-258),
    weights drawn from ``seed``, in eval mode on ``device`` (None: the card).
    On the card it turns TF32 off (``utils.device.use_float32_math``), so a
    float32 model serves and trains in float32."""
    dev = resolve_device(device)
    use_float32_math(dev)
    if cfg.MODEL.DIFFUSER_BUILDING_BLOCK != "concat":
        raise NotImplementedError(cfg.MODEL.DIFFUSER_BUILDING_BLOCK)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if cfg.TPU.COMPUTE_DTYPE not in dtypes:
        raise ValueError(f"TPU.COMPUTE_DTYPE={cfg.TPU.COMPUTE_DTYPE!r}: expected float32 | bfloat16")
    model = TemporalMapUnet(
        horizon=cfg.MODEL.HORIZON,
        transition_dim=cfg.MODEL.TRANSITION_DIM,
        attention=cfg.MODEL.USE_ATTN,
        dim=cfg.MODEL.DIM,
        dim_mults=tuple(cfg.MODEL.DIM_MULTS),
        use_cond=GuidanceType[cfg.TRAIN.USE_COND],
        perception_name=cfg.MODEL.get("PERCEPTION", "resnet34"),
        compute_dtype=dtypes[cfg.TPU.COMPUTE_DTYPE],
    )
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
