"""Perception encoders (counterpart of the JAX package's ``models/resnet.py``).

The torchvision ResNet family the reference vendors (reference:
modeling/resnet.py:56-333) with the classifier head re-pointed to the
conditioning width (modeling/temporal.py:83-84): ``BasicBlock`` for
resnet18/34, ``Bottleneck`` (with ``groups``/``base_width``) for resnet50/101/152,
resnext50_32x4d and wide_resnet50_2, under torchvision's ``state_dict`` names
(``layerN.i.conv3``, ``downsample.0/1``). The encoders take NHWC images, like
the JAX package, and run channels-first inside.

``resnet18_gn_keypoints`` (:class:`KeypointResNet`) is Diffusion Policy's
image encoder (robomimic's ``VisualCore``): ResNet-18 with every BatchNorm a
``GroupNorm(C / 16, C)``, no pooling and no head, then a spatial softmax
over ``num_keypoints`` keypoints and a linear layer to the feature.

BatchNorm is JAX ``resnet.py:59-96``'s: in eval mode it normalizes with the
running statistics; a BatchNorm module in training mode normalizes with the
batch mean and biased variance in float32 and moves ``running_mean`` and
``running_var`` (the unbiased variance, ``n / (n - 1)``) by momentum 0.1, as
torch does. Under data parallelism (a process group of more than one rank)
the batch is the global one, as in the JAX program: the mean and then the
variance are summed over the ranks by a differentiable all-reduce.
``TemporalMapUnet.train(bn_mode="frozen")`` keeps the encoder's BatchNorms
in eval mode while the rest trains (JAX ``TPU.BN_MODE``).

Each convolution and the head compute in the input's dtype, their weights
cast to it; BatchNorm runs in float32 and casts back (JAX ``resnet.py:56,
80-96``), so a bfloat16 image gives a bfloat16 encode with float32
parameters.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn
import torch.nn as nn
import torch.nn.functional as F

from ..ops.nn import dense

__all__ = [
    "BasicBlock",
    "Bottleneck",
    "ResNet",
    "resnet18",
    "resnet34",
    "resnet50",
    "resnet101",
    "resnet152",
    "resnext50_32x4d",
    "wide_resnet50_2",
    "TinyEncoder",
    "KeypointResNet",
    "PERCEPTION_BUILDERS",
]


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride, conv.padding, 1, conv.groups)


def _global_bn(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """Training-mode BatchNorm over the batch of every rank (equal local
    batches): two differentiable all-reduces, the sum for the mean, then
    the squared deviations for the biased variance."""
    count = x.numel() // x.shape[1] * dist.get_world_size()
    mean = dist_nn.all_reduce(x.sum(dim=(0, 2, 3))) / count
    centered = x - mean.reshape(1, -1, 1, 1)
    var = dist_nn.all_reduce(centered.square().sum(dim=(0, 2, 3))) / count
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
        bn.running_var.mul_(1 - m).add_(var.detach() * (count / (count - 1)), alpha=m)
    scale = torch.rsqrt(var + bn.eps) * bn.weight
    return centered * scale.reshape(1, -1, 1, 1) + bn.bias.reshape(1, -1, 1, 1)


def _bn(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    if bn.training:
        bn.num_batches_tracked.add_(1)
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            return _global_bn(bn, x.to(torch.float32)).to(x.dtype)
    out = F.batch_norm(x.to(torch.float32), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                       bn.training, bn.momentum, bn.eps)
    return out.to(x.dtype)


def _norm(norm: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A BatchNorm (:func:`_bn`) or a GroupNorm, in float32, cast back."""
    if isinstance(norm, nn.GroupNorm):
        return F.group_norm(x.to(torch.float32), norm.num_groups, norm.weight, norm.bias, norm.eps).to(x.dtype)
    return _bn(norm, x)


def _downsample(cin: int, cout: int, stride: int):
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(nn.Conv2d(cin, cout, 1, stride, 0, bias=False), nn.BatchNorm2d(cout))


def _residual(block, out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    identity = x
    if block.downsample is not None:
        identity = _norm(block.downsample[1], _conv(block.downsample[0], x))
    return F.relu(out + identity)


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (reference: modeling/resnet.py:56-110)."""

    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1, groups: int = 1, base_width: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = _downsample(cin, planes, stride)

    def forward(self, x):
        out = F.relu(_norm(self.bn1, _conv(self.conv1, x)))
        return _residual(self, _norm(self.bn2, _conv(self.conv2, out)), x)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, groups) -> 1x1 bottleneck block (reference:
    modeling/resnet.py:113-160; JAX ``resnet.py:136-165``)."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1, groups: int = 1, base_width: int = 64):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out_ch = planes * self.expansion
        self.conv1 = nn.Conv2d(cin, width, 1, 1, 0, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, groups=groups, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, out_ch, 1, 1, 0, bias=False)
        self.bn3 = nn.BatchNorm2d(out_ch)
        self.downsample = _downsample(cin, out_ch, stride)

    def forward(self, x):
        out = F.relu(_bn(self.bn1, _conv(self.conv1, x)))
        out = F.relu(_bn(self.bn2, _conv(self.conv2, out)))
        return _residual(self, _bn(self.bn3, _conv(self.conv3, out)), x)


class ResNet(nn.Module):
    """torchvision-compatible ResNet trunk + linear head. x: (B, H, W, 3)."""

    def __init__(self, block, layers: Sequence[int], num_classes: int = 1000, groups: int = 1,
                 width_per_group: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if stage == 0 else 2
            mods = []
            for i in range(blocks):
                mods.append(block(cin, planes, stride if i == 0 else 1, groups, width_per_group))
                cin = planes * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*mods))
        self.fc = nn.Linear(512 * block.expansion, num_classes)

    def trunk(self, x):
        """(B, H, W, 3) -> the last stage's (B, C, H / 32, W / 32) map."""
        x = x.permute(0, 3, 1, 2)
        x = F.relu(_norm(self.bn1, _conv(self.conv1, x)))
        x = F.max_pool2d(x, 3, 2, 1)
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))

    def forward(self, x):
        return dense(self.trunk(x).mean(dim=(2, 3)), self.fc.weight, self.fc.bias)


def resnet18(num_classes: int = 1000) -> ResNet:
    return ResNet(BasicBlock, [2, 2, 2, 2], num_classes)


def resnet34(num_classes: int = 1000) -> ResNet:
    return ResNet(BasicBlock, [3, 4, 6, 3], num_classes)


def resnet50(num_classes: int = 1000) -> ResNet:
    return ResNet(Bottleneck, [3, 4, 6, 3], num_classes)


def resnet101(num_classes: int = 1000) -> ResNet:
    return ResNet(Bottleneck, [3, 4, 23, 3], num_classes)


def resnet152(num_classes: int = 1000) -> ResNet:
    return ResNet(Bottleneck, [3, 8, 36, 3], num_classes)


def resnext50_32x4d(num_classes: int = 1000) -> ResNet:
    return ResNet(Bottleneck, [3, 4, 6, 3], num_classes, groups=32, width_per_group=4)


def wide_resnet50_2(num_classes: int = 1000) -> ResNet:
    return ResNet(Bottleneck, [3, 4, 6, 3], num_classes, width_per_group=128)


class TinyEncoder(nn.Module):
    """Minimal conv encoder for tests (the JAX package's ``TinyEncoder``;
    not in the reference). x: (B, H, W, 3)."""

    def __init__(self, num_classes: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 16, 5, 4, 2, bias=False)
        self.conv2 = nn.Conv2d(16, 32, 3, 2, 1, bias=False)
        self.fc = nn.Linear(32, num_classes)

    def forward(self, x):
        x = F.relu(_conv(self.conv1, x.permute(0, 3, 1, 2)))
        x = F.relu(_conv(self.conv2, x))
        return dense(x.mean(dim=(2, 3)), self.fc.weight, self.fc.bias)


class KeypointResNet(ResNet):
    """Diffusion Policy's image encoder (``obs_encoder_group_norm``,
    robomimic ``VisualCore`` with ``ResNet18Conv`` and ``SpatialSoftmax``):
    the ResNet-18 trunk with ``GroupNorm(C / 16, C)`` in place of every
    BatchNorm, a 1x1 convolution to ``num_keypoints`` maps, a softmax over
    each map's positions, each map's expected (x, y) on a [-1, 1] grid,
    flattened as (x0, y0, x1, y1, ...), then ``fc`` to ``num_classes``.
    x: (B, H, W, 3)."""

    def __init__(self, num_classes: int = 64, num_keypoints: int = 32):
        super().__init__(BasicBlock, [2, 2, 2, 2], num_classes)
        for mod in list(self.modules()):
            for name, child in mod.named_children():
                if isinstance(child, nn.BatchNorm2d):
                    setattr(mod, name, nn.GroupNorm(child.num_features // 16, child.num_features))
        self.keypoints = nn.Conv2d(512, num_keypoints, 1)
        self.fc = nn.Linear(2 * num_keypoints, num_classes)

    def forward(self, x):
        kp = self.keypoints
        maps = F.conv2d(self.trunk(x), kp.weight.to(x.dtype), kp.bias.to(x.dtype))
        B, K, H, W = maps.shape
        attn = torch.softmax(maps.reshape(B, K, H * W).to(torch.float32), dim=-1)
        # the grid in float64, as robomimic builds it with numpy, stored float32
        grid = lambda n: torch.linspace(-1.0, 1.0, n, dtype=torch.float64, device=x.device).to(torch.float32)
        gy, gx = torch.meshgrid(grid(H), grid(W), indexing="ij")
        xy = torch.stack([(attn * gx.reshape(-1)).sum(-1), (attn * gy.reshape(-1)).sum(-1)], dim=-1)
        return dense(xy.reshape(B, 2 * K).to(x.dtype), self.fc.weight, self.fc.bias)


# JAX ``models/temporal_unet.py:74-83``; ``resnet18_gn_keypoints`` is the
# port's own, for Diffusion Policy's CNN (``models/conditional_unet1d.py``)
PERCEPTION_BUILDERS = {
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "resnet152": resnet152,
    "resnext50_32x4d": resnext50_32x4d,
    "wide_resnet50_2": wide_resnet50_2,
    "tiny": TinyEncoder,
    "resnet18_gn_keypoints": KeypointResNet,
}
