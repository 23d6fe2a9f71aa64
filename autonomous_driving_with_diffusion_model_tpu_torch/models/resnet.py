"""Perception encoders (counterpart of the JAX package's ``models/resnet.py``).

``resnet34`` is the torchvision layout the reference vendors (reference:
modeling/resnet.py:56-333) with the classifier head re-pointed to the
conditioning width (modeling/temporal.py:83-84). It takes NHWC images, like
the JAX package, and runs channels-first inside. BatchNorm normalizes with
the running statistics (eval mode): the port serves, it does not train yet.
The rest of the ResNet family waits for a later slice.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["BasicBlock", "ResNet", "resnet34", "TinyEncoder", "PERCEPTION_BUILDERS"]


def _bn_eval(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, bn.eps)


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (reference: modeling/resnet.py:56-110)."""

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, planes, 1, stride, 0, bias=False), nn.BatchNorm2d(planes)
            )

    def forward(self, x):
        out = F.relu(_bn_eval(self.bn1, self.conv1(x)))
        out = _bn_eval(self.bn2, self.conv2(out))
        identity = x
        if self.downsample is not None:
            identity = _bn_eval(self.downsample[1], self.downsample[0](x))
        return F.relu(out + identity)


class ResNet(nn.Module):
    """torchvision-compatible ResNet trunk + linear head. x: (B, H, W, 3)."""

    def __init__(self, layers, num_classes: int = 1000):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if stage == 0 else 2
            mods = []
            for i in range(blocks):
                mods.append(BasicBlock(cin, planes, stride if i == 0 else 1))
                cin = planes
            setattr(self, f"layer{stage + 1}", nn.Sequential(*mods))
        self.fc = nn.Linear(512, num_classes)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        x = F.relu(_bn_eval(self.bn1, self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.fc(x.mean(dim=(2, 3)))


def resnet34(num_classes: int = 1000) -> ResNet:
    return ResNet([3, 4, 6, 3], num_classes)


class TinyEncoder(nn.Module):
    """Minimal conv encoder for tests (the JAX package's ``TinyEncoder``;
    not in the reference). x: (B, H, W, 3)."""

    def __init__(self, num_classes: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 16, 5, 4, 2, bias=False)
        self.conv2 = nn.Conv2d(16, 32, 3, 2, 1, bias=False)
        self.fc = nn.Linear(32, num_classes)

    def forward(self, x):
        x = F.relu(self.conv1(x.permute(0, 3, 1, 2)))
        x = F.relu(self.conv2(x))
        return self.fc(x.mean(dim=(2, 3)))


PERCEPTION_BUILDERS = {"resnet34": resnet34, "tiny": TinyEncoder}
