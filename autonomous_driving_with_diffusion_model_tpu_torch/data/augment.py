"""Image normalization (counterpart of the JAX package's
``data/augment.py:normalize_images``). The on-device augmentation pipeline
is a later slice, with training."""

from __future__ import annotations

import torch

__all__ = ["normalize_images", "IMAGENET_MEAN", "IMAGENET_STD"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """[0, 255] (uint8 or float) NHWC -> ImageNet-normalized float32
    (reference: train.py:156-161)."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=images.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=images.device)
    return (images.to(torch.float32) / 255.0 - mean) / std
