"""Image normalization and on-device augmentation (counterpart of the JAX
package's ``data/augment.py``; reference: dataset/augment.py:10-77).

Seven iteration-annealed ops (GaussianBlur, AdditiveGaussianNoise,
CoarseDropout, Dropout, Add, Multiply, LinearContrast), each applied to an
image with probability ``frequency``, in a random order per image, in
float32 [0, 255] on the images' device, then clipped to [0, 255]. The JAX
package's own divergences from imgaug are kept: CoarseDropout draws its
mask on a 1/8-resolution grid and resizes it (nearest, half-pixel centres,
as ``jax.image.resize``); each op draws "per channel" with probability
``color``.

The draws come from one explicit ``torch.Generator`` (:func:`augment_batch`):
the per-image choices (order, gates, strengths) on the generator's device,
then one seed from it for the whole-image fields (noise, dropout masks),
which are drawn on the images' device. Each op is a function of the draws
it is given (``_blur``, ``_add_noise``, ...), so its math can be checked
alone. JAX's random numbers differ from PyTorch's, so the two packages
agree in distribution, not in values.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["augment_factors", "augment_batch", "normalize_images", "IMAGENET_MEAN", "IMAGENET_STD"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
OPS = ("blur", "noise", "coarse_dropout", "dropout", "add", "multiply", "contrast")


@functools.lru_cache(maxsize=None)
def _imagenet_stats(device: torch.device):
    """(mean, std) as float32 tensors on ``device``, made once: a copy from
    the host cannot be captured in a CUDA graph (``driving/program.py``)."""
    return (torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device),
            torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device))


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """[0, 255] (uint8 or float) NHWC -> ImageNet-normalized float32
    (reference: train.py:156-161)."""
    mean, std = _imagenet_stats(images.device)
    return (images.to(torch.float32) / 255.0 - mean) / std


def augment_factors(image_iteration) -> dict:
    """Iteration-annealed strengths (reference: augment.py:11-26), float32
    numpy scalars, computed as the JAX package computes them."""
    f = np.float32
    it = f(image_iteration) / f(32.0)
    return {
        "frequency": np.minimum(f(0.05) + it / f(200000.0), f(0.5)),
        "color": np.minimum(it / f(1000000.0), f(0.5)),
        # the constant difference in float64, as Python folds it there
        "dropout": f(0.198667) + f(0.03856658 - 0.198667) / (f(1.0) + (it / f(196416.6)) ** f(1.863486)),
        "blur": np.minimum(f(0.5) + f(0.5) * it / f(100000.0), f(0.5)),
        "add": f(10.0) + f(10.0) * it / f(100000.0),
        "mul_pos": f(1.0) + f(2.5) * it / f(200000.0),
        "mul_neg": f(1.0) - f(0.91) * it / f(500000.0),
        "contrast_pos": f(1.0) + f(0.5) * it / f(500000.0),
        "contrast_neg": f(1.0) - f(0.5) * it / f(500000.0),
    }


# ---------------------------------------------------------------- the ops
# x: (n, H, W, C) float32; per-image strengths (n,); fields on x's device


def _per_image(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(-1, 1, 1, 1)


def _blur(x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Separable 5-tap Gaussian of std ``sigma`` per image, zero padding;
    sigma below 1e-3 leaves the image as it is."""
    n, H, W, C = x.shape
    offsets = torch.arange(-2.0, 3.0, device=x.device)
    k = torch.exp(-0.5 * (offsets[None] / sigma.clamp_min(1e-3)[:, None]) ** 2)
    delta = torch.tensor([0.0, 0.0, 1.0, 0.0, 0.0], device=x.device)
    k = torch.where(sigma[:, None] < 1e-3, delta, k / k.sum(dim=1, keepdim=True))
    k = k.repeat_interleave(C, dim=0)  # (n C, 5): image i's kernel for each of its channels
    xt = x.permute(0, 3, 1, 2).reshape(1, n * C, H, W)
    out = F.conv2d(xt, k.reshape(n * C, 1, 5, 1), padding=(2, 0), groups=n * C)
    out = F.conv2d(out, k.reshape(n * C, 1, 1, 5), padding=(0, 2), groups=n * C)
    return out.reshape(n, C, H, W).permute(0, 2, 3, 1)


def _add_noise(x: torch.Tensor, scale: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """``noise``: standard normal, (n, H, W, C) or (n, H, W, 1) broadcast."""
    return x + noise * _per_image(scale)


def _nearest_up(mask: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(n, h, w, C) -> (n, H, W, C), nearest with half-pixel centres
    (``jax.image.resize(..., "nearest")``)."""
    h, w = mask.shape[1:3]
    rows = torch.from_numpy(np.floor((np.arange(H) + 0.5) * h / H).astype(np.int64)).to(mask.device)
    cols = torch.from_numpy(np.floor((np.arange(W) + 0.5) * w / W).astype(np.int64)).to(mask.device)
    return mask.index_select(1, rows).index_select(2, cols)


def _coarse_dropout(x: torch.Tensor, drop: torch.Tensor) -> torch.Tensor:
    """``drop``: (n, H // 8, W // 8, C) of 0/1, resized to the image."""
    return x * (1.0 - _nearest_up(drop, x.shape[1], x.shape[2]))


def _dropout(x: torch.Tensor, drop: torch.Tensor) -> torch.Tensor:
    return x * (1.0 - drop)


def _add(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``v``: (n, 1, 1, C) or (n, 1, 1, 1)."""
    return x + v


def _multiply(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return x * v


def _contrast(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return 127.0 + alpha * (x - 127.0)


# ---------------------------------------------------------------- the draws


def _channel_choice(per_c: torch.Tensor, field: torch.Tensor) -> torch.Tensor:
    """One field per channel where ``per_c``, else channel 0's for all."""
    return torch.where(_per_image(per_c), field, field[..., :1])


def _apply(op: str, x: torch.Tensor, d: dict, f: dict, gen: torch.Generator) -> torch.Tensor:
    """Op ``op`` on images x with their choices ``d`` (u, per_c, v_c, v_s on
    x's device); whole-image fields drawn from ``gen``."""
    n, H, W, C = x.shape
    u, per_c = d["u"], d["per_c"]
    if op == "blur":
        return _blur(x, u * float(f["blur"]))
    if op == "noise":
        z = torch.randn(x.shape, generator=gen, device=x.device)
        return _add_noise(x, u * float(f["dropout"]) * 255.0, _channel_choice(per_c, z))
    if op in ("coarse_dropout", "dropout"):
        shape = (n, max(H // 8, 1), max(W // 8, 1), C) if op == "coarse_dropout" else x.shape
        p = _per_image(u * float(f["dropout"]))
        drop = (_channel_choice(per_c, torch.rand(shape, generator=gen, device=x.device)) < p).to(x.dtype)
        return _coarse_dropout(x, drop) if op == "coarse_dropout" else _dropout(x, drop)
    lo, hi = {"add": (-f["add"], f["add"]), "multiply": (f["mul_neg"], f["mul_pos"]),
              "contrast": (f["contrast_neg"], f["contrast_pos"])}[op]
    lo, hi = float(lo), float(hi)
    v = torch.where(per_c[:, None], d["v_c"], d["v_s"][:, None]) * (hi - lo) + lo
    v = v.reshape(n, 1, 1, C)
    return {"add": _add, "multiply": _multiply, "contrast": _contrast}[op](x, v)


def augment_batch(images: torch.Tensor, generator: torch.Generator, image_iteration) -> torch.Tensor:
    """Augment a uint8 NHWC batch on its device -> float32 [0, 255].

    From ``generator``, in this order: each image's order of the seven ops
    (B, 7), whether each op applies (B, 7, probability ``frequency``),
    whether it draws per channel (B, 7, probability ``color``), a uniform
    strength per op (B, 7), uniform per-channel and shared values (B, 7, C)
    and (B, 7) for Add, Multiply and LinearContrast, and one seed for the
    noise and dropout fields."""
    f = augment_factors(image_iteration)
    x = images.to(torch.float32)
    B, C = x.shape[0], x.shape[-1]
    g = generator
    order = torch.argsort(torch.rand((B, 7), generator=g, device=g.device), dim=1)
    apply = torch.rand((B, 7), generator=g, device=g.device) < float(f["frequency"])
    per_c = torch.rand((B, 7), generator=g, device=g.device) < float(f["color"])
    u = torch.rand((B, 7), generator=g, device=g.device)
    v_c = torch.rand((B, 7, C), generator=g, device=g.device)
    v_s = torch.rand((B, 7), generator=g, device=g.device)
    seed = int(torch.randint(0, 2**62, (1,), generator=g, device=g.device))
    fields = torch.Generator(device=x.device).manual_seed(seed)
    order, apply = order.cpu().numpy(), apply.cpu().numpy()
    choices = {k: v.to(x.device) for k, v in dict(per_c=per_c, u=u, v_c=v_c, v_s=v_s).items()}
    for k in range(7):  # the k-th op of each image's order
        for j, op in enumerate(OPS):
            rows = np.nonzero((order[:, k] == j) & apply[:, j])[0]
            if len(rows) == 0:
                continue
            idx = torch.from_numpy(rows).to(x.device)
            d = {name: v.index_select(0, idx)[:, j] for name, v in choices.items()}
            x = x.index_copy(0, idx, _apply(op, x.index_select(0, idx), d, f, fields))
    return x.clamp(0.0, 255.0)
