"""A training step in plain PyTorch (the reference repository's train.py:
106-327): the image augmentation from its draws, normalization, the noised
trajectory, the x0-prediction loss, the backward pass, the NaN scrub, AdamW
at the warmup schedule's rate, and the EMA of the weights.

The augmentation is the one the JAX package and its port apply
(reference: dataset/augment.py:10-77, with the ports' own choices: a 1/8
grid for CoarseDropout, "per channel" drawn per op). Every draw comes from
a CPU generator in a fixed order, then three fields from a generator on the
images' device seeded from it; :func:`augment_draws` makes them in that
order, so the same seed gives the program's draws. Each image then takes
its own ops, in its own order, one after another.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from .planner import alphas_cumprod, normalize

__all__ = ["read_waypoints", "augment_factors", "augment_draws", "augment", "lr_at", "ema_decay", "AdamW", "train_loss",
           "scrub_"]

BETAS = (0.95, 0.999)
EPS = 1e-7
WEIGHT_DECAY = 0.01
EMA_UPDATE_AFTER = 5000


def read_waypoints(root: str, rows, device):
    """The target points (n, 2) and the transitions (n, 16, 7), clipped to
    [-1, 1], of the dataset's samples ``rows``: ``waypoints/{i:06d}.txt``
    holds the target on its first line, then one transition a line
    (dataset/carla_dataset.py:29-43)."""
    target, trajs = [], []
    for i in rows:
        with open(os.path.join(root, "waypoints", f"{int(i):06d}.txt")) as f:
            lines = [line.split() for line in f if line.strip()]
        target.append([float(v) for v in lines[0]])
        trajs.append(np.clip([[float(v) for v in line] for line in lines[1:]], -1.0, 1.0))
    as_tensor = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return as_tensor(target), as_tensor(trajs)


def augment_factors(image_iteration: int) -> dict:
    """Strengths annealed with the count of images seen (augment.py:11-26),
    in float32."""
    f = np.float32
    it = f(image_iteration) / f(32.0)
    return {
        "frequency": np.minimum(f(0.05) + it / f(200000.0), f(0.5)),
        "color": np.minimum(it / f(1000000.0), f(0.5)),
        "dropout": f(0.198667) + f(0.03856658 - 0.198667) / (f(1.0) + (it / f(196416.6)) ** f(1.863486)),
        "blur": np.minimum(f(0.5) + f(0.5) * it / f(100000.0), f(0.5)),
        "add": f(10.0) + f(10.0) * it / f(100000.0),
        "mul_pos": f(1.0) + f(2.5) * it / f(200000.0),
        "mul_neg": f(1.0) - f(0.91) * it / f(500000.0),
        "contrast_pos": f(1.0) + f(0.5) * it / f(500000.0),
        "contrast_neg": f(1.0) - f(0.5) * it / f(500000.0),
    }


def augment_draws(generator: torch.Generator, shape, image_iteration: int, device) -> dict:
    """The draws of one batch of images of ``shape`` (B, H, W, C): per
    image the order of the 7 ops, whether each applies, whether it draws
    per channel, a uniform strength, per-channel and shared uniforms, then
    a seed; from a generator on ``device`` seeded with it, the noise field
    and the uniforms of the coarse and the pixel dropout."""
    B, H, W, C = shape
    g = generator
    d = {"order": torch.argsort(torch.rand((B, 7), generator=g), dim=1)}
    f = augment_factors(image_iteration)
    d["apply"] = torch.rand((B, 7), generator=g) < float(f["frequency"])
    d["per_c"] = torch.rand((B, 7), generator=g) < float(f["color"])
    d["u"] = torch.rand((B, 7), generator=g)
    d["v_c"] = torch.rand((B, 7, C), generator=g)
    d["v_s"] = torch.rand((B, 7), generator=g)
    seed = int(torch.randint(0, 2**62, (1,), generator=g))
    fields = torch.Generator(device=device).manual_seed(seed)
    d["noise"] = torch.empty(shape, device=device).normal_(generator=fields)
    d["coarse"] = torch.empty((B, max(H // 8, 1), max(W // 8, 1), C), device=device).uniform_(generator=fields)
    d["dropout"] = torch.empty(shape, device=device).uniform_(generator=fields)
    d["factors"] = f
    return d


def _blur(x, sigma: float):
    """5-tap Gaussian of std ``sigma`` along H, then W, zero padding;
    (H, W, C) image."""
    if sigma < 1e-3:
        return x
    o = torch.arange(-2.0, 3.0)
    k = torch.exp(-0.5 * (o / sigma) ** 2)
    k = (k / k.sum()).to(x.device)
    H, W = x.shape[:2]
    xp = F.pad(x, (0, 0, 0, 0, 2, 2))
    x = sum(xp[t:t + H] * k[t] for t in range(5))
    xp = F.pad(x, (0, 0, 2, 2))
    return sum(xp[:, t:t + W] * k[t] for t in range(5))


def _nearest_up(mask, H: int, W: int):
    """(h, w, C) -> (H, W, C), nearest with half-pixel centres."""
    h, w = mask.shape[:2]
    rows = torch.from_numpy(np.floor((np.arange(H) + 0.5) * h / H).astype(np.int64)).to(mask.device)
    cols = torch.from_numpy(np.floor((np.arange(W) + 0.5) * w / W).astype(np.int64)).to(mask.device)
    return mask[rows][:, cols]


def augment(images_u8: torch.Tensor, d: dict) -> torch.Tensor:
    """uint8 NHWC -> float32 in [0, 255]: each image through its own ops."""
    f = d["factors"]
    out = []
    for i, img in enumerate(images_u8.float()):
        H, W, C = img.shape
        ch = lambda field, j: field if bool(d["per_c"][i, j]) else field[..., :1].expand_as(field)
        value = lambda j, lo, hi: ((d["v_c"][i, j] if bool(d["per_c"][i, j]) else d["v_s"][i, j].expand(C))
                                   * (float(hi) - float(lo)) + float(lo)).to(img.device)
        u = d["u"][i]
        for j in d["order"][i].tolist():
            if not bool(d["apply"][i, j]):
                continue
            if j == 0:
                img = _blur(img, float(u[0] * float(f["blur"])))
            elif j == 1:
                img = img + ch(d["noise"][i], 1) * float(u[1] * float(f["dropout"]) * 255.0)
            elif j == 2:
                drop = ch(d["coarse"][i], 2) < float(u[2] * float(f["dropout"]))
                img = torch.where(_nearest_up(drop, H, W), 0.0, img)
            elif j == 3:
                img = torch.where(ch(d["dropout"][i], 3) < float(u[3] * float(f["dropout"])), 0.0, img)
            elif j == 4:
                img = img + value(4, -f["add"], f["add"])
            elif j == 5:
                img = img * value(5, f["mul_neg"], f["mul_pos"])
            else:
                img = 127.0 + value(6, f["contrast_neg"], f["contrast_pos"]) * (img - 127.0)
        out.append(img.clamp(0.0, 255.0))
    return torch.stack(out)


def lr_at(update: int, base_lr: float, warmup: int) -> float:
    """The rate of update ``update`` (0 first): linear warmup from 0, then
    constant (diffusers' constant schedule with warmup), in float32."""
    warm = min(np.float32(update) / np.float32(max(warmup, 1)), np.float32(1.0))
    return float(np.float32(base_lr) * warm)


def ema_decay(count: int, max_decay: float, inv_gamma: float, power: float) -> float:
    """diffusers EMAModel's decay at its ``count``-th update (1 first),
    with the reference's update_after_step 5000 and warmup."""
    step = max(count - EMA_UPDATE_AFTER - 1, 0)
    if step <= 0:
        return 0.0
    one = np.float32(1.0)
    cur = one - (one + np.float32(step) / np.float32(inv_gamma)) ** np.float32(-power)
    return float(min(cur, np.float32(max_decay)))


class AdamW:
    """torch.optim.AdamW's update with betas (0.95, 0.999), eps 1e-7 and
    weight decay 0.01 (train.py:170), written out: decay the weight, move
    the moments, step by the bias-corrected ratio."""

    def __init__(self, params: dict):
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict, lr: float) -> None:
        self.count += 1
        b1, b2 = BETAS
        c1, c2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        for k, p in params.items():
            g = grads[k]
            p.mul_(1 - lr * WEIGHT_DECAY)
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(lr / c1 * self.m[k] / (self.v[k].sqrt() / math.sqrt(c2) + EPS))


def scrub_(grads: dict) -> None:
    """NaN -> 0, +-inf -> +-1e5 (train.py:252-255)."""
    for g in grads.values():
        torch.nan_to_num_(g, nan=0.0, posinf=1e5, neginf=-1e5)


def train_loss(model, cfg: dict, images: torch.Tensor, trajs, target, t, noise, keep):
    """The loss of one batch: ``images`` float [0, 255] NHWC after
    augmentation; x_t from the batch's x0 ``trajs`` at timesteps ``t``
    with ``noise``, the first waypoint's anchor dims zeroed; the target
    kept under classifier-free guidance where ``keep``; MSE against x0."""
    if cfg["TRAIN"]["NOISE_SCHEDULER"]["PRED_TYPE"] != "sample":
        raise ValueError("the reference trains the sample prediction")
    ac = alphas_cumprod(cfg["TRAIN"]["TIME_STEPS"], cfg["TRAIN"]["NOISE_SCHEDULER"]["TYPE"], trajs.device)[t]
    x = ac.sqrt()[:, None, None] * trajs + (1 - ac).sqrt()[:, None, None] * noise
    x[:, 0, :3] = 0.0
    cond = None
    if cfg["TRAIN"]["USE_COND"] == "FREE_GUIDANCE":
        cond = torch.where(keep, target, torch.zeros_like(target))
    pred = model(x, t.float(), model.encode(normalize(images)), cond)
    return torch.mean((pred - trajs) ** 2)
