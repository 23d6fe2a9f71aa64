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

All draws are made before the augmentation runs (:func:`augment_draws`):
the per-image choices (order, gates, strengths) from one explicit
``torch.Generator``, then, from a generator on the images' device seeded
from it, the whole-image fields (noise, dropout uniforms) at full batch
shape. The body (:func:`augment_body`) is branch-free, as JAX's vmapped
``lax.switch`` over the ops is: at each of the 7 positions every image goes
through every op and a mask keeps its own op's result, so no shape depends
on the data and nothing is read back to the host, and
:class:`AugmentProgram` captures it as one CUDA graph per batch shape. Each
op is a function of the draws it is given (``_blur``, ``_add_noise``, ...),
so its math can be checked alone. JAX's random numbers differ from
PyTorch's, so the two packages agree in distribution, not in values.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import program
from ..utils import profiling

__all__ = ["augment_factors", "augment_draws", "augment_body", "augment_batch", "AugmentProgram",
           "normalize_images", "IMAGENET_MEAN", "IMAGENET_STD"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
OPS = ("blur", "noise", "coarse_dropout", "dropout", "add", "multiply", "contrast")  # op j


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


def _blur_taps(sigma: torch.Tensor) -> torch.Tensor:
    """(n, 5): each image's 5-tap Gaussian of std ``sigma``, normalized; the
    identity below a sigma of 1e-3."""
    offsets = torch.arange(-2.0, 3.0, device=sigma.device)
    k = torch.exp(-0.5 * (offsets[None] / sigma.clamp_min(1e-3)[:, None]) ** 2)
    delta = torch.tensor([0.0, 0.0, 1.0, 0.0, 0.0], device=sigma.device)
    return torch.where(sigma[:, None] < 1e-3, delta, k / k.sum(dim=1, keepdim=True))


def _separable(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Image i convolved with ``taps[i]`` (n, 5) along H, then along W, zero
    padding: shifted copies summed in tap order, so a row's result does not
    depend on the batch around it."""
    n, H, W, C = x.shape
    k = taps.reshape(n, 5, 1, 1, 1)
    xp = F.pad(x, (0, 0, 0, 0, 2, 2))
    out = xp[:, 0:H] * k[:, 0]
    for t in range(1, 5):
        out = torch.addcmul(out, xp[:, t:t + H], k[:, t])
    xp = F.pad(out, (0, 0, 2, 2))
    out = xp[:, :, 0:W] * k[:, 0]
    for t in range(1, 5):
        out = torch.addcmul(out, xp[:, :, t:t + W], k[:, t])
    return out


def _blur(x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Separable 5-tap Gaussian of std ``sigma`` per image, zero padding;
    sigma below 1e-3 leaves the image as it is."""
    return _separable(x, _blur_taps(sigma))


def _add_noise(x: torch.Tensor, scale: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """``noise``: standard normal, (n, H, W, C) or (n, H, W, 1) broadcast."""
    return x + noise * _per_image(scale)


@functools.lru_cache(maxsize=None)
def _nearest_index(device: torch.device, h: int, w: int, H: int, W: int):
    """The rows and columns a nearest resize from (h, w) to (H, W) reads,
    made once per device and shape (no host copy inside a CUDA graph)."""
    rows = torch.from_numpy(np.floor((np.arange(H) + 0.5) * h / H).astype(np.int64)).to(device)
    cols = torch.from_numpy(np.floor((np.arange(W) + 0.5) * w / W).astype(np.int64)).to(device)
    return rows, cols


def _nearest_up(mask: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(n, h, w, C) -> (n, H, W, C), nearest with half-pixel centres
    (``jax.image.resize(..., "nearest")``)."""
    rows, cols = _nearest_index(mask.device, mask.shape[1], mask.shape[2], H, W)
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


def augment_draws(generator: torch.Generator, shape, image_iteration, device, out=None) -> dict:
    """Every draw of one augmentation of images of ``shape`` (B, H, W, C),
    made before the body runs. From ``generator``, in this order: each
    image's order of the seven ops (B, 7), whether each op applies (B, 7,
    probability ``frequency``), whether it draws per channel (B, 7,
    probability ``color``), a uniform strength per op (B, 7), uniform
    per-channel and shared values (B, 7, C) and (B, 7) for Add, Multiply and
    LinearContrast, and one seed; then, from a generator on ``device``
    seeded with it, the noise field, the coarse dropout's uniforms and the
    dropout's uniforms at full batch shape. What the body needs of them is
    computed here, on the generator's device: ``select[k, j]``, the images
    whose k-th op is ``OPS[j]`` and applies; each image's blur taps, noise
    scale, dropout probabilities and Add / Multiply / LinearContrast values.
    ``out``: the dict an earlier call returned for this shape and
    ``device``, filled in place (a program's buffers); else one is made."""
    f = augment_factors(image_iteration)
    B, H, W, C = shape
    g = generator
    order = torch.argsort(torch.rand((B, 7), generator=g, device=g.device), dim=1)
    apply = torch.rand((B, 7), generator=g, device=g.device) < float(f["frequency"])
    per_c = torch.rand((B, 7), generator=g, device=g.device) < float(f["color"])
    u = torch.rand((B, 7), generator=g, device=g.device)
    v_c = torch.rand((B, 7, C), generator=g, device=g.device)
    v_s = torch.rand((B, 7), generator=g, device=g.device)
    seed = int(torch.randint(0, 2**62, (1,), generator=g, device=g.device))
    values = []
    for j, (lo, hi) in enumerate(((-f["add"], f["add"]), (f["mul_neg"], f["mul_pos"]),
                                  (f["contrast_neg"], f["contrast_pos"])), start=4):
        lo, hi = float(lo), float(hi)
        v = torch.where(per_c[:, j, None], v_c[:, j], v_s[:, j, None]) * (hi - lo) + lo
        values.append(v.reshape(B, 1, 1, C))
    small = {
        "select": (order.T[:, None, :] == torch.arange(7, device=g.device)[None, :, None]) & apply.T[None],
        "per_c": per_c,
        "blur_taps": _blur_taps(u[:, 0] * float(f["blur"])),
        "noise_scale": u[:, 1] * float(f["dropout"]) * 255.0,
        "coarse_p": u[:, 2] * float(f["dropout"]),
        "dropout_p": u[:, 3] * float(f["dropout"]),
        "values": torch.stack(values),
    }
    device = torch.device(device)
    if out is None:
        out = {k: torch.empty(v.shape, dtype=v.dtype, device=device) for k, v in small.items()}
        out.update(noise=torch.empty(shape, device=device), dropout=torch.empty(shape, device=device),
                   coarse=torch.empty((B, max(H // 8, 1), max(W // 8, 1), C), device=device))
    for k, v in small.items():
        out[k].copy_(v)
    fields = torch.Generator(device=device).manual_seed(seed)
    out["noise"].normal_(generator=fields)
    out["coarse"].uniform_(generator=fields)
    out["dropout"].uniform_(generator=fields)
    return out


def augment_body(images: torch.Tensor, d: dict) -> torch.Tensor:
    """The augmentation's device body: uint8 NHWC -> float32 [0, 255] from
    the draws ``d`` (:func:`augment_draws`). No shape depends on the data
    and nothing is read back to the host: at each of the 7 positions every
    image goes through every op, and ``select`` keeps the result of the
    image's own op there (as JAX's vmapped ``lax.switch`` does). Bit for bit
    the ops each image takes, applied in its order."""
    x = images.to(torch.float32)
    H, W = x.shape[1:3]
    per_c = d["per_c"]
    noise = _channel_choice(per_c[:, 1], d["noise"]) * _per_image(d["noise_scale"])
    coarse = _nearest_up(_channel_choice(per_c[:, 2], d["coarse"]) < _per_image(d["coarse_p"]), H, W)
    dropout = _channel_choice(per_c[:, 3], d["dropout"]) < _per_image(d["dropout_p"])
    add, mul, contrast = d["values"]
    for k in range(7):  # the k-th op of each image's order
        on = [_per_image(m) for m in d["select"][k]]
        # an op an image does not take here leaves it as it is: a where, or
        # an exact identity (+ 0, x 1, no dropped pixel) in one pass
        x = torch.where(on[0], _separable(x, d["blur_taps"]), x)
        x = torch.addcmul(x, noise, on[1].to(x.dtype))
        x = x.masked_fill(coarse & on[2], 0.0)
        x = x.masked_fill(dropout & on[3], 0.0)
        x = x + torch.where(on[4], add, 0.0)
        x = x * torch.where(on[5], mul, 1.0)
        x = torch.where(on[6], _contrast(x, contrast), x)
    return x.clamp(0.0, 255.0)


def augment_batch(images: torch.Tensor, generator: torch.Generator, image_iteration) -> torch.Tensor:
    """Augment a uint8 NHWC batch on its device -> float32 [0, 255]: the
    body on the draws of :func:`augment_draws`, eagerly."""
    return augment_body(images, augment_draws(generator, images.shape, image_iteration, images.device))


class AugmentProgram(program.Programs):
    """``program(images, generator, image_iteration) -> float32``:
    :func:`augment_batch` as one program (the counterpart of the JAX train
    loop's ``jax.jit(augment_batch)``). It holds fixed buffers per key (the
    images' shape and dtype): the uint8 images and every draw. A call makes
    the draws into the buffers (``augment_draws``), copies the images in
    and runs the body on them. On a CUDA device the body is a CUDA graph
    per key (``ops/program.py``): run once eagerly on a side stream, then
    captured and replayed on every later call; a capture that fails raises
    ``RuntimeError`` naming the key. On the CPU the body runs on the
    buffers. Returns a copy a later call does not overwrite.

    Tracing (``utils/profiling.py``): a call is the host span ``augment``,
    whose request is the program's call count, with the children
    ``augment.draws`` (the draws and the copies into the buffers),
    ``augment.build`` on a miss and ``augment.replay`` (the replay's launch
    and the output's copy; on the CPU the body). The graph is one device
    span, ``augment`` (2 markers), read only by ``profiling.report()``. A
    build counts ``captures.augment`` and its seconds."""

    def __init__(self, device):
        super().__init__(device)
        self.calls = 0

    def __call__(self, images: torch.Tensor, generator: torch.Generator, image_iteration) -> torch.Tensor:
        request, self.calls = self.calls, self.calls + 1
        with profiling.span("augment", request=request):
            self.key = key = (tuple(images.shape), images.dtype)
            prog = self.programs.get(key) or program.Program(
                {"images": torch.empty_like(images, device=self.device), "draws": None})
            bufs = prog.inputs
            with profiling.span("augment.draws"):
                bufs["draws"] = augment_draws(generator, images.shape, image_iteration, self.device, bufs["draws"])
                bufs["images"].copy_(images)
            if self.device.type == "cuda" and prog.graph is None:
                with profiling.span("augment.build"):
                    self._build(prog, key)  # raises if the capture fails
            with profiling.span("augment.replay"):
                if prog.graph is None:
                    out = augment_body(bufs["images"], bufs["draws"])
                else:
                    out = self.replay(prog).clone()
            self.programs[key] = prog
            return out

    def _build(self, prog: program.Program, key) -> None:
        images, draws = prog.inputs["images"], prog.inputs["draws"]

        def marked():
            profiling.mark("augment")
            out = augment_body(images, draws)
            profiling.mark_end()
            return out

        self.warm(prog, lambda: augment_body(images, draws))  # builds what the body builds at first use
        self.capture(prog, marked, f"the augmentation for the key (images {key[0]}, "
                                   f"{str(key[1]).replace('torch.', '')})", "augment", 2)
