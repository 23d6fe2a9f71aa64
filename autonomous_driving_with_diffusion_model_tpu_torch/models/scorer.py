"""Learned hypothesis scorer (counterpart of the JAX package's
``models/scorer.py``): a per-candidate MLP that ranks the K sampled plans of
``TPU.NUM_HYPOTHESES`` by their predicted closed-loop outcome (lower is
better, argmin selection). ``DiffusionPlanner`` uses it under
``TPU.HYPOTHESIS_SCORER=learned``, from ``TPU.SCORER_CHECKPOINT``.

The parameters are the JAX package's: a flax tree ``{"Dense_i": {"kernel":
(in, out), "bias": (out,)}}``, here as numpy arrays, written to and read
from the same ``.npz`` (``/``-joined paths plus ``__hidden__``), so a scorer
trained by the JAX package's ``learnability.py --learned-scorer`` loads here
and the other way round. flax's ``nn.gelu`` is the tanh approximation, and
so is this one's. Training (``train_scorer``) waits for the port's training.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.constants import MAGIC_NUM

__all__ = ["HypothesisScorer", "feature_dim", "init_scorer", "score_trajs", "save_scorer", "load_scorer"]


def feature_dim(horizon: int, transition_dim: int) -> int:
    """Width of a candidate's features: xy, its steps, the other channels,
    the endpoint miss and the target."""
    return 2 * horizon + 2 * (horizon - 1) + (transition_dim - 2) * horizon + 4


class HypothesisScorer(nn.Module):
    """(K, H, C) trajectories (xy in meters, the rest normalized) and the (2,)
    normalized ego-frame target -> (K,) scores; each candidate on its own."""

    def __init__(self, in_features: int, hidden: Tuple[int, ...] = (64, 64)):
        super().__init__()
        widths = (in_features,) + tuple(hidden) + (1,)
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))

    @classmethod
    def from_params(cls, params: Dict, hidden: Tuple[int, ...] = (64, 64)) -> "HypothesisScorer":
        """The module holding a flax-layout parameter tree."""
        net = cls(int(np.shape(params["Dense_0"]["kernel"])[0]), hidden)
        with torch.no_grad():
            for i, layer in enumerate(net.layers):
                p = params[f"Dense_{i}"]
                layer.weight.copy_(torch.from_numpy(np.asarray(p["kernel"], np.float32).T.copy()))
                layer.bias.copy_(torch.from_numpy(np.asarray(p["bias"], np.float32)))
        return net.eval()

    def forward(self, trajs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        trajs = trajs.to(torch.float32)
        target = target.to(torch.float32).reshape(2)
        k = trajs.shape[0]
        xy = trajs[..., :2] / MAGIC_NUM  # back to the dataset's ~[-1, 1]
        x = torch.cat([
            xy.reshape(k, -1),
            torch.diff(xy, dim=1).reshape(k, -1),  # step vectors: shape and heading
            trajs[..., 2:].reshape(k, -1),
            xy[:, -1, :] - target[None, :],  # endpoint miss
            target[None, :].expand(k, 2),
        ], dim=-1)
        for layer in self.layers[:-1]:
            x = F.gelu(layer(x), approximate="tanh")
        return self.layers[-1](x)[:, 0]


def init_scorer(seed: int = 0, horizon: int = 16, transition_dim: int = 7,
                hidden: Tuple[int, ...] = (64, 64)) -> Dict:
    """Fresh parameters (flax layout), drawn as flax's ``Dense`` draws them
    (LeCun-normal kernels truncated at 2 sigma, zero biases) from a numpy
    generator: the same distribution as the JAX package's, other numbers."""
    rng = np.random.default_rng(seed)
    widths = (feature_dim(horizon, transition_dim),) + tuple(hidden) + (1,)
    params = {}
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        z = rng.standard_normal((a, b))
        while np.any(np.abs(z) > 2.0):
            bad = np.abs(z) > 2.0
            z[bad] = rng.standard_normal(int(bad.sum()))
        # the std of a unit normal truncated at +-2 is 0.8796: rescale to 1/sqrt(fan_in)
        params[f"Dense_{i}"] = {"kernel": (z / 0.87962566103423978 / np.sqrt(a)).astype(np.float32),
                                "bias": np.zeros(b, np.float32)}
    return params


def score_trajs(params: Dict, trajs: torch.Tensor, target, hidden: Tuple[int, ...] = (64, 64)) -> torch.Tensor:
    """(K, H, C) trajectories, (2,) target -> (K,) scores, on ``trajs``' device."""
    trajs = torch.as_tensor(trajs)
    net = HypothesisScorer.from_params(params, hidden).to(trajs.device)
    with torch.no_grad():
        return net(trajs, torch.as_tensor(target, device=trajs.device))


def save_scorer(path: str, params: Dict, hidden: Tuple[int, ...] = (64, 64)) -> None:
    """The JAX package's ``.npz``: ``/``-joined parameter paths plus ``__hidden__``."""
    flat = {f"{layer}/{name}": np.asarray(v) for layer, leaves in params.items() for name, v in leaves.items()}
    flat["__hidden__"] = np.asarray(hidden, np.int64)
    np.savez(path, **flat)


def load_scorer(path: str) -> Tuple[Dict, Tuple[int, ...]]:
    """(params, hidden) from a ``save_scorer`` ``.npz`` of either package."""
    params: Dict = {}
    with np.load(path) as z:
        hidden = tuple(int(v) for v in z["__hidden__"])
        for key in z.files:
            if key != "__hidden__":
                layer, name = key.split("/")
                params.setdefault(layer, {})[name] = z[key]
    return params, hidden
