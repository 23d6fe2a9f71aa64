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
so is this one's. :func:`train_scorer` fits it as the JAX package's does
(the same split, standardization, full-batch AdamW with optax's ``adamw``
defaults, and metrics), on the card unless asked otherwise.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.constants import MAGIC_NUM

__all__ = ["HypothesisScorer", "feature_dim", "init_scorer", "score_trajs", "train_scorer", "save_scorer",
           "load_scorer"]


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
                layer.bias.copy_(torch.from_numpy(np.array(p["bias"], np.float32)))
        return net.eval()

    def params(self) -> Dict:
        """The parameters as the flax-layout numpy tree."""
        return {f"Dense_{i}": {"kernel": layer.weight.detach().cpu().numpy().T.copy(),
                               "bias": layer.bias.detach().cpu().numpy().copy()}
                for i, layer in enumerate(self.layers)}

    def forward(self, trajs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """(K, H, C) and (2,) -> (K,), or a batch of sets: (N, K, H, C) and
        (N, 2) -> (N, K)."""
        trajs = trajs.to(torch.float32)
        lead = trajs.shape[:-2]  # (K,) or (N, K)
        target = target.to(torch.float32).reshape(lead[:-1] + (1, 2)).expand(lead + (2,))
        xy = trajs[..., :2] / MAGIC_NUM  # back to the dataset's ~[-1, 1]
        x = torch.cat([
            xy.flatten(-2),
            torch.diff(xy, dim=-2).flatten(-2),  # step vectors: shape and heading
            trajs[..., 2:].flatten(-2),
            xy[..., -1, :] - target,  # endpoint miss
            target,
        ], dim=-1)
        for layer in self.layers[:-1]:
            x = F.gelu(layer(x), approximate="tanh")
        return self.layers[-1](x)[..., 0]


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


def train_scorer(
    trajs: np.ndarray,
    targets: np.ndarray,
    outcomes: np.ndarray,
    *,
    seed: int = 0,
    steps: int = 3000,
    lr: float = 3e-3,
    weight_decay: float = 0.1,
    hidden: Tuple[int, ...] = (64, 64),
    val_fraction: float = 0.2,
    groups: Optional[np.ndarray] = None,
    params: Optional[Dict] = None,
    device=None,
) -> Tuple[Dict, Dict]:
    """Fit the scorer on counterfactual outcome labels (JAX
    ``models/scorer.py:train_scorer``).

    trajs: (N, K, H, C) candidate sets; targets: (N, 2); outcomes: (N, K)
    realized outcome per candidate (lower = better). ``groups`` (N,): whole
    groups (episodes) are held out until >= ``val_fraction`` of the rows are
    in validation, since one episode's consecutive rows are near-duplicates.
    Outcomes are standardized on the training rows; ``steps`` full-batch
    AdamW updates with optax ``adamw``'s defaults (b1 0.9, b2 0.999, eps
    1e-8) at ``weight_decay`` and a constant ``lr``. ``params``: the initial
    flax-layout tree (None: :func:`init_scorer` of ``seed``). Runs on
    ``device`` (None: the card). Returns (params as numpy, metrics: val MSE,
    top-1 regret of the scorer's pick and of a random pick, the held-out
    ``val_indices``)."""
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    trajs = np.asarray(trajs, np.float32)
    targets = np.asarray(targets, np.float32)
    outcomes = np.asarray(outcomes, np.float32)
    n = trajs.shape[0]
    rng = np.random.default_rng(seed)
    n_val = max(1, int(round(n * val_fraction)))
    if groups is not None:
        groups = np.asarray(groups)
        val_mask = np.zeros(n, bool)
        for g in rng.permutation(np.unique(groups)):
            if val_mask.sum() >= n_val:
                break
            val_mask |= groups == g
        val_idx, tr_idx = np.flatnonzero(val_mask), np.flatnonzero(~val_mask)
    else:
        perm = rng.permutation(n)
        val_idx, tr_idx = perm[:n_val], perm[n_val:]

    mu, sd = float(outcomes[tr_idx].mean()), float(outcomes[tr_idx].std() + 1e-8)
    y = (outcomes - mu) / sd

    if params is None:
        params = init_scorer(seed, trajs.shape[2], trajs.shape[3], hidden)
    net = HypothesisScorer.from_params(params, hidden).to(dev)
    optimizer = torch.optim.AdamW(net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=weight_decay)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    tr_t, tr_g, tr_y = put(trajs[tr_idx]), put(targets[tr_idx]), put(y[tr_idx])
    loss = torch.full((), float("nan"))
    for _ in range(steps):
        optimizer.zero_grad(set_to_none=True)
        loss = torch.mean((net(tr_t, tr_g) - tr_y) ** 2)
        loss.backward()
        optimizer.step()
    params = net.params()

    def regret(pick_idx: np.ndarray, idx: np.ndarray) -> float:
        out = outcomes[idx]
        return float(np.mean(out[np.arange(len(idx)), pick_idx] - out.min(axis=1)))

    with torch.no_grad():
        val_pred = net(put(trajs[val_idx]), put(targets[val_idx])).cpu().numpy()
    metrics = {
        "n_train": int(len(tr_idx)),
        "n_val": int(len(val_idx)),
        "final_train_loss": float(loss.detach()),
        "val_mse": float(np.mean((val_pred - y[val_idx]) ** 2)),
        "val_top1_regret": regret(val_pred.argmin(axis=1), val_idx),
        "val_top1_regret_random": regret(rng.integers(0, outcomes.shape[1], len(val_idx)), val_idx),
        "val_top1_regret_oracle": 0.0,
        "outcome_mu": mu,
        "outcome_sd": sd,
        # the held-out rows, so callers can baseline other scorers on the same split
        "val_indices": val_idx.tolist(),
    }
    return params, metrics


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
