"""The numbers that decide ``correct``: what the program produced against
what the plain reference computes from the same inputs.

Plans (``plan_gap``, in normalized trajectory units, xy divided by the 23.315
m a unit stands for): over the sampled plans, the larger of the widest gap
between any element of any of the K trajectories and the reference's, and
how far the program's choice falls behind the reference's best by the
reference's own score (the square root of the score's difference from its
least, the same units: a choice that flips between two near-equal
hypotheses reads as small as their gap, a wrong choice as large as the
hypotheses' spread).

Training, each over the leaves (parameter tensors), by the worst leaf: the
gap between the program's norm and the reference's, over the reference's
norm of that leaf or of the median leaf, whichever is larger:

* ``loss_gap``: the relative gap of each checked step's loss, the largest;
* ``grad_gap``: the first step's gradient as AdamW got it, read back from
  the program's first moment (``exp_avg / (1 - beta1)``) after that step;
* ``change_gap`` and ``ema_gap``: the change of the weights and of their
  EMA over the checked steps. Leaves whose reference gradient is under a
  thousandth of the median leaf's are left out of these two: AdamW moves
  them by round-off alone.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .reference.planner import MAGIC_NUM

__all__ = ["plan_gap", "leaf_gap", "train_gaps", "judge"]

NOUGHT_GRAD = 1e-3
BETA1 = 0.95


def _normalized(trajs: np.ndarray) -> np.ndarray:
    out = np.asarray(trajs, np.float64).copy()
    out[..., :2] /= MAGIC_NUM
    return out


def plan_gap(prog_trajs, prog_best, ref_trajs, ref_scores) -> Dict[str, float]:
    """``prog_trajs``/``ref_trajs`` (S, K, horizon, transition) with xy in
    meters, ``prog_best`` (S,), ``ref_scores`` (S, K)."""
    traj = float(np.abs(_normalized(prog_trajs) - _normalized(ref_trajs)).max())
    scores = np.asarray(ref_scores, np.float64)
    chosen = scores[np.arange(len(scores)), np.asarray(prog_best)]
    choice = float(np.sqrt(np.maximum(chosen - scores.min(axis=1), 0.0)).max())
    return {"plan_gap": max(traj, choice), "traj_gap": traj, "choice_gap": choice}


def leaf_gap(got: Dict[str, float], want: Dict[str, float], keys: Sequence[str]) -> float:
    """The worst leaf's |got - want| over max(want, the median leaf's want)."""
    med = float(np.median([want[k] for k in keys]))
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in keys) if keys else 0.0


def train_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref`` each hold ``losses`` (one per checked step)
    and, leaf by leaf, the norm of the first step's gradient (``grad``) and
    of the change of the weights (``change``) and of their EMA
    (``ema_change``) over the checked steps."""
    keys = sorted(ref["grad"])
    med = float(np.median([ref["grad"][k] for k in keys]))
    moving = [k for k in keys if ref["grad"][k] >= NOUGHT_GRAD * med]
    return {
        "loss_gap": max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])),
        "grad_gap": leaf_gap(prog["grad"], ref["grad"], keys),
        "change_gap": leaf_gap(prog["change"], ref["change"], moving),
        "ema_gap": leaf_gap(prog["ema_change"], ref["ema_change"], moving),
        "leaves_left_out": len(keys) - len(moving),
    }


def judge(numbers: Dict[str, float], limits: Dict[str, dict]) -> List[dict]:
    """Each compared number beside its limit: a number passes when it is
    finite and not above the limit."""
    rows = []
    for name, spec in limits.items():
        value = float(numbers[name])
        rows.append({"name": name, "value": value, "limit": float(spec["limit"]),
                     "ok": bool(np.isfinite(value) and value <= float(spec["limit"]))})
    return rows
