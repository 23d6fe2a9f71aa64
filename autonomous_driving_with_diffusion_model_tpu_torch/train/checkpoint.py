"""Training checkpoints (counterpart of the JAX package's
``train/checkpoint.py``).

* The reference ``.pth`` (train.py:288-299, JAX ``export_torch_checkpoint``
  / ``import_torch_checkpoint``): ``state_dict`` with the BatchNorm
  statistics and ``num_batches_tracked``; ``optimizer`` with the AdamW
  moments indexed in ``named_parameters`` order and ``step`` a float tensor;
  ``lr_scheduler`` ``{"last_epoch", "_step_count"}``; ``iter``; and
  ``ema_state_dict`` with its ``shadow_params`` list. As in the JAX package
  it maps ResNet-34 only and raises otherwise.
* For any encoder, the port's own ``torch.save`` of the model, optimizer,
  scheduler, EMA and step (:func:`save_checkpoint`): the counterpart of the
  JAX package's Orbax directory.

:func:`resume` reads either; :func:`load_eval_state_dict` takes the serving
weights (the EMA shadow over the parameters) from either.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.convert import apply_ema_shadow_params, build_mapping, load_torch_checkpoint
from .state import BETAS, EPS, WEIGHT_DECAY, TrainState

__all__ = ["export_torch_checkpoint", "import_torch_checkpoint", "save_checkpoint", "load_checkpoint",
           "resume", "load_eval_state_dict", "FORMAT"]

FORMAT = "adm-torch-train-state-1"  # the port's own checkpoint


def _require_resnet34(cfg) -> None:
    perception = cfg.MODEL.get("PERCEPTION", "resnet34")
    if perception != "resnet34":
        raise ValueError(
            f"torch checkpoint conversion requires MODEL.PERCEPTION=resnet34 "
            f"(the reference's encoder), got {perception}"
        )


def _params(state: TrainState, cfg):
    """The model's parameters in ``build_mapping`` order, which is
    ``named_parameters`` order (the reference's registration order)."""
    params_map, _ = build_mapping(cfg)
    named = list(state.model.named_parameters())
    if [n for n, _ in named] != [k for k, _, _ in params_map]:
        raise RuntimeError("the model's parameters are not in the reference order")
    return [p for _, p in named]


def _set_epoch(state: TrainState, epoch: int) -> None:
    """Put the LR schedule at ``epoch`` optimizer steps taken."""
    sched = state.scheduler
    sched.last_epoch = epoch
    sched._step_count = epoch + 1
    lrs = [base * lam(epoch) for base, lam in zip(sched.base_lrs, sched.lr_lambdas)]
    for group, lr in zip(state.optimizer.param_groups, lrs):
        group["lr"] = lr
    sched._last_lr = lrs


def export_torch_checkpoint(state: TrainState, cfg, path: str, base_lr: Optional[float] = None) -> None:
    """Write a reference-compatible ``.pth`` (train.py:288-299 layout)."""
    _require_resnet34(cfg)
    params = _params(state, cfg)
    cpu = lambda t: t.detach().to("cpu", copy=True)
    state_dict = {k: cpu(v) for k, v in state.model.state_dict().items()}
    opt_state = {}
    for i, p in enumerate(params):
        st = state.optimizer.state.get(p, {})
        opt_state[i] = {
            "step": torch.tensor(float(st.get("step", 0.0))),
            "exp_avg": cpu(st["exp_avg"]) if "exp_avg" in st else torch.zeros(p.shape),
            "exp_avg_sq": cpu(st["exp_avg_sq"]) if "exp_avg_sq" in st else torch.zeros(p.shape),
        }
    optimizer = {
        "state": opt_state,
        "param_groups": [{
            "lr": float(base_lr if base_lr is not None else cfg.TRAIN.LR),
            "betas": BETAS, "eps": EPS, "weight_decay": WEIGHT_DECAY, "amsgrad": False,
            "maximize": False, "foreach": None, "capturable": False, "differentiable": False,
            "fused": None, "initial_lr": float(cfg.TRAIN.LR), "params": list(range(len(params))),
        }],
    }
    ema_state_dict = {
        "decay": float(cfg.TRAIN.EMA_MAX_DECAY), "min_decay": 0.0,
        "optimization_step": int(state.ema.optimization_step), "update_after_step": 5000,
        "use_ema_warmup": True, "inv_gamma": float(cfg.TRAIN.EMA_INV_GAMMA),
        "power": float(cfg.TRAIN.EMA_POWER),
        "shadow_params": [cpu(s) for s in state.ema.shadow_params],
    }
    torch.save({
        "state_dict": state_dict,
        "optimizer": optimizer,
        "lr_scheduler": {"last_epoch": state.step, "_step_count": state.step + 1},
        "iter": state.step,
        "ema_state_dict": ema_state_dict,
    }, path)


@torch.no_grad()
def import_torch_checkpoint(path: str, cfg, state: TrainState) -> TrainState:
    """Resume ``state`` in place from a reference ``.pth``: parameters,
    BatchNorm statistics, AdamW moments and counts, LR schedule, EMA and
    iteration (reference train.py:182-194). The optimizer keeps its own
    hyperparameters: only the moments come from the file."""
    return _import(torch.load(path, map_location="cpu", weights_only=False), cfg, state)


def _import(ckpt: dict, cfg, state: TrainState) -> TrainState:
    _require_resnet34(cfg)
    params = _params(state, cfg)
    state.model.load_state_dict(ckpt["state_dict"], strict=True)
    entries = ckpt["optimizer"]["state"]
    for i, p in enumerate(params):
        e = entries[i]
        state.optimizer.state[p] = {
            "step": torch.tensor(float(e["step"]), dtype=torch.float32),
            "exp_avg": e["exp_avg"].to(p.device, p.dtype).clone(),
            "exp_avg_sq": e["exp_avg_sq"].to(p.device, p.dtype).clone(),
        }
    ema = ckpt["ema_state_dict"]
    for s, v in zip(state.ema.shadow_params, ema["shadow_params"], strict=True):
        s.copy_(v)
    state.ema.optimization_step = int(ema["optimization_step"])
    state.step = int(ckpt["iter"])
    _set_epoch(state, int(ckpt["lr_scheduler"]["last_epoch"]))
    return state


def save_checkpoint(state: TrainState, path: str) -> None:
    """The port's own checkpoint, for any encoder."""
    torch.save({
        "format": FORMAT,
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "ema": {"optimization_step": state.ema.optimization_step,
                "shadow_params": [s.detach().cpu() for s in state.ema.shadow_params]},
        "step": state.step,
    }, path)


@torch.no_grad()
def load_checkpoint(path: str, state: TrainState) -> TrainState:
    """Resume ``state`` in place from :func:`save_checkpoint`'s file."""
    return _load(torch.load(path, map_location="cpu", weights_only=False), state, path)


def _load(ckpt: dict, state: TrainState, path: str) -> TrainState:
    if ckpt.get("format") != FORMAT:
        raise ValueError(f"{path} is not a checkpoint of this port's trainer")
    state.model.load_state_dict(ckpt["model"], strict=True)
    state.optimizer.load_state_dict(ckpt["optimizer"])
    for s, v in zip(state.ema.shadow_params, ckpt["ema"]["shadow_params"], strict=True):
        s.copy_(v)
    state.ema.optimization_step = int(ckpt["ema"]["optimization_step"])
    state.step = int(ckpt["step"])
    _set_epoch(state, state.step)
    return state


def resume(path: str, cfg, state: TrainState) -> TrainState:
    """Resume from a reference ``.pth`` or from the port's own checkpoint,
    whichever the file holds."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    with torch.no_grad():
        if ckpt.get("format") == FORMAT:
            return _load(ckpt, state, path)
        return _import(ckpt, cfg, state)


def load_eval_state_dict(path: str, cfg):
    """The serving weights of a checkpoint of either kind, as a ``state_dict``:
    a reference ``.pth`` through ``load_torch_checkpoint`` (the EMA shadow
    overwrites the parameters; ResNet-34), or the port's own file, its EMA
    shadow over its parameters (JAX ``train.load_eval_variables``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and ckpt.get("format") == FORMAT:
        return apply_ema_shadow_params(ckpt["model"], ckpt["ema"]["shadow_params"], cfg)
    return load_torch_checkpoint(path, cfg)
