"""N ranks against one process: the data-parallel train step on seeded
inputs, for holding ``torch.distributed`` training to the one-process step
on the global batch.

    python -m autonomous_driving_with_diffusion_model_tpu_torch.parallel.check \\
        --rank R --world N --port P --device cpu --out DIR --cases cases.json

runs every case of ``cases.json`` (a list of {"name", "opts", "batch",
"steps"}) as rank R of N over the process group at ``localhost:P`` (gloo,
or ``--backend``), each from the seeded weights of ``build_model`` wrapped
in DistributedDataParallel, on its rows of the seeded global batch and
draws, and writes ``DIR/rank{R}.pt``: per case the losses, the first step's
(averaged) gradients and BatchNorm statistics, the final parameters and EMA
shadow. :func:`run_case` with ``world=1`` is the one-process step the
ranks are held against.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

import numpy as np
import torch

__all__ = ["case_config", "global_inputs", "run_case"]


def case_config(opts: List[str], base=None):
    """The port's config with ``base`` (a YAML path) merged, then ``opts``."""
    from ..utils.config import create_cfg, merge_possible_with_base

    cfg = create_cfg()
    if base:
        merge_possible_with_base(cfg, base)
    cfg.merge_from_list(list(opts))
    return cfg


def global_inputs(cfg, global_batch: int, steps: int, seed: int = 0):
    """(one global batch of uint8 frames, trajectories and targets, and
    ``steps`` global StepDraws), from a numpy generator of ``seed``."""
    from ..train import StepDraws

    rng = np.random.default_rng(seed)
    H, W = cfg.TRAIN.IMAGE_HEIGHT, cfg.TRAIN.IMAGE_WIDTH
    batch = {
        "image": torch.from_numpy(rng.integers(0, 256, (global_batch, H, W, 3), dtype=np.uint8)),
        "trajs": torch.from_numpy(rng.uniform(-1, 1, (global_batch, cfg.MODEL.HORIZON, cfg.MODEL.TRANSITION_DIM))
                                  .astype(np.float32)),
        "target": torch.from_numpy(rng.uniform(-1, 1, (global_batch, 2)).astype(np.float32)),
    }
    groups = max(int(cfg.TRAIN.GRADIENT_ACCUMULATION_STEPS), 1)
    draws = [StepDraws(
        torch.from_numpy(rng.integers(0, cfg.TRAIN.TIME_STEPS, global_batch)),
        torch.from_numpy(rng.standard_normal((global_batch, cfg.MODEL.HORIZON, cfg.MODEL.TRANSITION_DIM))
                         .astype(np.float32)),
        torch.from_numpy(rng.uniform(size=groups) <= 0.5)) for _ in range(steps)]
    return batch, draws


def run_case(cfg, device, local_batch: int, steps: int, rank: int = 0, world: int = 1) -> Dict:
    """``steps`` train steps of rank ``rank`` of ``world`` at ``local_batch``
    rows (world 1: one process on the whole global batch); data-parallel
    when a process group is up. The classifier variant's dropout is off,
    since masks drawn on other rows cannot match. Returns CPU tensors."""
    from ..data import normalize_images
    from ..diffusion import make_schedule_from_cfg
    from ..models import TransformerEncoderLayer, build_model
    from ..train import create_train_state, make_train_step
    from .ddp import local_rows, wrap_ddp

    dev = torch.device(device)
    model = build_model(cfg, device=dev, seed=0)
    for m in model.modules():
        if isinstance(m, TransformerEncoderLayer):
            m.dropout_rate = 0.0
    state = create_train_state(model, cfg)
    if torch.distributed.is_initialized():
        wrap_ddp(state, cfg)
    step = make_train_step(make_schedule_from_cfg(cfg, dev), cfg)
    batch, draws = global_inputs(cfg, local_batch * world, steps)
    groups = max(int(cfg.TRAIN.GRADIENT_ACCUMULATION_STEPS), 1)
    rows = local_rows(local_batch, rank, world, groups)
    local = {k: v[rows].to(dev) for k, v in batch.items()}
    local["image"] = normalize_images(local["image"])
    out = {"losses": []}
    for i, d in enumerate(draws):
        out["losses"].append(float(step(state, local, d)["loss"]))
        if i == 0:
            out["grads"] = {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}
            out["stats_first"] = {k: v.cpu().clone() for k, v in model.state_dict().items() if "running" in k}
    out["params"] = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    out["ema"] = dict(zip(out["params"], (s.detach().cpu().clone() for s in state.ema.shadow_params)))
    return out


def main(argv=None) -> None:
    from .distributed import initialize_distributed

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--backend", default=None, help="default: NCCL on CUDA, gloo on the CPU")
    ap.add_argument("--local-rank", type=int, default=None, help="the card's index (default: the rank)")
    ap.add_argument("--config", default=None, help="a YAML under the cases' opts")
    ap.add_argument("--cases", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    with open(args.cases) as f:
        cases = json.load(f)
    initialize_distributed(rank=args.rank, world_size=args.world, master_port=args.port, device=args.device,
                           backend=args.backend,
                           local_rank=args.rank if args.local_rank is None else args.local_rank)
    try:
        results = {c["name"]: run_case(case_config(c["opts"], args.config), args.device, c["batch"], c["steps"],
                                       args.rank, args.world) for c in cases}
    finally:
        torch.distributed.destroy_process_group()
    os.makedirs(args.out, exist_ok=True)
    torch.save(results, os.path.join(args.out, f"rank{args.rank}.pt"))


if __name__ == "__main__":
    main()
