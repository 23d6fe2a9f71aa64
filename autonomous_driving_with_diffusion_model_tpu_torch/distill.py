"""Progressive distillation CLI (counterpart of the repo root's ``distill.py``):
few-step planners from a trained checkpoint.

    python -m autonomous_driving_with_diffusion_model_tpu_torch.distill \\
        --checkpoint run/checkpoints/final.pth --workdir /tmp/distill \\
        --start-steps 50 --stages 6 [--device cpu] --opts TRAIN.ROOT <dataset> ...

    # then e.g. the 4-step student:
    ... --opts EVAL.CHECKPOINT /tmp/distill/student_4.pth \\
        TPU.SAMPLE_TIMESTEPS "[98, 66, 34, 2]"

It halves the DDIM grid stage by stage (``diffusion/distill.py``) from the
teacher's serving weights (a reference ``.pth``, or the port's own
checkpoint for another encoder), on the card unless ``--device cpu`` is
given. Each stage writes ``student_{n}.pth`` (the port's own
``student_{n}.pt`` for encoders other than ResNet-34): the student's EMA as
both the parameters and the EMA shadow, fresh AdamW moments, ``iter`` the
stage's iterations. ``distill.json`` records each stage's grid; the next
stage distills from the deployed (EMA) student. The frames come from
``get_loader``, device-resident under ``TPU.DEVICE_DATA``, normalized,
without augmentation.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import os.path as osp
import time

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=None)
    ap.add_argument("--checkpoint", required=True, help="teacher .pth, or the port's own checkpoint")
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--start-steps", type=int, default=None,
                    help="teacher grid size (default: cfg.EVAL.SAMPLE_STEPS)")
    ap.add_argument("--stages", type=int, default=6, help="halvings to run (stops at 1 step)")
    ap.add_argument("--iters", type=int, default=300, help="train iterations per stage")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--snr-weight", action="store_true",
                    help="truncated-SNR loss weight max(a_t/(1-a_t), 1)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, type=str, help="torch device (default: the card)")
    ap.add_argument("--opts", nargs=argparse.REMAINDER, default=None)
    return ap.parse_args(argv)


def iteration_generator(seed: int, it: int, device):
    """The draws of iteration ``it``: a generator on ``device`` seeded from
    (seed, it) only."""
    state = int(np.random.SeedSequence([seed, it]).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=device).manual_seed(state)


def export_student(student, ema, step: int, cfg, workdir: str, n_steps: int, lr: float):
    """The deployed student (its EMA weights) and its checkpoint path."""
    from .train import EmaState, create_train_state, export_torch_checkpoint, save_checkpoint

    deployed = copy.deepcopy(student)
    with torch.no_grad():
        for p, s in zip(deployed.parameters(), ema.shadow_params, strict=True):
            p.copy_(s)
    for m in deployed.modules():
        m.__dict__.pop("_kernel_params", None)
    deployed.requires_grad_(False).eval()
    # fresh AdamW moments: the stage's describe the raw iterates, not the EMA
    state = create_train_state(deployed, cfg)
    state.ema = EmaState([s.detach().clone() for s in ema.shadow_params], step)
    state.step = step
    if cfg.MODEL.PERCEPTION == "resnet34":
        path = osp.join(workdir, f"student_{n_steps}.pth")
        export_torch_checkpoint(state, cfg, path, base_lr=lr)
    else:  # the reference layout exists for ResNet-34 only
        path = osp.join(workdir, f"student_{n_steps}.pt")
        save_checkpoint(state, path)
    return deployed, path


def main(args):
    """Distill as ``args`` say; returns the manifest written to distill.json."""
    from .data import get_loader, maybe_device_resident, normalize_images
    from .diffusion import StepConfig, grid_chain, make_distill_step, make_schedule_from_cfg
    from .models import build_model
    from .train import load_eval_state_dict
    from .utils.config import create_cfg, merge_possible_with_base
    from .utils.constants import GuidanceType
    from .utils.device import resolve_device

    cfg = create_cfg()
    if args.config is not None:
        merge_possible_with_base(cfg, args.config)
    if args.opts:
        cfg.merge_from_list(args.opts)
    dev = resolve_device(args.device)
    os.makedirs(args.workdir, exist_ok=True)

    schedule = make_schedule_from_cfg(cfg, dev)
    use_cond = GuidanceType[cfg.TRAIN.USE_COND]
    teacher = build_model(cfg, device=dev, seed=args.seed)
    teacher.load_state_dict(load_eval_state_dict(str(args.checkpoint), cfg), strict=True)
    teacher.requires_grad_(False)

    loader = maybe_device_resident(
        get_loader(cfg, train=True, seed=args.seed, shard_index=0, shard_count=1), cfg, dev)
    start_steps = args.start_steps or int(cfg.EVAL.SAMPLE_STEPS)
    grids = grid_chain(schedule.num_train_timesteps, start_steps, args.stages)
    print(f"[distill] teacher @ {start_steps} steps -> stages {[len(g.ts) for g in grids]}", flush=True)

    manifest = {
        "teacher_checkpoint": str(args.checkpoint),
        "start_steps": start_steps,
        "iters_per_stage": args.iters,
        "lr": args.lr,
        "snr_weight": bool(args.snr_weight),
        "use_cond": cfg.TRAIN.USE_COND,
        "free_scale": float(cfg.GUIDANCE.FREE_SCALE),
        "stages": [],
    }
    data_iter = iter(loader)

    def next_batch():
        nonlocal data_iter
        try:
            batch = next(data_iter)
        except StopIteration:
            data_iter = iter(loader)
            batch = next(data_iter)
        batch = {k: torch.as_tensor(v).to(dev, non_blocking=True) for k, v in batch.items()}
        batch["image"] = normalize_images(batch["image"])
        return batch

    for g in grids:
        n_steps = len(g.ts)
        t0 = time.time()
        init_state, step = make_distill_step(
            schedule, g, use_cond=use_cond, free_scale=float(cfg.GUIDANCE.FREE_SCALE),
            # the config's prediction type: an epsilon-trained teacher meets the x0-only guard
            step_cfg=StepConfig(prediction_type=cfg.TRAIN.NOISE_SCHEDULER.PRED_TYPE, clip_sample=True),
            lr=args.lr, warmup=args.warmup, snr_weight=args.snr_weight,
            # cosine to 0 over the stage; the student's EMA is deployed
            decay_steps=args.iters,
        )
        state = init_state(teacher)
        metrics = None
        for it in range(args.iters):
            metrics = step(state, teacher, next_batch(), generator=iteration_generator(args.seed, it, dev))
            if (it + 1) % max(1, args.iters // 5) == 0:
                print(f"[distill] {n_steps}-step stage iter {it + 1}/{args.iters} "
                      f"loss {float(metrics['loss']):.5f}", flush=True)
        loss = float(metrics["loss"]) if metrics is not None else float("nan")
        teacher, out_path = export_student(state.student, state.ema, state.step, cfg, args.workdir,
                                           n_steps, args.lr)
        del state
        stage_info = {
            "num_steps": n_steps,
            "timesteps": [int(t) for t in g.ts],
            "checkpoint": out_path,
            "final_loss": loss,
            "seconds": round(time.time() - t0, 1),
        }
        manifest["stages"].append(stage_info)
        print(f"[distill] stage done: {stage_info}", flush=True)

    with open(osp.join(args.workdir, "distill.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    print(f"[distill] manifest: {osp.join(args.workdir, 'distill.json')}", flush=True)
    # a CFG student has the guidance scale baked in: deploy it at FREE_SCALE
    # 1.0, where the sampler skips the unconditional pass
    baked = " GUIDANCE.FREE_SCALE 1.0" if use_cond == GuidanceType.FREE_GUIDANCE else ""
    for s in manifest["stages"]:
        print(f"[distill] deploy {s['num_steps']}-step: --opts EVAL.CHECKPOINT {s['checkpoint']} "
              f"TPU.SAMPLE_TIMESTEPS \"{s['timesteps']}\"{baked}", flush=True)
    return manifest


if __name__ == "__main__":
    main(parse_args())
