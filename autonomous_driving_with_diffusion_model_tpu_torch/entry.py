"""Entry points (counterpart of the repo root's ``__graft_entry__.py``):
the flagship forward on one card, and a multi-card dry run.

    python -c "from autonomous_driving_with_diffusion_model_tpu_torch.entry import entry; f, a = entry(); f(*a)"
    python -c "from autonomous_driving_with_diffusion_model_tpu_torch.entry import dryrun_multichip; dryrun_multichip(4)"

Both run on the card unless ``device="cpu"`` is given. ``dryrun_multichip``
starts one process per card (NCCL), or per gloo rank on the CPU, the
counterpart of the JAX package's virtual CPU mesh. The JAX dry run's phase 3
(a multislice mesh) has no counterpart: NCCL under torchrun spans nodes as
it spans cards (``parallel/ddp.py``).
"""

from __future__ import annotations

import os
import socket
import tempfile
import time

import numpy as np

__all__ = ["entry", "dryrun_multichip"]


def entry(device=None):
    """(fn, example_args): the forward of the flagship model, the closed-loop
    planner's denoiser: the full-size U-Net (``MODEL.DIM`` 64, dims
    64 x (1, 2, 4, 8)) with ResNet-34 perception on a 900x256 frame, seeded
    random weights, on ``device`` (None: the card)."""
    import torch

    from .models import build_model
    from .utils.config import create_cfg
    from .utils.device import resolve_device

    dev = resolve_device(device)
    cfg = create_cfg()
    model = build_model(cfg, device=dev, seed=0).eval()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 16, 7)).astype(np.float32)).to(dev)
    img = torch.from_numpy(rng.standard_normal((1, 256, 900, 3)).astype(np.float32)).to(dev)
    t = torch.tensor([5.0], device=dev)

    def fn(model, x, img, t):
        with torch.no_grad():
            return model(x, img=img, time=t)

    return fn, (model, x, img, t)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(rank: int, n: int, port: int, device_type: str, budget_s: float, t0: float) -> None:
    """One rank of :func:`dryrun_multichip`; rank 0 prints."""
    import torch
    import torch.distributed as dist

    from .data import normalize_images
    from .diffusion import make_schedule_from_cfg
    from .models import build_model
    from .parallel import initialize_distributed, local_device, wrap_ddp
    from .parallel.check import global_inputs
    from .parallel.ddp import local_rows
    from .train import create_train_state, load_checkpoint, make_train_step, save_checkpoint
    from .utils.config import create_cfg

    def check(ok, msg):
        if not ok:  # raised, so that the dry run checks under python -O too
            raise RuntimeError(f"dryrun_multichip({n}) rank {rank}: {msg}")

    def say(msg):
        if rank == 0:
            print(f"dryrun_multichip({n}) [{time.time() - t0:5.1f}s] {msg}", flush=True)

    def room_for(phase, est_s):
        """Whether every rank has ``est_s`` left of the budget (rank 0 decides)."""
        left = torch.tensor([budget_s - (time.time() - t0)], device=dev)
        dist.broadcast(left, 0)
        if float(left) < est_s:
            say(f"SKIP {phase}: {float(left):.0f}s left < {est_s:.0f}s estimate "
                f"(budget ADM_DRYRUN_BUDGET_S={budget_s:.0f}); covered by tests/")
            return False
        return True

    if device_type == "cpu":
        torch.set_num_threads(1)
    initialize_distributed(rank=rank, world_size=n, local_rank=rank, master_port=port, device=device_type)
    dev = local_device(device_type)
    try:
        # phase 0: an n-rank all-reduce, before the big model
        probe = torch.tensor([float(rank)], device=dev)
        dist.all_reduce(probe)
        expect = n * (n - 1) / 2
        check(float(probe) == expect, f"all-reduce gave {float(probe)}, expected {expect}")
        say(f"phase 0: {n}-rank all-reduce over {dist.get_backend()} ok")

        # phase 1: the flagship DIM-64 + ResNet-34 train step under DDP, on
        # a 48x64 frame at 1 sample per rank (the full conv stack and
        # parameter tree; the frame shrunk)
        cfg = create_cfg()
        cfg.MODEL.DIM = 64
        cfg.TRAIN.USE_COND = "FREE_GUIDANCE"  # the conditioned path
        cfg.TRAIN.TIME_STEPS = 10
        cfg.TRAIN.SAMPLE_STEPS = 10
        cfg.TRAIN.IMAGE_HEIGHT, cfg.TRAIN.IMAGE_WIDTH = 48, 64
        say("phase 1: building flagship DIM=64 resnet34 ...")
        state = create_train_state(build_model(cfg, device=dev, seed=0), cfg)
        n_params = sum(p.numel() for p in state.model.parameters())
        wrap_ddp(state, cfg)
        step = make_train_step(make_schedule_from_cfg(cfg, dev), cfg)
        batch, draws = global_inputs(cfg, n, 2)
        local = {k: v[local_rows(1, rank, n)].to(dev) for k, v in batch.items()}
        local["image"] = normalize_images(local["image"])
        say("phase 1: running flagship fwd+bwd train step ...")
        loss = float(step(state, local, draws[0])["loss"])
        check(np.isfinite(loss) and state.step == 1, f"loss {loss} at step {state.step}")
        say(f"phase 1: flagship DIM=64 resnet34 ({n_params / 1e6:.1f}M params) loss={loss:.4f} ok")

        # phase 2: the port's checkpoint save -> restore -> one-step resume
        if room_for("phase 2 (checkpoint save/restore/resume)", 150.0):
            path = os.path.join(tempfile.gettempdir(), f"adm_dryrun_ckpt_{port}.pt")
            if rank == 0:
                save_checkpoint(state, path)
            dist.barrier()
            restored = create_train_state(build_model(cfg, device=dev, seed=1), cfg)
            load_checkpoint(path, restored)
            same = all(torch.equal(a, b) for a, b in zip(state.model.parameters(), restored.model.parameters()))
            check(same and restored.step == 1, "the checkpoint's restore changed the parameters or the step")
            say("phase 2: restored params match; resuming one step ...")
            wrap_ddp(restored, cfg)
            loss2 = float(step(restored, local, draws[1])["loss"])
            check(restored.step == 2 and np.isfinite(loss2), f"resumed loss {loss2} at step {restored.step}")
            dist.barrier()
            if rank == 0:
                os.remove(path)
            say("phase 2: checkpoint save/restore/resume ok")
        say("done")
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The flagship-width training step over ``n_devices`` data-parallel
    ranks: phase 0 an all-reduce probe, phase 1 the DIM-64 ResNet-34 step
    under DistributedDataParallel, phase 2 (if ADM_DRYRUN_BUDGET_S, default
    420, leaves room) the port's checkpoint save, restore and one-step
    resume. Every phase prints an elapsed-stamped line. NCCL over
    ``n_devices`` cards (fewer raise), or ``n_devices`` gloo ranks with
    ``device="cpu"``."""
    import torch
    import torch.multiprocessing as mp

    from .utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs {n_devices} cards, "
                           f"{torch.cuda.device_count()} visible")
    budget_s = float(os.environ.get("ADM_DRYRUN_BUDGET_S", "420"))
    mp.spawn(_rank, args=(n_devices, _free_port(), dev.type, budget_s, time.time()), nprocs=n_devices,
             join=True)
