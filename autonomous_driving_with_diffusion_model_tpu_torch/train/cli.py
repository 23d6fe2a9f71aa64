"""Training CLI (counterpart of the repo root's ``train.py``; reference:
train.py:106-333), one process, or one per card under torchrun:

    python -m autonomous_driving_with_diffusion_model_tpu_torch.train \\
        --config configs/default.yaml [--max-iter N] [--generate-only] \\
        [--profile-dir DIR] [--device cpu] [--opts TRAIN.BATCH_SIZE 64 ...]
    torchrun --nproc_per_node N -m autonomous_driving_with_diffusion_model_tpu_torch.train ...

Under torchrun (its ``WORLD_SIZE`` and the rest in the environment) each
rank trains on its own card (NCCL; gloo with ``--device cpu``) at
``TRAIN.BATCH_SIZE``, feeding its shard of the dataset, so the global batch
is N x BATCH_SIZE, as under the JAX package's ``jax.distributed``; the
step's forward is wrapped in ``DistributedDataParallel``
(``parallel/ddp.py``). Logs, the tracker, checkpoints and sampling run on
rank 0; every rank holds the same weights and EMA.

It trains on the card unless ``--device cpu`` is given. The frames are
decoded on the host (``data/png.py``, in worker processes) and, with
``TPU.DEVICE_DATA``, kept on the device; augmentation (one CUDA graph
replay per iteration on the card, ``data/augment.py:AugmentProgram``) and
normalization run on the device, then the train step (``train/state.py``),
one CUDA graph replay per iteration on the card (``train/program.py``). Every ``TRAIN.SAVE_INTERVAL`` iterations
and at the end it saves ``checkpoints/checkpoint_{it}.pth`` /
``final.pth`` in the reference layout (ResNet-34), or the port's own
``.pt`` for other encoders. ``TRAIN.RESUME`` resumes from either.

Each iteration's draws are a function of the iteration alone, from two
streams (augmentation, step), so a resumed run draws what an unbroken run
would. ``evaluate`` samples with the training DDPM scheduler and paints the
plans on the BEV frame; only the painting needs ``cv2`` and ``PIL``.
"""

from __future__ import annotations

import argparse
import copy
import datetime
import glob
import logging
import os
import os.path as osp
import random
import time

import numpy as np
import torch

ROOT_SEED = 0
AUG_TAG, STEP_TAG = 1, 2


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=None, type=str)
    parser.add_argument("--generate-only", default=False, action="store_true")
    parser.add_argument("--max-iter", default=None, type=int, help="override TRAIN.MAX_ITER")
    parser.add_argument("--profile-dir", default=None, type=str,
                        help="write a torch.profiler trace of iterations 10-15 into this dir; "
                             "it carries the program's spans (step, augment and their parts)")
    parser.add_argument("--device", default=None, type=str,
                        help="torch device to train on (default: the card)")
    parser.add_argument("--opts", nargs=argparse.REMAINDER, default=None, type=str)
    return parser.parse_args(argv)


def iteration_generators(it: int, device):
    """(augmentation generator on the CPU, step generator on ``device``) of
    iteration ``it``: seeded from (ROOT_SEED, it, tag) only."""
    seed = lambda tag: int(np.random.SeedSequence([ROOT_SEED, it, tag]).generate_state(1, np.uint64)[0] >> 1)
    return (torch.Generator().manual_seed(seed(AUG_TAG)),
            torch.Generator(device=device).manual_seed(seed(STEP_TAG)))


def ema_model(state):
    """A copy of the model holding the EMA weights, in eval mode."""
    model = copy.deepcopy(state.model).eval()
    with torch.no_grad():
        for p, s in zip(model.parameters(), state.ema.shadow_params, strict=True):
            p.copy_(s)
    return model


def sample_for_eval(cfg, model, schedule, seed: int):
    """EVAL.BATCH_SIZE trajectories for one dataset frame, chosen by
    ``seed``, with the training DDPM scheduler (train.py:53-103),
    unconditioned: ((B, horizon, 2) clipped to [-1, 1], the frame's path)."""
    from ..data.augment import normalize_images
    from ..data.png import read_png
    from ..diffusion import sampler_from_cfg

    dev = model.device
    num_traj = cfg.EVAL.BATCH_SIZE
    gen = torch.Generator().manual_seed(seed)
    trajs = torch.randn((num_traj, cfg.MODEL.HORIZON, cfg.MODEL.TRANSITION_DIM), generator=gen)
    front_images = sorted(glob.glob(osp.join(cfg.TRAIN.ROOT, "front", "*.png")))
    name = random.Random(seed).choice(front_images)
    image = normalize_images(torch.from_numpy(read_png(name)).to(dev))[None].repeat(num_traj, 1, 1, 1)
    sample = sampler_from_cfg(model, schedule, cfg, for_training_eval=True)
    out = sample(trajs.to(dev), image=image, generator=gen).cpu().numpy()
    return np.clip(out[..., :2], -1.0, 1.0), name


def evaluate(cfg, model, schedule, filename=None, rng_seed=None):
    """Sample for a random dataset frame and paint the plans on its BEV png
    (reference: train.py:53-103); saved to ``filename``, else returned as a
    PIL image."""
    import cv2
    from PIL import Image

    from ..data.png import read_png
    from ..driving.plan import way_point_to_pixel
    from ..utils.constants import COLOR_LIST

    seed = rng_seed if rng_seed is not None else random.randint(0, 2**31 - 1)
    out, front = sample_for_eval(cfg, model, schedule, seed)
    bev_image = read_png(front.replace("front", "bev"))
    for color_idx, traj in enumerate(out):
        for x, y in traj:
            color = COLOR_LIST[color_idx % len(COLOR_LIST)]
            bev_image = cv2.circle(bev_image, (way_point_to_pixel(x), way_point_to_pixel(y)), 3, color, -1)
    if filename is None:
        return Image.fromarray(bev_image)
    Image.fromarray(bev_image).save(filename)
    logging.getLogger(__name__).info("Save generated samples to %s...", filename)
    return None


def save(state, cfg, name: str) -> str:
    """``checkpoints/{name}.pth`` in the reference layout (ResNet-34), else
    the port's own ``{name}.pt``."""
    from .checkpoint import export_torch_checkpoint, save_checkpoint

    base = osp.join(cfg.PROJECT_DIR, "checkpoints", name)
    if cfg.MODEL.PERCEPTION == "resnet34":
        export_torch_checkpoint(state, cfg, base + ".pth")
        return base + ".pth"
    save_checkpoint(state, base + ".pt")
    return base + ".pt"


def main(args):
    """Train as the config says; returns the final train state."""
    import torch.distributed as dist

    from ..parallel import initialize_distributed, is_main_process, local_device
    from ..utils.config import create_cfg, merge_possible_with_base, show_config
    from ..utils.device import resolve_device

    cfg = create_cfg()
    if args.config is not None:
        merge_possible_with_base(cfg, args.config)
    if args.opts:
        cfg.merge_from_list(args.opts)
    if args.max_iter is not None:
        cfg.TRAIN.MAX_ITER = args.max_iter
    if cfg.MODEL.ARCH != "temporal_map_unet":
        raise NotImplementedError(f"the train CLI trains MODEL.ARCH temporal_map_unet only: {cfg.MODEL.ARCH} "
                                  "(Diffusion Policy's CNN or RDT-1B, on an observation history) "
                                  "serves, and its training loss is not written")
    dev = resolve_device(args.device)
    owns_group = not dist.is_initialized()
    initialize_distributed(device=dev)  # torchrun's variables; one process without them
    owns_group = owns_group and dist.is_initialized()
    dev = local_device(dev)

    log = logging.getLogger(__name__)
    handlers = []
    if is_main_process():
        show_config(cfg)
        os.makedirs(osp.join(cfg.PROJECT_DIR, "checkpoints"), exist_ok=True)
        os.makedirs(osp.join(cfg.PROJECT_DIR, "generate"), exist_ok=True)
        log.setLevel(logging.INFO)
        fmt = logging.Formatter("%(asctime)s | %(levelname)s | %(message)s")
        handlers = [logging.StreamHandler(), logging.FileHandler(osp.join(cfg.PROJECT_DIR, "train.log"))]
        for h in handlers:
            h.setFormatter(fmt)
            log.addHandler(h)
    try:
        return _train(args, cfg, dev, log)
    finally:
        for h in handlers:
            log.removeHandler(h)
            h.close()
        if owns_group:
            dist.destroy_process_group()


def _train(args, cfg, dev, log):
    import torch.distributed as dist

    from ..data import AugmentProgram, get_loader, maybe_device_resident, normalize_images
    from ..data.dataset import DeviceResidentLoader
    from ..diffusion import make_schedule_from_cfg
    from ..models import build_model
    from ..models.convert import load_torchvision_backbone
    from ..parallel import data_parallel_size, is_main_process, process_count, process_index, wrap_ddp
    from ..utils.meters import AverageMeter, MetricMeter
    from ..utils.profiling import trace
    from ..utils.tracker import Tracker
    from .checkpoint import resume
    from .program import TrainProgram
    from .state import create_train_state, make_train_step

    model = build_model(cfg, device=dev, seed=ROOT_SEED)
    if cfg.TRAIN.PRETRAINED_BACKBONE:
        # the reference always starts from the torchvision ImageNet resnet34
        # (modeling/temporal.py:83); here from a file, as root train.py:168-181
        log.info("Initializing perception from ImageNet backbone %s...", cfg.TRAIN.PRETRAINED_BACKBONE)
        model.load_state_dict(load_torchvision_backbone(cfg.TRAIN.PRETRAINED_BACKBONE, model.state_dict(), cfg))
    schedule = make_schedule_from_cfg(cfg, dev)
    state = create_train_state(model, cfg)
    if cfg.TRAIN.RESUME is not None:
        if not osp.exists(cfg.TRAIN.RESUME):
            raise FileNotFoundError(f"Resume file not found: {cfg.TRAIN.RESUME}")
        log.info("Resume checkpoint from %s...", cfg.TRAIN.RESUME)
        resume(cfg.TRAIN.RESUME, cfg, state)

    main_process = is_main_process()
    if args.generate_only:
        if main_process:
            evaluate(cfg, ema_model(state), schedule, filename="test.png")
        return state

    data_parallel_size(cfg)
    if dist.is_initialized():
        wrap_ddp(state, cfg)  # every rank starts from rank 0's weights
        log.info("Data-parallel: %d rank(s) of TRAIN.BATCH_SIZE %d (%s)", state.world, cfg.TRAIN.BATCH_SIZE,
                 dist.get_backend())
    # the step as one program: a CUDA graph replayed per iteration on the card
    train_step = TrainProgram(make_train_step(schedule, cfg), dev)
    augment = AugmentProgram(dev)  # likewise the augmentation: one graph per batch shape
    loader = maybe_device_resident(
        get_loader(cfg, train=True, shard_index=process_index(), shard_count=process_count(),
                   pin_memory=dev.type == "cuda"), cfg, dev)
    if isinstance(loader, DeviceResidentLoader):
        log.info("Device-resident dataset: %d samples, %.1f MB uploaded once",
                 len(loader.dataset), loader.nbytes() / 1e6)
    tracker = Tracker(cfg.PROJECT_DIR, cfg.PROJECT_NAME, enabled=main_process)
    loss_meter, iter_time = MetricMeter(), AverageMeter()
    max_iter = cfg.TRAIN.MAX_ITER
    cur_iter = state.step
    image_iteration = cur_iter * cfg.TRAIN.BATCH_SIZE
    data_iter = iter(loader)
    start = time.time()
    profiler = None
    logged_graph = None
    while cur_iter < max_iter:
        # a steady-state window, past the warm-up iterations
        if args.profile_dir and main_process and cur_iter == 10 and profiler is None:
            profiler = trace(args.profile_dir)
            profiler.__enter__()
        if profiler is not None and cur_iter == 15:
            profiler.__exit__(None, None, None)
            profiler = None
            log.info("Saved profiler trace to %s", args.profile_dir)
        try:
            batch = next(data_iter)
        except StopIteration:
            data_iter = iter(loader)
            batch = next(data_iter)
        aug_gen, step_gen = iteration_generators(cur_iter, dev)
        batch = {k: torch.as_tensor(v).to(dev, non_blocking=True) for k, v in batch.items()}
        images = batch["image"]
        if cfg.TRAIN.USE_IMG_AUGMENTOR:
            images = augment(images, aug_gen, image_iteration)
        batch["image"] = normalize_images(images)
        metrics = train_step(state, batch, generator=step_gen)
        image_iteration += cfg.TRAIN.BATCH_SIZE
        cur_iter += 1
        captured = train_step.captured()
        if captured is not None and captured is not logged_graph and main_process:
            logged_graph = captured
            log.info("Train step captured as a CUDA graph after %d eager step(s): warm %.2f s, capture %.2f s",
                     captured.warm_steps, captured.warm_s, captured.capture_s)

        if cur_iter % cfg.TRAIN.LOG_INTERVAL == 0 and main_process:
            loss = float(metrics["loss"])  # waits for the step
            iter_time.update((time.time() - start) / cfg.TRAIN.LOG_INTERVAL)
            loss_meter.update({"loss": loss})
            eta = str(datetime.timedelta(seconds=int(iter_time.avg * (max_iter - cur_iter))))
            log.info("iter: [%d/%d]\ttime: %.3f (%.3f)\teta: %s\tlr: %.2e\t%s", cur_iter, max_iter,
                     iter_time.val, iter_time.avg, eta, metrics["lr"], loss_meter)
            tracker.log(loss_meter.get_log_dict() | {"lr": metrics["lr"]}, step=cur_iter)
            start = time.time()

        if (cur_iter % cfg.TRAIN.SAVE_INTERVAL == 0 or cur_iter == max_iter) and main_process:
            path = save(state, cfg, f"checkpoint_{cur_iter}" if cur_iter != max_iter else "final")
            log.info("Save checkpoint to %s...", path)

        if (cfg.TRAIN.SAMPLE_INTERVAL > 0 and (cur_iter % cfg.TRAIN.SAMPLE_INTERVAL == 0 or cur_iter == max_iter)
                and main_process):
            filename = osp.join(cfg.PROJECT_DIR, "generate", f"iter_{cur_iter:03d}.png")
            evaluate(cfg, ema_model(state), schedule, filename=filename)
    if profiler is not None:
        profiler.__exit__(None, None, None)
    return state


if __name__ == "__main__":
    main(parse_args())
