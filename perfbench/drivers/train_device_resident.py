"""Traffic kind ``train_device_resident``: the train CLI's iteration from
iteration 0, driven from the program's own pieces, on a dataset written
from the seed and held on the device.

``frames`` PNG frames and their waypoint files are written to a directory
under ``TMPDIR`` (removed at the end); the CLI's loader
(``get_loader`` under ``maybe_device_resident``) decodes them once and
gathers each batch on the device. An iteration takes the next batch, the
augmentation (``AugmentProgram``, from an augmentation generator of its
own), ``normalize_images`` and the train step (``TrainProgram`` over
``make_train_step``), to which the harness hands the step's draws: the
timesteps, the noise and the condition-keep flags, from a step generator
of its own. Both generators are seeded from the run's seed and the
iteration.

The first ``checked_steps`` iterations are set-up: they build the
programs (the first step runs eagerly and is captured, the rest replay),
and the reference follows them. More iterations follow for
``warm_seconds``, then the window runs iterations until ``--seconds``
have passed and ends in a device synchronize.
"""

from __future__ import annotations

import shutil
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from perfbench import check, inputs, trace, work
from perfbench.device import Timer, peak_bytes, release, sync
from perfbench.reference import training as ref_train
from perfbench.reference.models import build_reference
from perfbench.reference.planner import precision
from perfbench.weights import make_state_dict

__all__ = ["setup", "iterate", "reference", "run"]


def _draws(run, it: int):
    """The step's draws of iteration ``it``, on the device: timesteps,
    noise, and the keep flag of each micro-batch."""
    from autonomous_driving_with_diffusion_model_tpu_torch.train.state import StepDraws

    d, dev = run.cfgd, run.device
    B, groups = int(d["TRAIN"]["BATCH_SIZE"]), max(int(d["TRAIN"]["GRADIENT_ACCUMULATION_STEPS"]), 1)
    g = torch.Generator(device=dev).manual_seed(inputs.stream_seed(run.seed, "step", it))
    t = torch.randint(0, int(d["TRAIN"]["TIME_STEPS"]), (B,), generator=g, device=dev)
    noise = torch.randn((B, d["MODEL"]["HORIZON"], d["MODEL"]["TRANSITION_DIM"]), generator=g, device=dev)
    keep = torch.rand((groups,), generator=g, device=dev) <= float(d["TRAIN"]["USE_FREE_COND_PROB"])
    return StepDraws(t, noise, keep, None)


def _norms(leaves: dict) -> dict:
    """Each leaf's norm, in float64."""
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in leaves.items()}


def _aug_generator(run, it: int) -> torch.Generator:
    return torch.Generator().manual_seed(inputs.stream_seed(run.seed, "augment", it))


def iterate(run, st, it: int, timer: Timer = None, draws=None):
    """One iteration, as the train CLI runs it; returns the loss (on the
    device)."""
    from autonomous_driving_with_diffusion_model_tpu_torch.data import normalize_images

    try:
        batch = next(st.data_iter)
    except StopIteration:
        st.data_iter = iter(st.loader)
        batch = next(st.data_iter)
    draws = draws if draws is not None else _draws(run, it)
    batch = {k: torch.as_tensor(v).to(run.device, non_blocking=True) for k, v in batch.items()}
    images = batch["image"]
    if run.cfgd["TRAIN"]["USE_IMG_AUGMENTOR"]:
        if timer is not None:
            timer.start()
        images = st.augment(images, _aug_generator(run, it), it * int(run.cfgd["TRAIN"]["BATCH_SIZE"]))
        if timer is not None:
            timer.stop()
    batch["image"] = normalize_images(images)
    return st.step(st.state, batch, draws=draws)["loss"]


def setup(run, root: str) -> SimpleNamespace:
    """The dataset written under ``root``, the model with the seed's weights, its train
    state, the programs and the loader; then the checked iterations, with
    what the check reads of them: the weights before, AdamW's first moment
    after the first, the weights and their EMA after the last, the
    losses."""
    from autonomous_driving_with_diffusion_model_tpu_torch.data import AugmentProgram
    from autonomous_driving_with_diffusion_model_tpu_torch.data.dataset import (DeviceResidentLoader, get_loader,
                                                                                maybe_device_resident)
    from autonomous_driving_with_diffusion_model_tpu_torch.diffusion import make_schedule_from_cfg
    from autonomous_driving_with_diffusion_model_tpu_torch.models import build_model
    from autonomous_driving_with_diffusion_model_tpu_torch.ops import build, kernels
    from autonomous_driving_with_diffusion_model_tpu_torch.train.program import TrainProgram
    from autonomous_driving_with_diffusion_model_tpu_torch.train.state import create_train_state, make_train_step

    d, dev, traffic = run.cfgd, run.device, run.cell.traffic
    marks = [("start", time.perf_counter())]
    n = traffic["frames"]
    frames = inputs.frames(run.seed, n, d["TRAIN"]["IMAGE_HEIGHT"], d["TRAIN"]["IMAGE_WIDTH"], dev)
    inputs.write_dataset(root, frames, *inputs.waypoints(run.seed, n, d["MODEL"]["HORIZON"],
                                                          d["MODEL"]["TRANSITION_DIM"]))
    run.cfg.TRAIN.ROOT = root
    marks.append(("dataset_written", time.perf_counter()))
    template = build_reference(d["MODEL"], d["TRAIN"]["USE_COND"] == "FREE_GUIDANCE", "meta").state_dict()
    sd = make_state_dict(template, inputs.stream_seed(run.seed, "weights"), dev)
    sync(dev)
    marks.append(("weights", time.perf_counter()))
    model = build_model(run.cfg, device=dev, seed=0)
    model.load_state_dict(sd, strict=True)
    state = create_train_state(model, run.cfg)
    step = TrainProgram(make_train_step(make_schedule_from_cfg(run.cfg, dev), run.cfg), dev)
    marks.append(("model", time.perf_counter()))
    loader_seed = inputs.stream_seed(run.seed, "loader") % 2**31
    loader = maybe_device_resident(get_loader(run.cfg, train=True, seed=loader_seed,
                                              pin_memory=torch.device(dev).type == "cuda"), run.cfg, dev)
    if not isinstance(loader, DeviceResidentLoader):
        raise RuntimeError("the dataset did not go to the device: TPU.DEVICE_DATA or its byte budget refused it")
    marks.append(("dataset_decoded", time.perf_counter()))
    if torch.device(dev).type == "cuda":
        build.library(kernels.SOURCE)
        build.library(kernels.HEAD_SOURCE)
    marks.append(("library", time.perf_counter()))
    st = SimpleNamespace(frames=frames, sd=sd, loader=loader, loader_seed=loader_seed, state=state,
                         step=step, augment=AugmentProgram(dev), model=model)
    st.data_iter = iter(loader)
    named = dict(model.named_parameters())
    before = {k: v.detach().clone() for k, v in named.items()}
    losses, st.checked_draws = [], []
    for it in range(traffic["checked_steps"]):
        draws = _draws(run, it)
        st.checked_draws.append(draws)
        losses.append(iterate(run, st, it, draws=draws))
        if it == 0:
            # the gradient as AdamW took it; none where it took no step
            moment = {k: state.optimizer.state[p].get("exp_avg", torch.zeros_like(p)) for k, p in named.items()}
            grad = _norms({k: m / (1 - check.BETA1) for k, m in moment.items()})
    sync(dev)
    marks.append(("checked_steps", time.perf_counter()))
    st.prog = {"losses": [float(v) for v in losses], "grad": grad,
               "change": _norms({k: p.detach() - before[k] for k, p in named.items()}),
               "ema_change": _norms({k: s - before[k] for k, s in zip(named, state.ema.shadow_params)})}
    del before
    captured = step.captured()
    st.next_it = traffic["checked_steps"]
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < traffic["warm_seconds"]:
        iterate(run, st, st.next_it)
        st.next_it += 1
    sync(dev)
    marks.append(("warm_steps", time.perf_counter()))
    st.parts = {b[0]: round(b[1] - a[1], 4) for a, b in zip(marks, marks[1:])}
    st.parts.update(step_warm_s=round(getattr(captured, "warm_s", 0.0), 4),
                    step_capture_s=round(getattr(captured, "capture_s", 0.0), 4))
    return st


def _rows(seed: int, n: int, B: int, batch: int) -> np.ndarray:
    """The dataset rows of the loader's ``batch``-th batch: each epoch
    ``e`` shuffles ``arange(n)`` with ``default_rng(seed + e)`` and drops
    the last partial batch."""
    per_epoch = n // B
    perm = np.arange(n)
    np.random.default_rng(seed + batch // per_epoch).shuffle(perm)
    i = batch % per_epoch
    return perm[i * B:(i + 1) * B]


def reference(run, st, kind: str = "float32", half_batch: bool = False) -> dict:
    """The plain reference's losses, first gradient and changes over the
    checked iterations, from the same frames, waypoint files, draws and
    augmentation seeds, in ``kind`` precision; ``half_batch`` takes the
    mean over the first half of each batch only (a planted fault)."""
    d, dev = run.cfgd, run.device
    B = int(d["TRAIN"]["BATCH_SIZE"])
    model = build_reference(d["MODEL"], d["TRAIN"]["USE_COND"] == "FREE_GUIDANCE", dev)
    model.load_state_dict(st.sd, strict=True)
    params = dict(model.named_parameters())
    opt = ref_train.AdamW({k: p.detach() for k, p in params.items()})
    start = {k: p.detach().clone() for k, p in params.items()}
    shadow = {k: p.detach().clone() for k, p in params.items()}
    n = len(st.frames)
    out = {"losses": []}
    with precision(kind):
        for it, draws in enumerate(st.checked_draws):
            rows = _rows(st.loader_seed, n, B, it)
            target, trajs = ref_train.read_waypoints(run.cfg.TRAIN.ROOT, rows, dev)
            images = torch.from_numpy(st.frames[rows]).to(dev)
            if d["TRAIN"]["USE_IMG_AUGMENTOR"]:
                images = ref_train.augment(images, ref_train.augment_draws(_aug_generator(run, it), images.shape,
                                                                           it * B, dev))
            used = slice(0, B // 2 if half_batch else B)
            loss = ref_train.train_loss(model, d, images[used], trajs[used], target[used], draws.t[used],
                                        draws.noise[used], draws.keep)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()), allow_unused=True)))
            grads = {k: torch.zeros_like(params[k]) if g is None else g for k, g in grads.items()}
            ref_train.scrub_(grads)
            if it == 0:
                out["grad"] = _norms(grads)
            opt.step({k: p.detach() for k, p in params.items()}, grads,
                     ref_train.lr_at(it, d["TRAIN"]["LR"], d["TRAIN"]["LR_WARMUP"]))
            f = 1.0 - ref_train.ema_decay(it + 1, d["TRAIN"]["EMA_MAX_DECAY"], d["TRAIN"]["EMA_INV_GAMMA"],
                                          d["TRAIN"]["EMA_POWER"])
            with torch.no_grad():
                for k, p in params.items():
                    shadow[k].sub_(f * (shadow[k] - p))
            out["losses"].append(float(loss.detach()))
    out["change"] = _norms({k: p.detach() - start[k] for k, p in params.items()})
    out["ema_change"] = _norms({k: shadow[k] - start[k] for k in params})
    return out


def run(run) -> dict:
    """A run of the cell: set-up with the checked iterations, the window,
    the traced stretch where ``run.trace``, then the reference."""
    traffic, dev = run.cell.traffic, run.device
    B = int(run.cfgd["TRAIN"]["BATCH_SIZE"])
    root = tempfile.mkdtemp(prefix="perfbench_train_")
    try:
        st = setup(run, root)
        timer = Timer(dev) if run.trace else None
        losses = []
        t0 = time.perf_counter()
        setup_s = t0 - run.t_start
        while time.perf_counter() - t0 < run.seconds or not losses:
            losses.append(iterate(run, st, st.next_it, timer))
            st.next_it += 1
        sync(dev)
        window_s = time.perf_counter() - t0
        profiled = None
        if run.trace:
            def stretch():
                s0, k = time.perf_counter(), 0
                while time.perf_counter() - s0 < traffic["profile_seconds"] or k < traffic["profile_min_steps"]:
                    iterate(run, st, st.next_it)
                    st.next_it, k = st.next_it + 1, k + 1
                return k
            profiled = trace.profile(stretch, dev)
        augment_ms = timer.ms() if timer is not None else []
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        peak = peak_bytes(dev)
        for name in ("state", "step", "augment", "loader", "data_iter", "model"):
            setattr(st, name, None)  # the program's state goes before the reference runs
        release(dev)
        t_ref = time.perf_counter()
        ref = reference(run, st)
        reference_s = time.perf_counter() - t_ref
        numbers = check.train_gaps(st.prog, ref)
        rates = work.card_rates(run.device_name)
        ctx = SimpleNamespace(kind="train", cfg=run.cfgd, rates=rates, batch=B,
                              step_flops=work.train_step_flops(run.cfgd) if run.trace else None,
                              setup_s=setup_s, window_s=window_s, units=len(losses),
                              augment_ms=augment_ms, trace=profiled)
        return {"ctx": ctx, "attempted": len(losses), "failed": failed, "numbers": numbers,
                "memory_peak_bytes": peak, "setup_parts": st.parts, "reference_s": reference_s,
                "checked": len(st.checked_draws)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
