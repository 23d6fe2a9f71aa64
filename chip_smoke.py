#!/usr/bin/env python3
"""Drives the PyTorch port of the planner on one NVIDIA GPU and checks it.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no result line):

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: the CUDA kernels from ``ops/csrc`` with nvcc (ptxas summary);
3. kernels against their plain PyTorch versions at every shape the
   planner's U-Net gives them, batch 1 and 2, float32 and bfloat16;
4. the path: ``DiffusionPlanner`` on the card at full width (ResNet-34 at
   900x256, MODEL.DIM 64, random weights from a seed) for the default,
   classifier-free and classifier guidance configs. Every plan of the
   planner on the card, here and in phases 6, 7, 9, 11 and 12, replays the
   CUDA graph of its key (``driving/program.py``). Launch counts show the
   kernels on the path; the first plan is held against the same planner on
   the CPU; plan latency p50 and peak memory are printed;
5. kernel time by CUDA events beside the plain version's, the bound and the
   launch floor (the device time of an empty kernel launched the same way),
   with each launch's geometry; each residual block's time at every cluster
   size the geometry can pick; the forward's residual calls at batch 16 and
   32 on the folded path against the multi-wave code, the plain version and
   the bound, with their launches by path (under ``folded``);
6. the agents, through the port's own entry points, at the same width: per
   config, an ``InteractAgent`` on the card and one on the CPU over the
   recorded frames of ``tests/fixtures/replay_town01.npz`` in lockstep
   (launches per tick, plans within PLAN_TOL, raw controls within
   CONTROL_TOL), tick latency p50/p90 on ``FakeDrivingEnv`` at 900x256,
   sequential and pipelined in turns, and one profiled tick; the 2-dim
   waypoint model (its Cin = 2 block held against the plain version) through
   the PID controller; the leaderboard ``DiffusionAgent`` loaded from its file as
   the harness loads it; and ``evaluate_cli --fake-env``, which must write
   one ``Completed`` record. Each path runs with the launch counts set to 0
   just before and read just after, and fails if a kernel was not launched;
7. the rest of the serving path, at the same width: DDPM-100; DPM-Solver++
   2M at 10 steps in bfloat16; bfloat16 on each of the three configs (the
   bf16-vs-fp32 plan gap on the card beside it); K = 8 hypotheses with the
   learned scorer; a ResNet-50 encoder, and one encode of every ResNet on the
   card against the CPU; inpainting DDIM and DDPM (10 steps) through
   ``make_sampler`` with the first waypoints pinned. Per path: launch counts (reset before the
   first plan, read after it, 16 / 1 per forward), the GPU plan against the
   CPU plan of the same seed (PLAN_TOL, or BF16_PLAN_TOL), plan p50 over 5
   plans, peak memory and the device-busy share;
8. training: each kernel's ``autograd.Function`` at every main-path shape at
   B = 2 and 32 (forward against the plain forward, every input's gradient
   against autograd of the plain version, GRAD_TOL), and both kernels' device
   time at B = 32 with the recompute backward's; three full-width training
   steps at B = 2 on the card against the CPU (the same weights, batch and
   draws, BatchNorm frozen and train: the first-step gradients per tensor,
   each check shown to catch a planted fault; each tensor's update and EMA
   by norm; losses; the first step's BatchNorm statistics); the timed step
   (through ``train/program.py:TrainProgram``, one CUDA graph replay a step,
   as the train CLI steps) at TRAIN.BATCH_SIZE 32 from a
   dataset of 64 900x256 frames that the script writes under ``build/``
   with the port's PNG writer, through the loader, the augmentation and the
   step: device-resident with BN_MODE frozen and train (and frozen with
   REMAT), and through the host loader decoding every batch in its decoder
   processes into pinned batches (frames of Sub rows, and of Paeth rows;
   its p50 beside the device-resident step's): step p50, samples/s, peak
   memory (from the program's build, whose capture allocates the graph's
   pool), launches per step (16 / 1 per forward, doubled under REMAT), one
   profiled step; the host's decode ms per frame on 4 threads against 4
   and 8 decoder processes, Sub and Paeth rows; the augmentation alone at B = 32
   and 64 (``AugmentProgram``'s CUDA graph against its eager body on the
   same draws, bit-identical, and against the row-gathering path it
   replaced; host ms of each in turns, the replay's device ms, kernels per
   replay); and the train CLI, 4 iterations saving at 2, then resumed from
   ``checkpoint_2.pth``. Float32 is float32 throughout: ``build_model``
   turns TF32 off on the card, and the script checks that it did;
9. distillation: one distill step on the card against the CPU at B = 2
   (loss; the student's first-step gradients by phase 8's rule, each check
   shown to catch a planted fault); the timed distill step (one CUDA graph
   replay a step, as the distill CLI steps) at
   TRAIN.BATCH_SIZE 32 from the 64 frames device-resident, without guidance
   and under CFG (p50, samples/s, peak memory from the build, one profiled step, launches
   per step: 48 / 3 and 80 / 5, the teacher's forwards without a gradient
   and the student's with one); the distill CLI from a teacher ``.pth``
   (100 -> 50 -> 25 steps, 3 iterations a stage); the 25-step student
   through ``DiffusionPlanner`` on its recorded grid, GPU plan against CPU
   plan (PLAN_TOL) and its plan p50; and the learned scorer's fit (N = 512
   sets of K = 8) on the card against the CPU from the same weights, and
   the time of the default 3000-step fit;
10. data parallelism: the train CLI under ``torchrun --nproc_per_node 1``
   on NCCL (3 iterations, rank 0's ``final.pth``), its encoder started
   from a torchvision ResNet-34 ``.pth`` the phase writes
   (``TRAIN.PRETRAINED_BACKBONE``), and one iteration of the CLI in this
   process from it, after which the encoder on the card is the file's; two ranks on the one card
   over gloo at TRAIN.BATCH_SIZE 16 each (``parallel/check.py``) against this
   process's step at 32 on the same global batch and draws, BatchNorm
   frozen and train: the ranks identical, the loss and first-step gradients
   within phase 8's tolerances, the BatchNorm statistics of the global
   batch. Each subprocess has a timeout;
11. the CARLA env layer, over ``tests/mock_carla.py`` installed as
   ``carla`` (a client API over a one-road town): per config an
   ``InteractAgent`` on the card drives ``sim/carla_env.py:CarlaDrivingEnv``
   through a route with a red light, 3 walkers and a scenario vehicle (tick
   p50/p90 and the env's step time over 20 ticks, in turns with 20 ticks of
   the same planner on ``FakeDrivingEnv``; launches per tick, one
   profiled tick, the counters and the stats so far; under CFG a CPU agent
   shadows 10 ticks from the same observations, plans within PLAN_TOL and raw
   controls within CONTROL_TOL); ``evaluate_cli`` without ``--fake-env``,
   which must write one "carla" record whose route length is the env's; the
   collector writing 8 samples from the env under the expert with the port's
   PNG writer, ``data/validate.py`` reading them clean, and one training step
   at B = 8 from them with a finite loss;
12. the learnability harness (``learnability.py``) at full width, bfloat16,
   BatchNorm frozen: its synthetic dataset (120 frames by the port's PNG
   writer, 24 held-out samples); one bf16 training step at B = 2 on the
   card against the CPU's fp32 and bf16 steps from the same weights, batch
   and draws (the card's loss and gradients within 2x the CPU's own
   bf16-vs-fp32 gap: the first card check of bf16 training through the
   kernels' ``Recompute``); its ``train`` (the train CLI) at B = 64 for 20
   iterations (the CLI's meter: step p50, samples/s; peak memory; 16 / 1
   launches per step; one profiled step); its ``evaluate`` from that
   checkpoint at 40 straight and 60 curved ticks (160 / 10 launches per
   DDIM-10 plan, the 24 held-out plans within BF16_PLAN_TOL of a CPU
   planner's); its ``distill`` 8 -> 4 -> 2 at 3 iterations a stage and the
   2-step student's plans;
13. the compiled plan: for phase 4's three configs, phase 7's planner paths,
   HOIST_PERCEPTION off and a CFG student's key (FREE_SCALE 1.0, a distilled
   2-step grid, bfloat16; also against the CPU planner within the bf16
   bound), the CUDA graph's plan against the eager body it
   captures (1e-5 m in float32, bit-identical expected; the bf16 bound in
   bfloat16), the first plan's launch counts (one replay) and the counts
   the capture recorded, the warm and capture seconds, eager and graph plan
   p50 in turns, the peak memory of each, and one profiled replay (busy
   share; its kernels counted by the profiler against the recorded counts);
   then a capture on a worker thread replayed on the main thread;
14. the training-side programs (``train/program.py``): the train step at
   B = 32 in float32 (BN frozen, BN train, REMAT) and at B = 64 in bfloat16,
   the distill step at B = 32 (default and CFG) and the scorer's 3000-step
   fit, each against its eager step from the same state and draws in turns
   (bit-identical; launches per replay equal to the eager step's and to the
   capture's record; the profiler's count of one replay's kernels equal to
   the record; step p50 of both, warm and capture seconds, peak memory,
   busy shares), then a plan and a sample after replayed steps against a
   fresh model loaded with the trained weights;
15. Diffusion Policy's CNN (``MODEL.ARCH conditional_unet1d``) at its
   published widths: the 12 FiLM residual-block calls of one batch-1
   forward (10 distinct geometries, Cin up to 4096, C up to 2048) and the
   512-wide head, each against its plain version at KERNEL_TOL's float32
   tolerance, launched as the blocks launch them; the launches by path and
   FiLM counted from that pass, the counts zeroed just before; each call's
   device time beside the plain version's and its bound, and the forward's
   calls in one graph against the summed bound and the card's bandwidth.

The last two lines of standard output are the card (nvidia-smi) and the
kernels as JSON, then ``{"ok": true, "device": ...}``. Per-shape numbers and
phase 6's results (under ``agents``), phase 11's (under ``carla``), phase
12's (under ``learnability``), phase 13's (under ``compiled_plan``) and
phase 14's (under ``compiled_train``) and phase 15's (under ``film``) go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "autonomous_driving_with_diffusion_model_tpu_torch"
CONFIGS = ("configs/default.yaml", "configs/guidance/free_guidance.yaml",
           "configs/guidance/classifier_guidance.yaml")
# phase 15: Diffusion Policy's CNN at its published widths (down_dims 512,
# 1024, 2048; perfbench/configs/diffusion_policy_cnn.json)
FILM_OPTS = ("MODEL.ARCH", "conditional_unet1d", "MODEL.DIM", "512", "MODEL.DIM_MULTS", "[1, 2, 4]",
             "MODEL.PERCEPTION", "resnet18_gn_keypoints")
KERNEL_TOL = {
    # fp32: the conv sums up to 5 * 4096 products in another order than cuDNN
    "float32": dict(atol=1e-4, rtol=1e-4),
    # bf16: same bf16 inputs and fp32 math on both sides; the outputs may
    # round to neighbouring bf16 values (2^-8 relative), twice over
    "bfloat16": dict(atol=3e-2, rtol=1.6e-2),
}
# GPU plan vs CPU plan, in meters: 2 to 100 DDIM steps of float32 math whose
# sums run in other orders on the two devices
PLAN_TOL = dict(atol=5e-3, rtol=1e-3)
# GPU vs CPU raw controls traj[0, 0, -3:]: PLAN_TOL's 5e-3 m over the 23.3 m
# that scales xy (the controls are not scaled)
CONTROL_TOL = 2.5e-4
# GPU vs CPU plan of a bfloat16 model, in meters: both round to bf16 at the
# same places, but the card and the CPU sum in other orders and can flip a
# rounding; one bf16 ulp of a value in [0.5, 1) is 2^-8 x 23.3 m = 0.09 m.
# 1 m is 11 such ulps, a fifth of the JAX package's own bf16-vs-fp32 bound
# (0.2 x 23.3 m, tests/test_bf16.py:31). Dual-batch CFG multiplies a flip in
# the U-Net's output by up to 1 + 2 * FREE_SCALE, and the tolerance with it
BF16_PLAN_TOL = dict(atol=1.0, rtol=0.0)
# GPU vs CPU encode of a ResNet at 900x256, over the CPU feature's largest
# value: up to 155 fp32 convolutions that cuDNN sums in other orders
ENCODE_TOL = 1e-3
# the graph's plan against the eager body's on the card, in meters: the
# same kernels on the same inputs in the same order, so float32 plans are
# expected bit-identical; 1e-5 m bounds them (bfloat16: plan_tol's bound)
GRAPH_TOL = 1e-5
PLAN_REPS = 5  # phase 13: eager and graph plans, in turns
NCCL_ITERS = 13  # phase 10: the train CLI on one NCCL rank, past DDP's 11 eager steps to two replays
TRAIN_REPS = 5  # phase 14: eager and graph steps, in turns, after the first of each
SCORER_STEPS = 3000  # phase 14: train_scorer's default fit
# phase 13: profiles of one replay taken at most, until one counts the
# port's kernels as the capture recorded them. The profiler loses some
# kernel records of the largest graph's replay (HOIST_PERCEPTION off at
# K = 8), a different share in each profile, with CUPTI reporting none
# dropped. A replay launches the same nodes every time, so a profile that
# counts fewer is retaken; one that counts more fails at once
PROFILE_TRIES = 8
INPAINT_KNOWN = 4  # the waypoints an inpainting path pins, from the first
# denoising steps of an inpainting path: the default config's 100 cut to 10,
# which keeps the whole script near half its time limit
INPAINT_STEPS = 10
# an autograd.Function's input gradient against autograd of the plain
# version, over the gradient's largest value: the backward IS the plain
# version's, at the same inputs, so they differ only by cuDNN's choice of
# algorithm for the two calls
GRAD_TOL = 1e-4
# GPU vs CPU training (phase 8), full width, B = 2, float32 (build_model
# turns TF32 off), BatchNorm frozen and in train mode. The first step (its
# LR is 0, so both sides hold the same weights) compares the gradient of
# every tensor outside the encoder to STEP_GRAD_TOL of that tensor's
# largest CPU value plus STEP_GRAD_FLOOR, the size of float32 rounding noise
# in a gradient whose exact value is 0, as the CPU tests hold the port to
# JAX. The encoder's are held by each tensor's norm to ENCODER_GRAD_RTOL:
# the two devices' forwards differ by float32 rounding, which flips ReLU
# and max-pool decisions at elements next to a tie, and each flip moves a
# weight gradient at once (on the card under frozen: 3.7e-4 of the
# encoder's norm, 4.2e-3 of the worst tensor's, conv1; the same with
# PyTorch's own CUDA convolutions in place of cuDNN's). Both checks are shown to
# catch a planted fault (a U-Net block's gradient zeroed, the encoder's
# first weight's scaled by 1 + 5e-2). Under BatchNorm train the encoder's
# gradient passes each BatchNorm as the deviation of each frame's upstream
# gradient from the batch mean, small against each, so any other summation
# order moves it far more (on the card: 8.8e-3 of the encoder's norm, 24
# times its distance under frozen): it is reported, and its BatchNorm
# statistics are compared. After three steps
# the update of each tensor outside the encoder (final minus initial
# weights, and the EMA shadow's) is compared by norm over the elements
# whose first gradient is not near 0 (below NOISE_GRAD or 1e-3 of the
# tensor's largest), to UPDATE_RTOL of the CPU update's norm, as the CPU
# tests do; every element stays within Adam's bound, PARAM_TOL x the LRs
# summed (an update is at most 1.0 LR in its first steps whatever the
# gradient: |m_hat| / sqrt(v_hat) <= sqrt(sum a_i^2 / c_i) = 1.0 for b1 =
# 0.95, b2 = 0.999), which holds the encoder's. The loss: float32 sums in
# other orders, relative. The first step's BatchNorm statistics, at the
# same weights, relative to 1 + |value|
STEP_GRAD_TOL = 1e-4
STEP_GRAD_FLOOR = 1e-7
ENCODER_GRAD_RTOL = 1e-2
NOISE_GRAD = 1e-6
UPDATE_RTOL = 1e-3
PARAM_TOL = 2.0
LOSS_RTOL = 1e-4
STAT_TOL = 1e-4
TRAIN_FRAMES = 64
NUM_WORKERS = 4  # TRAIN.NUM_WORKERS: the host loader's decoders
AUG_REPS = 10  # phase 8: augmentation calls of each path, in turns
AUG_TOL = 1e-3  # [0, 255]: the row-gathering path against the branch-free body (the same ops on the same draws)
REPLAY = os.path.join("tests", "fixtures", "replay_town01.npz")
LATENCY_TICKS = 20
DISTILL_START = 100  # the default config's DDIM-100 teacher grid
DISTILL_ITERS = 3
SCORER_N, SCORER_K = 512, 8
SCORER_CHECK_STEPS = 200
# the scorer fit, GPU against CPU from the same initial weights: 200
# full-batch AdamW steps of float32 sums in other orders; each tensor's
# parameters to 1e-3 of its largest move plus 1e-7, the validation MSE to
# 1e-3 relative (the CPU tests hold the port's fit to JAX's at 1e-4 after 50)
SCORER_PARAM_RTOL = 1e-3
SCORER_MSE_RTOL = 1e-3
DDP_WORLD = 2
SUBPROCESS_TIMEOUT_S = 300
SHADOW_TICKS = 10  # phase 11: CFG ticks a CPU agent shadows
EVAL_STEPS = 20  # phase 11: evaluate_cli's steps on the native env
COLLECT_SAMPLES = 8  # phase 11: samples collected, and the training batch
# phase 12, the learnability harness at full width: the train CLI's
# iterations at LEARN_BATCH, the closed loops' ticks (straight, curved),
# the distill chain 8 -> 4 -> 2 at 3 iterations a stage
LEARN_ITERS = 20
LEARN_BATCH = 64
LEARN_TICKS = (40, 60)
LEARN_DISTILL = dict(start=8, stages=2, iters=3)
# the bf16 step on the card against the CPU's (phase 12): its loss and
# gradients within 2x the CPU's own bf16-vs-fp32 gap of the fp32 step, plus
# one bf16 ulp of a loss near 0.5 and 1e-3 of the gradient's norm, the
# bound tests/test_torch_train_variants.py holds the CPU's bf16 step to
BF16_STEP_GAP = 2.0
BF16_LOSS_SLACK = 2e-3
BF16_GRAD_SLACK = 1e-3
REPLACES = {
    "fused_residual_block": "autonomous_driving_with_diffusion_model_tpu/ops/pallas_kernels.py:106",
    "fused_conv1d_gn_mish": "autonomous_driving_with_diffusion_model_tpu/ops/pallas_kernels.py:206",
}


def log(*a):
    print(*a, flush=True)


def replay_observations(path):
    """The recorded Town01 frames of ``tests/fixtures/replay_town01.npz`` as
    observation dicts, built as ``tests/test_replay_env.py`` builds them."""
    import numpy as np

    data = np.load(path)
    route, obs = data["route"], []
    for i in range(len(data["frames"])):
        pos = data["pos"][i]
        ahead = np.where(np.linalg.norm(route - pos[None], axis=-1) > 4.0)[0]
        obs.append({
            "camera": [data["frames"][i]],
            "bev": [data["bevs"][i]],
            "compass": [[0.0]],
            "cur_waypoint": np.asarray([pos]),
            "next_waypoint": np.asarray([route[ahead[0]] if len(ahead) else route[-1]]),
            "next_command": [4],
            "state": [[0.0, float(data["speed"][i]), 0.5, 0.0, 0.0]],
            "at_red_light": [0],
        })
    return obs


def near_threshold(raw, tol: float) -> bool:
    """Whether the interact post-processing may rightly branch otherwise on
    two devices: the raw brake within ``tol`` of 0.05 or 0.5, or of the raw
    throttle (``driving/plan.py:post_process_control_interact``)."""
    throttle, _, brake = (float(v) for v in raw)
    return min(abs(brake - 0.05), abs(brake - 0.5), abs(throttle - brake)) <= tol


def counted(launches, run):
    """run() with every launch count set to 0 just before and read just
    after; the counts are added to ``launches``, which gathers them for the
    kernels line. Fails if a kernel of the path was not launched."""
    import torch

    from autonomous_driving_with_diffusion_model_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    result = run()
    torch.cuda.synchronize()
    got = {k: getattr(kernels, k).launches for k in launches}
    for k in launches:
        launches[k] += got[k]
    if not all(got.values()):
        raise AssertionError(f"a kernel of the path was not launched: {got}")
    return result, got

def wrapper_calls(counts: dict) -> dict:
    """The wrappers' call counts of a ``kernels.launch_counts()`` dict, its
    counts of the residual block's launches by path left out."""
    from autonomous_driving_with_diffusion_model_tpu_torch.ops import kernels

    return {k: counts[k] for k in kernels.WRAPPERS}


def card_rates(name: str):
    """(bytes/s, float32 FLOP/s, dense bf16 FLOP/s) from the data sheet of
    the named part."""
    if "PCIe" in name:
        return 2.0e12, 51e12, 756e12
    if "NVL" in name:
        return 3.9e12, 60e12, 835e12
    return 3.35e12, 67e12, 989e12  # H100 SXM


def device_breakdown(run) -> dict:
    """One run under torch.profiler: wall ms, the kernels' summed device
    ms (one stream, so they do not overlap), that sum by kind, the kernels
    of kind "other" that take the most device time, the port's two
    kernels as many times as the profiler saw them run, and every kernel
    so counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_kind, other = {}, {}
    port = {"conv_gn_mish_kernel": 0, "conv1d_gn_mish_kernel": 0}
    n_kernels = 0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        # kernels only: a CPU op's own device time repeats its kernels',
        # and a range the program marks on the device (AdamW's step) spans them
        if (us <= 0 or getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
            continue
        name = ev.key
        kind = ("conv_gn_mish" if "gn_mish" in name else  # both port kernels
                "memcpy/memset" if "Memcpy" in name or "Memset" in name else
                # cuDNN's FFT convolutions and weight and data gradients too
                "cudnn/cublas" if any(s in name for s in ("cudnn", "xmma", "gemm", "conv", "sm90", "fft",
                                                          "pointwise_mult_and_sum_complex", "wgrad",
                                                          "dgrad")) else
                "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3
        n_kernels += ev.count
        if kind == "conv_gn_mish":
            port["conv1d_gn_mish_kernel" if "conv1d_gn_mish" in name else "conv_gn_mish_kernel"] += ev.count
        if kind == "other":
            other[name] = other.get(name, 0.0) + us / 1e3
    dev_ms = sum(by_kind.values())
    top = sorted(other.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall, "device_ms": dev_ms, "busy_share": dev_ms / wall,
            "by_kind": {k: round(v, 4) for k, v in sorted(by_kind.items())},
            "top_other": [(k[:90], round(v, 3)) for k, v in top], "port_kernel_launches": port,
            "kernels": n_kernels}


def agents(load_cfg, case, device_breakdown, launches, max_err, smi) -> dict:
    """Phase 6: the port's closed-loop agents and entry points on the card,
    at full width. ``launches`` and ``max_err`` gather this phase's launch
    counts and fp32 kernel errors into the kernels line."""
    import importlib.util

    import numpy as np
    import torch

    from autonomous_driving_with_diffusion_model_tpu_torch.driving import (
        DiffusionPlanner,
        FakeDrivingEnv,
        InteractAgent,
        ReplayEnv,
        evaluate_cli,
    )
    from autonomous_driving_with_diffusion_model_tpu_torch.models import ResidualTemporalMapBlock

    def steps_of(cfg):
        return len(cfg.TPU.SAMPLE_TIMESTEPS) or cfg.EVAL.SAMPLE_STEPS

    def pct(xs, q):
        return float(np.percentile(xs, q))

    out = {"configs": {}}
    replay = replay_observations(os.path.join(REPO, REPLAY))
    for path in CONFIGS:
        cfg = load_cfg(path)
        n_fwd = steps_of(cfg)
        per_tick = {"fused_residual_block": 16 * n_fwd, "fused_conv1d_gn_mish": n_fwd}
        gpu = DiffusionPlanner(cfg, seed=0)
        cpu = DiffusionPlanner(cfg, seed=0, device="cpu")
        cpu.init_trajs = gpu.init_trajs.cpu()
        row = {"steps": n_fwd, "launches_per_tick": per_tick}

        # 6.1 the same recorded frames through a GPU and a CPU agent, in lockstep
        frames = {"gpu": [], "cpu": []}
        agent = {d: InteractAgent(cfg, ReplayEnv(replay), planner=p,
                                  on_frame=lambda s, t, c, d=d: frames[d].append((t, c)))
                 for d, p in (("gpu", gpu), ("cpu", cpu))}
        obs = {d: a.env.reset() for d, a in agent.items()}
        row["lockstep"] = []
        for tick in range(2 if n_fwd > 10 else 4):
            _, got = counted(launches, lambda: agent["gpu"].compute_control(obs["gpu"]))
            if got != per_tick:
                raise AssertionError(f"{path} tick {tick}: launches {got} != {per_tick}")
            agent["cpu"].compute_control(obs["cpu"])
            (tg, cg), (tc, cc) = frames["gpu"][tick], frames["cpu"][tick]
            plan_diff = float(np.abs(tg - tc).max())
            raw_diff = float(np.abs(tg[0, 0, -3:] - tc[0, 0, -3:]).max())
            branch = not near_threshold(tc[0, 0, -3:], CONTROL_TOL)
            ok = (np.allclose(tg, tc, **PLAN_TOL) and raw_diff <= CONTROL_TOL
                  and (not branch or (np.array_equal(cg == 0, cc == 0)
                                      and np.abs(cg - cc).max() <= CONTROL_TOL)))
            row["lockstep"].append(dict(tick=tick, launches=got, plan_max_abs_m=plan_diff,
                                        raw_control_max_abs=raw_diff, controls_compared=branch,
                                        control_gpu=cg.tolist(), control_cpu=cc.tolist()))
            log(f"agents {path} replay tick {tick}: launches {got}; GPU vs CPU plan max_abs_diff "
                f"{plan_diff:.3e} m, raw controls {raw_diff:.3e}; controls {[round(float(v), 4) for v in cg]} "
                f"({'compared' if branch else 'raw near a threshold: branch not compared'}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{path} tick {tick}: GPU agent differs from the CPU agent")
            for d in agent:
                obs[d] = agent[d].env.step({0: frames[d][tick][1]})[0]
        del cpu, agent

        # 6.2 tick latency on the fake env: the agent's decision plus the env
        # step, after one warm tick; sequential and pipelined in turns
        # (sequential, pipelined, pipelined, sequential), since the host
        # clock drifts within a run
        ticks = {"sequential": [], "pipelined": []}
        controls = {"sequential": [], "pipelined": []}
        runs = []
        for pipelined in (False, True, True, False):
            mode = "pipelined" if pipelined else "sequential"
            env = FakeDrivingEnv(image_hw=(256, 900), seed=0)
            agent = InteractAgent(cfg, env, planner=gpu, pipelined=pipelined)
            state = env.reset()
            tick_ms = []

            def run_ticks():
                nonlocal state
                for i in range(LATENCY_TICKS + 1):
                    t0 = time.perf_counter()
                    control = agent.compute_control(state)
                    t1 = time.perf_counter()
                    state = env.step({0: control})[0]
                    if i:  # the first tick is the warm one
                        tick_ms.append((time.perf_counter() - t0) * 1e3)
                        controls[mode].append((t1 - t0) * 1e3)
                    if not np.isfinite(control).all():
                        raise AssertionError(f"{path}: non-finite control {control}")
                if pipelined:  # the last plan is still in flight: land it
                    agent._pending_plan[0].result()

            _, got = counted(launches, run_ticks)
            agent.close()
            want = {k: v * (LATENCY_TICKS + 1) for k, v in per_tick.items()}
            if got != want:
                raise AssertionError(f"{path} {mode}: launches {got} != {want}")
            ticks[mode] += tick_ms
            runs.append(dict(mode=mode, tick_ms_p50=pct(tick_ms, 50), tick_ms=tick_ms, launches=got))
            log(f"agents {path} {mode} (run {len(runs)} of 4): tick p50 {pct(tick_ms, 50):.2f} ms, "
                f"p90 {pct(tick_ms, 90):.2f} ms over {LATENCY_TICKS} ticks of FakeDrivingEnv 900x256 "
                f"after one warm tick; launches {got}; on {smi}")
        row["ticks"] = {mode: dict(tick_ms_p50=pct(t, 50), tick_ms_p90=pct(t, 90),
                                   control_ms_p50=pct(controls[mode], 50),
                                   run_p50s=[r["tick_ms_p50"] for r in runs if r["mode"] == mode])
                        for mode, t in ticks.items()}
        row["tick_runs"] = runs
        for mode, t in row["ticks"].items():
            log(f"agents {path} {mode}: tick p50 {t['tick_ms_p50']:.2f} ms, p90 {t['tick_ms_p90']:.2f} ms "
                f"(compute_control p50 {t['control_ms_p50']:.2f} ms) over the {2 * LATENCY_TICKS} ticks of "
                f"its two runs (run p50s {', '.join(f'{v:.2f}' for v in t['run_p50s'])}); on {smi}")
        env = FakeDrivingEnv(image_hw=(256, 900), seed=0)
        agent = InteractAgent(cfg, env, planner=gpu)
        state = env.reset()
        busy = device_breakdown(lambda: env.step({0: agent.compute_control(state)}))
        row["profiled_tick"] = busy
        log(f"agents {path}: profiled sequential tick {busy['wall_ms']:.2f} ms, device busy "
            f"{busy['device_ms']:.2f} ms ({busy['busy_share']:.3f}); by kind {busy['by_kind']}; on {smi}")
        out["configs"][path] = row
        del gpu, agent

    # 6.3 the 2-dim waypoint model and its PID controls, at the default width
    cfg = load_cfg(CONFIGS[0])
    cfg.MODEL.TRANSITION_DIM = 2
    planner = DiffusionPlanner(cfg, seed=0)
    calls = []
    hooks = [m.register_forward_hook(lambda mod, args, o, n=n: calls.append((n, mod, args)))
             for n, m in planner.model.named_modules() if isinstance(m, ResidualTemporalMapBlock)]
    with torch.no_grad():
        feat = planner.model.encode_image(torch.zeros(1, 256, 900, 3, device=planner.device))
        planner.model(planner.init_trajs[:1], time=torch.ones(1, device=planner.device), img_feature=feat)
    for h in hooks:
        h.remove()
    gen = torch.Generator().manual_seed(2)
    checks = []
    with torch.no_grad():
        for n, m, a in [c for c in calls if c[2][0].shape[-1] == 2]:
            for dtype in (torch.float32, torch.bfloat16):
                for B in (1, 2):
                    fn, plain, args = case(m, a, B, dtype, gen)
                    got, want = fn(*args).float(), plain(*args).float()
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    ok = torch.allclose(got, want, **KERNEL_TOL[str(dtype)[6:]]) and bool(torch.isfinite(got).all())
                    if dtype == torch.float32:
                        max_err[fn.__name__] = max(max_err[fn.__name__], err)
                    checks.append(dict(block=n, B=B, dtype=str(dtype)[6:], max_abs_err=err, ok=ok))
                    log(f"agents 2-dim check {fn.__name__} {n} B={B} {tuple(args[0].shape)} {str(dtype)[6:]} "
                        f"max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"{fn.__name__} at {n} (Cin 2) B={B} {dtype}: {err}")
    if not checks:
        raise AssertionError("the 2-dim model has no residual block with Cin = 2")
    env = FakeDrivingEnv(image_hw=(256, 900), seed=0)
    trajs = []
    agent = InteractAgent(cfg, env, planner=planner, on_frame=lambda s, t, c: trajs.append(t))
    pid = []

    def pid_ticks():
        state = env.reset()
        for _ in range(3):
            control = agent.compute_control(state)
            pid.append(control.tolist())
            state = env.step({0: control})[0]

    _, got = counted(launches, pid_ticks)
    cpu = DiffusionPlanner(cfg, seed=0, device="cpu")
    cpu.init_trajs = planner.init_trajs.cpu()
    diff = float(np.abs(trajs[0] - cpu.plan(np.asarray(FakeDrivingEnv(image_hw=(256, 900), seed=0)
                                                         .reset()["camera"][0]))).max())
    ok = (all(np.isfinite(c).all() and 0.0 <= c[0] <= cfg.CONTROL.MAX_THROTTLE for c in pid)
          and trajs[0].shape == (1, cfg.MODEL.HORIZON, 2) and diff <= PLAN_TOL["atol"])
    out["pid_2dim"] = dict(checks=checks, controls=pid, launches=got, first_plan_gpu_vs_cpu_m=diff)
    log(f"agents 2-dim PID: 3 ticks, controls {np.round(pid, 4).tolist()}, launches {got}, "
        f"first plan GPU vs CPU {diff:.3e} m {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"2-dim PID path: controls {pid}, plan diff {diff}")
    del planner, cpu, agent

    # 6.4 the leaderboard agent, loaded from its file as the harness loads it
    spec = importlib.util.spec_from_file_location(
        "leaderboard_agent", os.path.join(REPO, PKG, "driving", "leaderboard_agent.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    agent = getattr(mod, mod.get_entry_point())()  # the default config, on the card
    agent.set_global_plan(None, [((5.0 * i, 0.0), 4) for i in range(20)])
    rng = np.random.default_rng(3)
    lb = []
    for step in range(agent.cfg.ENV.AGENT_WARMUP + 3):
        inputs = {
            "rgb": (step, rng.integers(0, 256, (256, 900, 4), dtype=np.uint8)),
            "bev": (step, rng.integers(0, 256, (512, 512, 4), dtype=np.uint8)),
            "gps": (step, np.array([1.5 * step, 0.1 * step, 0.0])),
            "imu": (step, np.array([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.05 * step])),
            "speed": (step, {"speed": 2.0}),
        }
        if step < agent.cfg.ENV.AGENT_WARMUP:
            c = agent.run_step(inputs, 0.05 * step)
        else:
            c, got = counted(launches, lambda: agent.run_step(inputs, 0.05 * step))
        lb.append(dict(step=step, control=[c.throttle, c.steer, c.brake],
                       launches=None if step < agent.cfg.ENV.AGENT_WARMUP else got))
    ok = (all(np.isfinite(r["control"]).all() for r in lb)
          and mod.DiffusionPlanner.__module__ == f"{PKG}.driving.plan")
    out["leaderboard"] = dict(module=mod.DiffusionPlanner.__module__, steps=lb)
    log(f"agents leaderboard_agent.py by file path ({mod.DiffusionPlanner.__module__}): "
        + "; ".join(f"step {r['step']} {np.round(r['control'], 4).tolist()} launches {r['launches']}" for r in lb)
        + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"leaderboard agent: {lb}")
    agent.destroy()

    # 6.5 the evaluation CLI over the fake env, on the card
    ckpt = os.path.join(REPO, "chiprun_out", "eval_ckpt.json")
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
    if os.path.exists(ckpt):
        os.remove(ckpt)  # a resumed run would skip the route
    t0 = time.perf_counter()
    data, got = counted(launches, lambda: evaluate_cli.main(
        ["--env-id", "Endless-v0", "--weather-group", "simple", "--fake-env", "--max-steps", "15",
         "--checkpoint-json", ckpt]))
    records = data["_checkpoint"]["records"]
    ok = (len(records) == 1 and records[0]["status"] == "Completed" and records[0]["num_steps"] == 15
          and got["fused_conv1d_gn_mish"] == 15 * steps_of(load_cfg(CONFIGS[0])))
    out["evaluate_cli"] = dict(record=records[0] if records else None, launches=got,
                               seconds=time.perf_counter() - t0)
    log(f"agents evaluate_cli --fake-env: {len(records)} record(s): "
        + "; ".join(f"{r['route_id']} {r['status']} num_steps {r['num_steps']} scores {r['scores']}"
                    for r in records)
        + f"; launches {got}; {out['evaluate_cli']['seconds']:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"evaluate_cli: {records}, launches {got}")
    return out


def serving_paths(scorer_npz):
    """Phase 7's planner paths beside phase 4's three configs: (name, config,
    options). ``scorer_npz``: the learned scorer's file, written by the
    phase that plans with it."""
    bf16 = {"TPU.COMPUTE_DTYPE": "bfloat16"}
    return [
        ("ddpm100", CONFIGS[0], {"EVAL.SCHEDULER": "ddpm"}),
        ("dpm10_bf16", CONFIGS[0], {"EVAL.SCHEDULER": "dpm", "EVAL.SAMPLE_STEPS": 10, **bf16}),
        ("bf16_default", CONFIGS[0], bf16),
        ("bf16_free_guidance", CONFIGS[1], bf16),
        ("bf16_classifier_guidance", CONFIGS[2], bf16),
        ("learned_scorer_k8", CONFIGS[1], {"TPU.NUM_HYPOTHESES": 8, "TPU.HYPOTHESIS_SCORER": "learned",
                                           "TPU.SCORER_CHECKPOINT": scorer_npz}),
        ("resnet50", CONFIGS[1], {"MODEL.PERCEPTION": "resnet50"}),
    ]


def plan_tol(cfg) -> dict:
    """GPU vs CPU plan tolerance of a config: PLAN_TOL, or BF16_PLAN_TOL (x
    1 + 2 FREE_SCALE under dual-batch CFG) for a bfloat16 model."""
    if cfg.TPU.COMPUTE_DTYPE != "bfloat16":
        return PLAN_TOL
    tol = dict(BF16_PLAN_TOL)
    if cfg.GUIDANCE.USE_COND == "FREE_GUIDANCE" and cfg.GUIDANCE.FREE_SCALE != 1.0:
        tol["atol"] *= 1.0 + 2.0 * abs(cfg.GUIDANCE.FREE_SCALE)
    return tol


def serving(load_cfg, device_breakdown, launches, smi, dev="cuda") -> dict:
    """Phase 7: the rest of the serving path at full width. Each path's
    first plan runs with the launch counts set to 0 just before and read
    just after; ``launches`` gathers them into the kernels line. ``dev``
    is the card (another device only to rehearse the phase)."""
    import numpy as np
    import torch

    from autonomous_driving_with_diffusion_model_tpu_torch import diffusion
    from autonomous_driving_with_diffusion_model_tpu_torch.data.augment import normalize_images
    from autonomous_driving_with_diffusion_model_tpu_torch.driving import DiffusionPlanner
    from autonomous_driving_with_diffusion_model_tpu_torch.models import (
        PERCEPTION_BUILDERS,
        build_model,
        init_parameters,
        init_scorer,
        save_scorer,
    )
    from autonomous_driving_with_diffusion_model_tpu_torch.ops import kernels
    from autonomous_driving_with_diffusion_model_tpu_torch.utils.constants import MAGIC_NUM

    out = {"paths": {}}
    target = np.array([0.3, 0.1], np.float32)

    def count(run, n_fwd, what):
        kernels.reset_launch_counts()
        res = run()
        torch.cuda.synchronize()
        got = {k: getattr(kernels, k).launches for k in launches}
        want = {"fused_residual_block": 16 * n_fwd, "fused_conv1d_gn_mish": n_fwd}
        log(f"serving {what}: launches {got}, expected {want}")
        if got != want:
            raise AssertionError(f"{what}: launch counts {got} != {want}")
        for k in launches:
            launches[k] += got[k]
        return res, got

    def timing(run, frames, base):
        """plan p50 over 5 plans after one warm plan, peak MiB (and above
        ``base``, the bytes allocated before the path: what earlier phases
        hold), one profiled plan."""
        run(frames[1])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(5):
            t0 = time.perf_counter()
            run(frames[i % len(frames)])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2**20
        return dict(plan_ms_p50=float(np.median(times)), plan_ms=times, peak_mib=peak,
                    path_peak_mib=peak - base / 2**20, profile=device_breakdown(lambda: run(frames[2])))

    def configured(path, opts):
        cfg = load_cfg(path)
        cfg.merge_from_list([str(v) for kv in opts.items() for v in kv])
        return cfg

    def record(name, row):
        out["paths"][name] = row
        busy = row["profile"]
        log(f"serving {name}: plan p50 {row['plan_ms_p50']:.2f} ms over 5 plans ({row['steps']} steps), "
            f"peak {row['peak_mib']:.1f} MiB ({row['path_peak_mib']:.1f} above what earlier phases hold), "
            f"CPU reference {row['cpu_s']:.1f} s, path {row['seconds']:.1f} s, device busy {busy['device_ms']:.2f} of {busy['wall_ms']:.2f} ms "
            f"({busy['busy_share']:.3f}), by kind {busy['by_kind']}; on {smi}")

    h, w = load_cfg(CONFIGS[0]).TRAIN.IMAGE_HEIGHT, load_cfg(CONFIGS[0]).TRAIN.IMAGE_WIDTH
    frames = np.random.default_rng(7).integers(0, 256, (4, h, w, 3), dtype=np.uint8)
    scorer_npz = os.path.join(REPO, "chiprun_out", "phase7_scorer.npz")
    os.makedirs(os.path.dirname(scorer_npz), exist_ok=True)
    for name, path, opts in serving_paths(scorer_npz):
        cfg = configured(path, opts)
        if name == "learned_scorer_k8":
            save_scorer(scorer_npz, init_scorer(0, cfg.MODEL.HORIZON, cfg.MODEL.TRANSITION_DIM))
        n_fwd = len(cfg.TPU.SAMPLE_TIMESTEPS) or cfg.EVAL.SAMPLE_STEPS
        t_path, base = time.perf_counter(), torch.cuda.memory_allocated()
        is_bf16 = cfg.TPU.COMPUTE_DTYPE == "bfloat16"
        tol = plan_tol(cfg)
        gpu = DiffusionPlanner(cfg, seed=0, device=dev)
        tgt = target if gpu.use_guidance_type.name != "NO_GUIDANCE" else None
        (first, best), got = count(lambda: gpu.plan_hypotheses(frames[0], tgt), n_fwd, name)
        if first.shape != (gpu.num_hypotheses, cfg.MODEL.HORIZON, cfg.MODEL.TRANSITION_DIM) \
                or first.dtype != np.float32 or not np.isfinite(first).all():
            raise AssertionError(f"{name}: plans of shape {first.shape}, {first.dtype}, or non-finite")
        t_cpu = time.perf_counter()
        cpu = DiffusionPlanner(cfg, seed=0, device="cpu")  # the same weights and noise
        ref, ref_best = cpu.plan_hypotheses(frames[0], tgt)
        t_cpu = time.perf_counter() - t_cpu
        diff = float(np.abs(first - ref).max())
        rms = float(np.sqrt(np.mean((first - ref) ** 2)))
        ok = np.allclose(first, ref, **tol)
        row = dict(steps=n_fwd, launches=got, hypotheses=gpu.num_hypotheses, gpu_vs_cpu_max_abs_m=diff,
                   gpu_vs_cpu_rms_m=rms, tolerance=tol, best=int(best), cpu_best=int(ref_best), cpu_s=t_cpu)
        if cfg.TPU.HYPOTHESIS_SCORER == "learned":
            # the index must agree unless the CPU's two best scores are closer
            # than the plans' tolerance can separate
            with torch.no_grad():
                scores = np.sort(cpu._scorer_net(torch.from_numpy(ref), torch.from_numpy(target)).numpy())
            row["cpu_score_margin"] = float(scores[1] - scores[0])
            ok = ok and (int(best) == int(ref_best) or row["cpu_score_margin"] < 1e-3)
        del cpu
        if is_bf16:
            f32 = DiffusionPlanner(configured(path, {**opts, "TPU.COMPUTE_DTYPE": "float32"}), seed=0, device=dev)
            row["bf16_vs_fp32_gpu_max_abs_m"] = float(np.abs(first - f32.plan_hypotheses(frames[0], tgt)[0]).max())
            del f32
        log(f"serving {name}: GPU vs CPU plan max_abs_diff={diff:.3e} m, rms {rms:.3e} m (tolerance {tol})"
            + (f", best {int(best)} / CPU {int(ref_best)}" if gpu.num_hypotheses > 1 else "")
            + (f"; bf16 vs fp32 plan on the card {row['bf16_vs_fp32_gpu_max_abs_m']:.3e} m" if is_bf16 else "")
            + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: GPU plan differs from the CPU plan by {diff} m")
        row.update(timing(lambda f: gpu.plan_hypotheses(f, tgt), frames, base))
        record(name, dict(row, seconds=time.perf_counter() - t_path))
        del gpu

    # every ResNet once on the card against the CPU, at the frame size
    out["encoders"] = {}
    img = torch.randn((1, h, w, 3), generator=torch.Generator().manual_seed(0))
    for pname, builder in PERCEPTION_BUILDERS.items():
        if pname == "tiny":
            continue
        net = init_parameters(builder(num_classes=64), torch.Generator().manual_seed(0)).eval()
        with torch.no_grad():
            want = net(img)
            net = net.to(dev)
            got = net(img.to(dev))
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                net(img.to(dev))
            end.record()
            torch.cuda.synchronize()
        err = float((got.cpu() - want).abs().max() / want.abs().max())
        ok = err <= ENCODE_TOL and bool(torch.isfinite(got).all())
        out["encoders"][pname] = dict(rel_err=err, encode_ms=start.elapsed_time(end) / 3)
        log(f"serving encode {pname} ({h}x{w}): GPU vs CPU max_abs / max |feature| {err:.3e}, "
            f"{out['encoders'][pname]['encode_ms']:.2f} ms per encode (3 after one, host included) on {smi} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"encode {pname}: relative error {err}")
        del net

    # inpainting through make_sampler: the first INPAINT_KNOWN waypoints known
    cfg = load_cfg(CONFIGS[0])
    devices = {"card": dev, "cpu": "cpu"}
    models = {k: build_model(cfg, device=d, seed=0) for k, d in devices.items()}
    H, D = cfg.MODEL.HORIZON, cfg.MODEL.TRANSITION_DIM
    init = torch.randn((1, H, D), generator=torch.Generator().manual_seed(0))
    known = torch.zeros((1, H, D))
    known[0, :INPAINT_KNOWN, 0] = 0.05 * torch.arange(INPAINT_KNOWN)  # straight ahead, the anchor at 0
    mask = torch.zeros((1, H, D))
    mask[:, :INPAINT_KNOWN] = 1.0
    for scheduler in ("ddim", "ddpm"):
        name = f"inpaint_{scheduler}"
        scfg = diffusion.SamplerConfig(
            scheduler=scheduler, num_steps=INPAINT_STEPS, inpainting=True,
            step=diffusion.StepConfig(prediction_type=cfg.TRAIN.NOISE_SCHEDULER.PRED_TYPE, thresholding=True),
        )

        def run(frame, which):
            d = devices[which]
            with torch.no_grad():
                image = normalize_images(torch.from_numpy(frame).to(d))[None]
                return samplers[which](init.to(d), image=image, target_traj=known.to(d), target_mask=mask.to(d),
                                       generator=torch.Generator().manual_seed(1)).cpu().numpy()

        samplers = {k: diffusion.make_sampler(m, diffusion.make_schedule_from_cfg(cfg, devices[k]), scfg)
                    for k, m in models.items()}
        t_path = time.perf_counter()
        first, got = count(lambda: run(frames[0], "card"), INPAINT_STEPS, name)
        t_cpu = time.perf_counter()
        ref = run(frames[0], "cpu")
        t_cpu = time.perf_counter() - t_cpu
        diff = float(np.abs(first - ref).max())
        want = known[:, :INPAINT_KNOWN].numpy().copy()
        want[..., :2] *= MAGIC_NUM
        pinned = float(np.abs(first[:, :INPAINT_KNOWN] - want).max())
        ok = np.allclose(first, ref, **PLAN_TOL) and pinned <= 1e-4 and np.isfinite(first).all()
        log(f"serving {name}: GPU vs CPU max_abs_diff={diff:.3e} m; the {INPAINT_KNOWN} known waypoints "
            f"pinned to {pinned:.3e} m {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: GPU vs CPU {diff} m, known region off by {pinned} m")
        row = dict(steps=INPAINT_STEPS, launches=got, gpu_vs_cpu_max_abs_m=diff, pinned_max_abs_m=pinned,
                   cpu_s=t_cpu)
        row.update(timing(lambda f: run(f, "card"), frames, base))
        record(name, dict(row, seconds=time.perf_counter() - t_path))
    return out


def write_dataset(root: str, n: int, h: int, w: int, seed: int = 0) -> None:
    """``n`` frames of ``h`` x ``w`` and their waypoint files in the dataset
    layout (``front/*.png``, ``waypoints/{idx:06d}.txt``), written with the
    port's PNG writer (row filter Sub, as libpng often picks): a smooth
    random field plus noise, targets and 16 x 7 transitions."""
    import numpy as np

    from autonomous_driving_with_diffusion_model_tpu_torch.data.png import write_png

    rng = np.random.default_rng(seed)
    for sub in ("front", "waypoints"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        phase = rng.uniform(0, 2 * np.pi, 3)
        base = 127 + 100 * np.sin(xx[..., None] / 37.0 + yy[..., None] / 23.0 + phase)
        img = np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)
        write_png(os.path.join(root, "front", f"{i:06d}.png"), img, 1, level=1)
        lines = [" ".join(f"{v:.6f}" for v in rng.uniform(-1, 1, 2))]
        lines += [" ".join(f"{v:.6f}" for v in rng.uniform(-1.2, 1.2, 7)) for _ in range(16)]
        with open(os.path.join(root, "waypoints", f"{i:06d}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")


def decode_throughput(hosts, smi) -> dict:
    """Host ms per decoded frame of each host dataset (``hosts``: rows ->
    dataset root, frames of Sub or of Paeth rows): ``read_png`` on
    NUM_WORKERS threads over TRAIN_FRAMES frames (the loader before the
    decoder processes), and the port's ``Loader`` at B = 32 over an epoch of
    4 x TRAIN_FRAMES frames with NUM_WORKERS and with twice as many decoder
    processes (the epoch after the one that starts them)."""
    from concurrent.futures import ThreadPoolExecutor

    from autonomous_driving_with_diffusion_model_tpu_torch.data import Loader, TrajDataset, read_png

    out = {}
    for rows, root in hosts.items():
        ds = TrajDataset(root, cache_decoded=False)
        ds.front_image = ds.front_image[:4 * TRAIN_FRAMES]  # 8 batches: work for 8 processes
        with ThreadPoolExecutor(NUM_WORKERS) as pool:  # threads on TRAIN_FRAMES frames: Paeth rows thrash the GIL
            list(pool.map(read_png, ds.front_image[:NUM_WORKERS]))
            t0 = time.perf_counter()
            list(pool.map(read_png, ds.front_image[:TRAIN_FRAMES]))
            threads = (time.perf_counter() - t0) / TRAIN_FRAMES * 1e3
        procs = {}
        for workers in (NUM_WORKERS, 2 * NUM_WORKERS):
            loader = Loader(ds, batch_size=32, num_workers=workers, shuffle=False)
            try:
                t0 = time.perf_counter()
                list(loader)  # starts the processes
                start_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                n = sum(len(b["trajs"]) for b in loader)
                procs[workers] = (time.perf_counter() - t0) / n * 1e3
            finally:
                loader.close()
        out[rows] = {"threads_ms": threads, "processes_ms": procs[NUM_WORKERS],
                     f"processes_ms_{2 * NUM_WORKERS}": procs[2 * NUM_WORKERS], "frames": n,
                     "first_epoch_s": start_s, "host_cpus": os.cpu_count()}
        log(f"decode {rows} rows: {threads:.3f} ms a frame on {NUM_WORKERS} threads, {procs[NUM_WORKERS]:.3f} ms a "
            f"frame in {NUM_WORKERS} decoder processes ({threads / procs[NUM_WORKERS]:.2f}x), "
            f"{procs[2 * NUM_WORKERS]:.3f} ms in {2 * NUM_WORKERS} ({n} frames of an epoch; the first epoch, "
            f"with the processes' start, {start_s:.1f} s; {os.cpu_count()} host CPUs), host clock; on {smi}")
    return out


def augment_rows(images, d):
    """The augmentation as the port ran it before its branch-free body, on
    the draws ``d``: at each position, for each op, the rows that take it
    (read back to the host), gathered, the op, and scattered back: shapes
    that change with the data, so no graph can hold it."""
    import numpy as np
    import torch

    from autonomous_driving_with_diffusion_model_tpu_torch.data import augment as aug

    x = images.to(torch.float32)
    select = d["select"].cpu().numpy()
    for k in range(7):
        for j in range(7):
            rows = np.nonzero(select[k, j])[0]
            if len(rows) == 0:
                continue
            idx = torch.from_numpy(rows).to(x.device)
            xs = x.index_select(0, idx)
            pick = lambda name: d[name].index_select(0, idx)
            per_c = pick("per_c")
            if j == 0:
                y = aug._separable(xs, pick("blur_taps"))
            elif j == 1:
                y = aug._add_noise(xs, pick("noise_scale"), aug._channel_choice(per_c[:, 1], pick("noise")))
            elif j in (2, 3):
                field, p = ("coarse", "coarse_p") if j == 2 else ("dropout", "dropout_p")
                drop = (aug._channel_choice(per_c[:, j], pick(field)) < aug._per_image(pick(p))).to(x.dtype)
                y = aug._coarse_dropout(xs, drop) if j == 2 else aug._dropout(xs, drop)
            else:
                y = (aug._add, aug._multiply, aug._contrast)[j - 4](xs, d["values"][j - 4].index_select(0, idx))
            x = x.index_copy(0, idx, y)
    return x.clamp(0.0, 255.0)


def augmentation(device_breakdown, smi, dev="cuda") -> dict:
    """Phase 8's augmentation alone, at B = 32 (the fp32 step's batch) and
    B = 64 (the bf16 learnability step's) at 900x256, at iteration 0
    (frequency 0.05) and late (every op at 0.5): the program
    (``AugmentProgram``, a CUDA graph replay) against its eager body on the
    same draws (bit-identical) and against the row-gathering path it
    replaced (``augment_rows``, AUG_TOL); host ms per call ending in a
    synchronize (draws included), in turns, p50 over AUG_REPS; the graph's
    device ms by CUDA events; the kernels the profiler counts in one replay
    and in one eager body."""
    import numpy as np
    import torch

    from autonomous_driving_with_diffusion_model_tpu_torch.data import augment as aug
    from autonomous_driving_with_diffusion_model_tpu_torch.train import cli

    out = {}
    rng = np.random.default_rng(8)
    for B in (32, 64):
        images = torch.from_numpy(rng.integers(0, 256, (B, 256, 900, 3), dtype=np.uint8)).to(dev)
        program = aug.AugmentProgram(dev)
        for iteration in (0, 6.4e8):
            gen = lambda it: cli.iteration_generators(it, dev)[0]
            got = program(images, gen(0), iteration)  # the build and a replay
            want = aug.augment_batch(images, gen(0), iteration)
            d = aug.augment_draws(gen(0), images.shape, iteration, dev)
            rows = augment_rows(images, d)
            same = bool(torch.equal(got, want))
            rows_err = float((rows - want).abs().max())
            prog = program.programs[program.key]
            runs = {"rows": lambda it: augment_rows(images, aug.augment_draws(gen(it), images.shape, iteration, dev)),
                    "eager": lambda it: aug.augment_batch(images, gen(it), iteration),
                    "graph": lambda it: program(images, gen(it), iteration)}
            ms = {k: [] for k in runs}
            for r in range(AUG_REPS):
                for k, run in runs.items():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    run(r + 1)
                    torch.cuda.synchronize()
                    ms[k].append((time.perf_counter() - t0) * 1e3)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(AUG_REPS):
                prog.graph.replay()
            end.record()
            torch.cuda.synchronize()
            replay_ms = start.elapsed_time(end) / AUG_REPS
            replay = device_breakdown(lambda: prog.graph.replay())
            eager = device_breakdown(lambda: aug.augment_body(prog.inputs["images"], prog.inputs["draws"]))
            ok = same and rows_err <= AUG_TOL and replay["kernels"] > 0
            row = dict(bit_identical=same, rows_vs_eager_max_abs=rows_err,
                       rows_bit_identical=bool(torch.equal(rows, want)),
                       ms_p50={k: float(np.median(v)) for k, v in ms.items()}, ms=ms, replay_device_ms=replay_ms,
                       kernels_per_replay=replay["kernels"], kernels_per_eager_body=eager["kernels"],
                       replay_profile=replay, taking_an_op=int(d["select"].any(dim=(0, 1)).sum()))
            out[f"b{B}_it{iteration:g}"] = row
            log(f"augmentation B={B} at 900x256, iteration {iteration:g}: graph vs eager bit-identical {same}, "
                f"the row-gathering path within {rows_err:.3e} (bit-identical {row['rows_bit_identical']}); host "
                f"ms p50 (draws included) rows {row['ms_p50']['rows']:.2f}, eager body "
                f"{row['ms_p50']['eager']:.2f}, graph {row['ms_p50']['graph']:.2f} over {AUG_REPS} each in turns; "
                f"replay device {replay_ms:.3f} ms; kernels per replay {replay['kernels']} (eager body "
                f"{eager['kernels']}); {row['taking_an_op']} of {B} images take an op; on {smi} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"augmentation B={B} iteration {iteration:g}: {row}")
        del images, program
    return out


def grad_ratio(got, want, names):
    """The worst tensor's max abs gradient difference over its tolerance
    (fails above 1), and its name."""
    return max((((got[n] - want[n]).abs().max() / (STEP_GRAD_TOL * want[n].abs().max()
                                                    + STEP_GRAD_FLOOR)).item(), n) for n in names)


def rel_norm(got, want, names):
    return (sum(float((got[n] - want[n]).square().sum()) for n in names)
            / sum(float(want[n].square().sum()) for n in names)) ** 0.5


def norm_ratio(got, want, names):
    """The worst tensor's gradient distance, by norm, over ENCODER_GRAD_RTOL
    of its norm (plus STEP_GRAD_FLOOR), and its name."""
    return max((((got[n] - want[n]).norm() / (ENCODER_GRAD_RTOL * want[n].norm() + STEP_GRAD_FLOOR)).item(), n)
               for n in names)


def training(load_cfg, calls, case, graph_ms, bound_ms, device_breakdown, launches, smi, dev="cuda") -> dict:
    """Phase 8: training on the card. ``calls`` are the main-path blocks of
    one U-Net forward; ``launches`` gathers the timed steps' launch counts
    into the kernels line. ``dev`` is the card (another device only to
    rehearse the phase)."""
    import shutil

    import numpy as np
    import torch

    from autonomous_driving_with_diffusion_model_tpu_torch.data import (
        AugmentProgram,
        DeviceResidentLoader,
        Loader,
        TrajDataset,
        get_loader,
        maybe_device_resident,
        normalize_images,
        read_png,
        write_png,
    )
    from autonomous_driving_with_diffusion_model_tpu_torch.diffusion import make_schedule_from_cfg
    from autonomous_driving_with_diffusion_model_tpu_torch.models import build_model
    from autonomous_driving_with_diffusion_model_tpu_torch.ops import kernels
    from autonomous_driving_with_diffusion_model_tpu_torch.train import (
        StepDraws,
        create_train_state,
        import_torch_checkpoint,
        make_train_step,
    )
    from autonomous_driving_with_diffusion_model_tpu_torch.train import cli
    from autonomous_driving_with_diffusion_model_tpu_torch.train.program import TrainProgram
    from autonomous_driving_with_diffusion_model_tpu_torch.utils.config import create_cfg, merge_possible_with_base

    out = {}
    dev = torch.device(dev)

    # 8.1 each kernel through its autograd.Function at every main-path shape,
    # B = 2 and 32: the forward against the plain forward, and the gradient
    # of every input against autograd of the plain version
    gen = torch.Generator().manual_seed(8)
    rows = []
    for B in (2, 32):
        for n, m, a in calls:
            fn, plain, args = case(m, a, B, torch.float32, gen)
            leaves = [None if v is None else v.detach().clone().requires_grad_(True) for v in args]
            refs = [None if v is None else v.detach().clone().requires_grad_(True) for v in args]
            before = fn.launches
            got = fn(*leaves)
            if fn.launches != before + 1 or (dev.type == "cuda" and "Recompute" not in type(got.grad_fn).__name__):
                raise AssertionError(f"{fn.__name__} at {n} B={B}: the autograd.Function did not launch the kernel")
            want = plain(*refs)
            up = torch.randn(got.shape, generator=gen).to(dev)
            g_got = torch.autograd.grad((got * up).sum(), [v for v in leaves if v is not None])
            g_want = torch.autograd.grad((want * up).sum(), [v for v in refs if v is not None])
            torch.cuda.synchronize()
            fwd_err = (got - want).abs().max().item()
            ok = torch.allclose(got, want, **KERNEL_TOL["float32"]) and bool(torch.isfinite(got).all())
            grad_rel = 0.0
            for gg, gw in zip(g_got, g_want):
                rel = ((gg - gw).abs().max() / gw.abs().max().clamp_min(1e-30)).item()
                grad_rel = max(grad_rel, rel)
                ok = ok and rel <= GRAD_TOL and bool(torch.isfinite(gg).all())
            rows.append(dict(block=n, B=B, forward_max_abs_err=fwd_err, grad_max_rel_err=grad_rel,
                             inputs=len(g_got), ok=ok))
            log(f"train grad {fn.__name__:22s} {n:22s} B={B:2d} {tuple(args[0].shape)}: forward "
                f"max_abs_err={fwd_err:.3e}, {len(g_got)} input gradients max rel err {grad_rel:.3e} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{fn.__name__} at {n} B={B}: forward {fwd_err}, gradient {grad_rel}")
    out["kernel_gradients"] = rows

    # the kernels at B = 32, one forward's calls in a graph, and the
    # recompute backward of the same calls, by CUDA events
    out["b32"] = {}
    cases = [case(m, a, 32, torch.float32, gen) for n, m, a in calls]
    with torch.no_grad():
        for kname in ("fused_residual_block", "fused_conv1d_gn_mish"):
            mine = [c for c in cases if c[0].__name__ == kname]
            bounds = [bound_ms(c[0], c[2]) for c in mine]
            row = dict(calls=len(mine), ms=graph_ms([lambda c=c: c[0](*c[2]) for c in mine]),
                       plain_ms=graph_ms([lambda c=c: c[1](*c[2]) for c in mine]),
                       bound_ms=sum(b for b, _ in bounds),
                       bound_by="bytes" if all(by == "bytes" for _, by in bounds) else "operations")
            out["b32"][kname] = row
    for kname in ("fused_residual_block", "fused_conv1d_gn_mish"):
        mine = [c for c in cases if c[0].__name__ == kname]
        leaves = [[None if v is None else v.detach().clone().requires_grad_(True) for v in c[2]] for c in mine]
        outs = [c[0](*lv) for c, lv in zip(mine, leaves)]
        ups = [torch.ones_like(o) for o in outs]
        for _ in range(2):  # warm
            torch.autograd.grad(outs, [v for lv in leaves for v in lv if v is not None], ups, retain_graph=True)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            torch.autograd.grad(outs, [v for lv in leaves for v in lv if v is not None], ups, retain_graph=True)
        end.record()
        torch.cuda.synchronize()
        row = out["b32"][kname]
        row["recompute_backward_ms"] = start.elapsed_time(end) / 5
        log(f"train time {kname} B=32: one forward's {row['calls']} calls, device ms: kernel {row['ms']:.4f}, "
            f"plain {row['plain_ms']:.4f}, bound {row['bound_ms']:.5f} ({row['bound_by']}); the recompute "
            f"backward of those calls {row['recompute_backward_ms']:.4f} ms (CUDA events, host included) on {smi}")
        del outs, leaves

    # 8.2 GPU against CPU: full width, B = 2, the same weights, batch and
    # draws, three steps (the first update's LR is 0), BatchNorm frozen and
    # in train mode
    rng = np.random.default_rng(8)
    cfg = load_cfg(CONFIGS[0])
    B, H, W = 2, cfg.TRAIN.IMAGE_HEIGHT, cfg.TRAIN.IMAGE_WIDTH
    frames = torch.from_numpy(rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8))
    batch = {"image": normalize_images(frames), "trajs": torch.from_numpy(rng.uniform(-1, 1, (B, 16, 7)).astype(np.float32)),
             "target": torch.from_numpy(rng.uniform(-1, 1, (B, 2)).astype(np.float32))}
    draws = [StepDraws(torch.from_numpy(rng.integers(0, cfg.TRAIN.TIME_STEPS, B)),
                       torch.from_numpy(rng.standard_normal((B, 16, 7)).astype(np.float32)),
                       torch.tensor([True])) for _ in range(3)]

    def run_steps(cfg, d, n_steps=3):
        """n_steps from seed 0's weights on device d: losses, the first
        step's gradients and BatchNorm statistics, the initial and final
        weights and the final EMA shadow, all on the CPU."""
        t0 = time.perf_counter()
        st = create_train_state(build_model(cfg, device=d, seed=0), cfg)
        start = {n: p.detach().cpu().clone() for n, p in st.model.named_parameters()}
        step = make_train_step(make_schedule_from_cfg(cfg, d), cfg)
        b = {k: v.to(d) for k, v in batch.items()}
        r = dict(losses=[], start=start)
        for dr in draws[:n_steps]:
            r["losses"].append(float(step(st, b, dr)["loss"]))
            if len(r["losses"]) == 1:
                r["stats"] = {k: v.cpu().clone() for k, v in st.model.state_dict().items() if "running" in k}
                r["grads"] = {n: p.grad.detach().cpu().clone() for n, p in st.model.named_parameters()}
        r["params"] = {n: p.detach().cpu().clone() for n, p in st.model.named_parameters()}
        r["ema"] = dict(zip(r["params"], (s.cpu().clone() for s in st.ema.shadow_params)))
        r["seconds"] = time.perf_counter() - t0
        return r

    def compare(label, gpu, cpu, held, by_norm=()):
        """Hold ``gpu`` to ``cpu``: the first-step gradients of the ``held``
        tensors per element and of the ``by_norm`` ones by each tensor's
        norm, each check shown to catch a planted fault; the updates (and
        EMA) of the ``held`` tensors; every element within Adam's bound;
        the losses."""
        g_gpu, g_cpu = gpu["grads"], cpu["grads"]
        row = dict(tensors=len(g_cpu), tensors_held=len(held), tensors_by_norm=len(by_norm),
                   seconds=dict(gpu=gpu["seconds"], cpu=cpu["seconds"]))
        row["grad_worst_over_tol"], row["grad_worst_tensor"] = grad_ratio(g_gpu, g_cpu, held)
        encoder = [n for n in g_cpu if n.startswith("perception.")]
        row["encoder_grad_rel_norm"] = rel_norm(g_gpu, g_cpu, encoder)
        block = next(n for n in held if n.startswith("downs.0.0.") and n.endswith("weight"))
        row["planted_faults_over_tol"] = {
            f"{block} gradient zeroed": grad_ratio({block: torch.zeros_like(g_gpu[block])}, g_cpu, [block])[0]}
        if by_norm:
            row["by_norm_worst_over_tol"], row["by_norm_worst_tensor"] = norm_ratio(g_gpu, g_cpu, by_norm)
            enc = next(n for n in by_norm if n.endswith("weight"))
            row["planted_faults_over_tol"][f"{enc} gradient x (1 + 5e-2)"] = norm_ratio(
                {enc: g_gpu[enc] * (1 + 5e-2)}, g_cpu, [enc])[0]
        caught = all(r > 1.0 for r in row["planted_faults_over_tol"].values())
        p_tol = PARAM_TOL * sum([0.0] + [cfg.TRAIN.LR] * 2)
        update_worst, update_at, bound_err = 0.0, None, 0.0
        for kind in ("params", "ema"):
            got, want = gpu[kind], cpu[kind]
            for n in want:
                bound_err = max(bound_err, (got[n] - want[n]).abs().max().item())
                g = g_cpu[n].abs()
                keep = g >= max(NOISE_GRAD, 1e-3 * g.max().item())
                if n in held and keep.any():
                    moved, ref = (got[n] - cpu["start"][n])[keep], (want[n] - cpu["start"][n])[keep]
                    r = ((moved - ref).norm() / (UPDATE_RTOL * ref.norm() + 1e-6)).item()
                    if r >= update_worst:
                        update_worst, update_at = r, f"{kind} {n}"
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(gpu["losses"], cpu["losses"]))
        row.update(losses=dict(gpu=gpu["losses"], cpu=cpu["losses"]), loss_max_rel=loss_rel,
                   update_worst_over_tol=update_worst, update_worst_tensor=update_at, max_abs_after_3_steps=bound_err,
                   adam_bound=p_tol)
        ok = (loss_rel <= LOSS_RTOL and row["grad_worst_over_tol"] <= 1.0 and update_worst <= 1.0
              and row.get("by_norm_worst_over_tol", 0.0) <= 1.0 and bound_err <= p_tol
              and all(np.isfinite(gpu["losses"])))
        by = (f"; {len(by_norm)} by norm: worst {row['by_norm_worst_over_tol']:.3f} of the tolerance "
              f"({ENCODER_GRAD_RTOL} of the tensor's norm) at {row['by_norm_worst_tensor']}" if by_norm else "")
        log(f"train GPU vs CPU, full width, B={B}, 3 steps, {label}: first-step gradients of {len(held)} of "
            f"{len(g_cpu)} tensors: worst {row['grad_worst_over_tol']:.3f} of the tolerance ({STEP_GRAD_TOL} x the "
            f"tensor's largest + {STEP_GRAD_FLOOR}) at {row['grad_worst_tensor']}{by}; the encoder's "
            f"{row['encoder_grad_rel_norm']:.3e} of their norm; planted "
            + ", ".join(f"{k}: {r:.1f}" for k, r in row["planted_faults_over_tol"].items())
            + f" of the tolerance ({'caught' if caught else 'NOT caught'}); updates after 3 steps: worst "
            f"{update_worst:.3f} of the tolerance ({UPDATE_RTOL} of the norm) at {update_at}; every element within "
            f"{bound_err:.3e} (Adam's bound {p_tol:.1e}); losses GPU {gpu['losses']} CPU {cpu['losses']} (max rel "
            f"{loss_rel:.3e}, tolerance {LOSS_RTOL}); GPU {gpu['seconds']:.1f} s, CPU {cpu['seconds']:.1f} s "
            f"{'ok' if ok and caught else 'FAIL'}")
        if not caught:
            raise AssertionError(f"the gradient check does not catch a planted fault ({label}): {row}")
        if not ok:
            raise AssertionError(f"GPU training differs from CPU training ({label}): {row}")
        return row

    out["gpu_vs_cpu"] = {}
    for bn_mode in ("frozen", "train"):
        cfg = load_cfg(CONFIGS[0])
        cfg.merge_from_list(["TPU.BN_MODE", bn_mode, "TRAIN.LR_WARMUP", "1"])
        cpu, gpu = run_steps(cfg, torch.device("cpu")), run_steps(cfg, dev)
        names = list(cpu["grads"])
        encoder = [n for n in names if n.startswith("perception.")]
        unet = [n for n in names if n not in encoder]
        # the U-Net held per element; under frozen the encoder by each
        # tensor's norm
        row = compare(f"BN_MODE {bn_mode}", gpu, cpu, unet, encoder if bn_mode == "frozen" else ())
        if bn_mode == "train":
            fg, fc = gpu["stats"], cpu["stats"]
            row["bn_stat_max_rel"] = max((((fg[k] - fc[k]).abs() / (fc[k].abs() + 1.0)).max().item() for k in fc),
                                         default=0.0)
            log(f"train GPU vs CPU, BN_MODE train: the first step's BN statistics max rel "
                f"{row['bn_stat_max_rel']:.3e} (tolerance {STAT_TOL})")
            if row["bn_stat_max_rel"] > STAT_TOL:
                raise AssertionError(f"BatchNorm statistics on the card differ from the CPU's: {row}")
        out["gpu_vs_cpu"][bn_mode] = row
        del gpu, cpu

    # 8.3 the timed step: TRAIN.BATCH_SIZE 32 from a dataset of 64 frames
    # through the loader, the augmentation and the step
    root = os.path.join(REPO, "build", "phase8_data")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    write_dataset(root, TRAIN_FRAMES, H, W)
    out["dataset_write_s"] = time.perf_counter() - t0
    # the host loader's datasets: 8 epochs' worth of links to the 64 frames
    # (so the timed steps stay in one epoch), of Sub rows and of Paeth rows
    # (the row filter that costs the reader most, written from the same
    # pixels); every batch is decoded, as for a dataset too large to cache
    hosts = {}
    for rows in ("sub", "paeth"):
        frames_dir = os.path.join(REPO, "build", f"phase8_{rows}_frames")
        hosts[rows] = os.path.join(REPO, "build", f"phase8_host_{rows}")
        for d in (frames_dir, hosts[rows]):
            shutil.rmtree(d, ignore_errors=True)
        os.makedirs(frames_dir)
        for sub in ("front", "waypoints"):
            os.makedirs(os.path.join(hosts[rows], sub))
        for i in range(TRAIN_FRAMES):
            src = os.path.join(root, "front", f"{i:06d}.png")
            if rows == "paeth":
                write_png(os.path.join(frames_dir, f"{i:06d}.png"), read_png(src), 4, level=1)
                src = os.path.join(frames_dir, f"{i:06d}.png")
            for j in range(i, 8 * TRAIN_FRAMES, TRAIN_FRAMES):
                os.symlink(src, os.path.join(hosts[rows], "front", f"{j:06d}.png"))
                os.symlink(os.path.join(root, "waypoints", f"{i:06d}.txt"),
                           os.path.join(hosts[rows], "waypoints", f"{j:06d}.txt"))
    decode = {}
    for name in ("sub", "paeth"):
        path = os.path.join(hosts[name], "front", "000001.png")
        t0 = time.perf_counter()
        for _ in range(3):
            read_png(path)
        decode[name] = (time.perf_counter() - t0) / 3 * 1e3
    out["decode_ms"] = decode
    log(f"train data: {TRAIN_FRAMES} frames of {W}x{H} written in {out['dataset_write_s']:.1f} s; one PNG "
        f"decodes in {decode['sub']:.1f} ms (Sub rows) / {decode['paeth']:.1f} ms (Paeth rows) on the host")
    out["decode_ms_per_frame"] = decode_throughput(hosts, smi)

    out["timed"] = {}
    for key, bn_mode, remat, source in (("frozen", "frozen", False, "device"), ("train", "train", False, "device"),
                                        ("frozen_remat", "frozen", True, "device"),
                                        ("frozen_host_sub", "frozen", False, "sub"),
                                        ("frozen_host_paeth", "frozen", False, "paeth")):
        cfg = load_cfg(CONFIGS[0])
        cfg.merge_from_list(["TRAIN.ROOT", root if source == "device" else hosts[source], "TPU.BN_MODE", bn_mode,
                             "TPU.REMAT", str(remat)])
        t0 = time.perf_counter()
        if source == "device":
            loader = maybe_device_resident(get_loader(cfg), cfg, dev)
            if not isinstance(loader, DeviceResidentLoader):
                raise AssertionError(f"{TRAIN_FRAMES} frames were not made device-resident")
        else:  # get_loader's Loader, as the train CLI makes it on the card
            loader = Loader(TrajDataset(cfg.TRAIN.ROOT, cache_decoded=False), batch_size=cfg.TRAIN.BATCH_SIZE,
                            num_workers=cfg.TRAIN.NUM_WORKERS, pin_memory=True)
        load_s = time.perf_counter() - t0
        st = create_train_state(build_model(cfg, device=dev, seed=0), cfg)
        # as the train CLI steps: one CUDA graph replay an iteration
        step = TrainProgram(make_train_step(make_schedule_from_cfg(cfg, dev), cfg), dev)
        augment = AugmentProgram(dev)
        data = iter(loader)

        def one(it):
            nonlocal data
            try:
                b = next(data)
            except StopIteration:
                data = iter(loader)
                b = next(data)
            b = {k: torch.as_tensor(v).to(dev, non_blocking=True) for k, v in b.items()}  # as the CLI does
            aug, g = cli.iteration_generators(it, dev)
            b["image"] = normalize_images(augment(b["image"], aug, it * cfg.TRAIN.BATCH_SIZE))
            return step(st, b, generator=g)

        # the first step is the program's eager step and its capture; the
        # phase-14 comparison with the eager step carries the repeats cut
        # here. The host loader's steps outnumber its 4 prefetched batches,
        # so that its p50 is its steady state
        n_warm, n_timed = (2, 3) if remat else (2, 12) if source != "device" else (2, 6)
        # the peak from the program's build on: a replay allocates nothing,
        # its activations live in the graph's pool, allocated at the capture
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for it in range(n_warm):
            one(it)
        torch.cuda.synchronize()
        times = []
        for it in range(n_warm, n_warm + n_timed):
            t0 = time.perf_counter()
            m = one(it)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2**20
        kernels.reset_launch_counts()
        m = one(n_warm + n_timed)
        torch.cuda.synchronize()
        got = {k: getattr(kernels, k).launches for k in launches}
        per = 2 if remat else 1
        want = {"fused_residual_block": 16 * per, "fused_conv1d_gn_mish": per}
        if got != want:
            raise AssertionError(f"train step {key}: launches {got} != {want}")
        for k in launches:
            launches[k] += got[k]
        busy = device_breakdown(lambda: one(n_warm + n_timed + 1))
        p50 = float(np.median(times))
        loss = float(m["loss"])
        out["timed"][key] = dict(step_ms_p50=p50, step_ms=times, samples_per_s=cfg.TRAIN.BATCH_SIZE / p50 * 1e3,
                                 peak_mib=peak, launches_per_step=got, profile=busy, loss=loss,
                                 loader_s=load_s, batch=cfg.TRAIN.BATCH_SIZE, data=source)
        log(f"train step {key}: B={cfg.TRAIN.BATCH_SIZE} at {W}x{H}, p50 {p50:.2f} ms over {n_timed} steps after "
            f"{n_warm} warm ({cfg.TRAIN.BATCH_SIZE / p50 * 1e3:.1f} samples/s), peak {peak:.1f} MiB, launches per "
            f"step {got}, loss {loss:.4f}; data {source} (loader built in {load_s:.1f} s); profiled step "
            f"{busy['wall_ms']:.2f} ms, device busy {busy['device_ms']:.2f} ms ({busy['busy_share']:.3f}), by "
            f"kind {busy['by_kind']}; on {smi}")
        if not np.isfinite(loss):
            raise AssertionError(f"train step {key}: loss {loss}")
        if source != "device":
            loader.close()
        del st, loader, data
    timed = out["timed"]
    log("train step through the host loader (decoder processes) beside the device-resident step, p50 ms / busy "
        "share: " + "; ".join(f"{k} {timed[k]['step_ms_p50']:.2f} / {timed[k]['profile']['busy_share']:.3f}"
                              for k in ("frozen", "frozen_host_sub", "frozen_host_paeth")) + f"; on {smi}")
    out["augmentation"] = augmentation(device_breakdown, smi, dev)
    for rows in ("sub", "paeth"):
        shutil.rmtree(hosts[rows], ignore_errors=True)
        shutil.rmtree(os.path.join(REPO, "build", f"phase8_{rows}_frames"), ignore_errors=True)

    # 8.4 the train CLI: 4 iterations saving at 2, then a run resumed from
    # checkpoint_2.pth; the import restores step, moments and EMA exactly
    runs = os.path.join(REPO, "build", "phase8_runs")
    shutil.rmtree(runs, ignore_errors=True)
    common = ["--device", str(dev), "--opts", "TRAIN.ROOT", root, "TRAIN.SAVE_INTERVAL", "2", "TRAIN.SAMPLE_INTERVAL", "0",
              "TRAIN.LOG_INTERVAL", "1"]
    t0 = time.perf_counter()
    first = cli.main(cli.parse_args(["--config", os.path.join(REPO, CONFIGS[0]), "--max-iter", "4"] + common
                                    + ["PROJECT_DIR", os.path.join(runs, "a")]))
    ck = os.path.join(runs, "a", "checkpoints")
    written = sorted(os.listdir(ck))
    cfg = create_cfg()  # the CLI's config
    merge_possible_with_base(cfg, os.path.join(REPO, CONFIGS[0]))
    fresh = create_train_state(build_model(cfg, device=dev, seed=1), cfg)
    import_torch_checkpoint(os.path.join(ck, "checkpoint_2.pth"), cfg, fresh)
    saved = torch.load(os.path.join(ck, "checkpoint_2.pth"), map_location="cpu", weights_only=False)
    params = list(fresh.model.parameters())
    exact = (fresh.step == 2 == saved["iter"]
             and all(torch.equal(fresh.optimizer.state[p]["exp_avg"].cpu(), saved["optimizer"]["state"][i]["exp_avg"])
                     and torch.equal(fresh.optimizer.state[p]["exp_avg_sq"].cpu(),
                                     saved["optimizer"]["state"][i]["exp_avg_sq"])
                     and float(fresh.optimizer.state[p]["step"]) == 2.0 for i, p in enumerate(params))
             and all(torch.equal(s.cpu(), v) for s, v in zip(fresh.ema.shadow_params,
                                                             saved["ema_state_dict"]["shadow_params"]))
             and fresh.ema.optimization_step == 2
             and all(torch.equal(v.cpu(), saved["state_dict"][k]) for k, v in fresh.model.state_dict().items()))
    del fresh, saved
    second = cli.main(cli.parse_args(["--config", os.path.join(REPO, CONFIGS[0]), "--max-iter", "4"] + common
                                     + ["PROJECT_DIR", os.path.join(runs, "b"), "TRAIN.RESUME",
                                        os.path.join(ck, "checkpoint_2.pth")]))
    resumed = sorted(os.listdir(os.path.join(runs, "b", "checkpoints")))
    diff = max((a - b).abs().max().item() for a, b in zip(first.model.parameters(), second.model.parameters()))
    cfg.merge_from_list(["TRAIN.ROOT", root])
    eval_out, _ = cli.sample_for_eval(cfg, cli.ema_model(first), make_schedule_from_cfg(cfg, dev), seed=0)
    ok = (written == ["checkpoint_2.pth", "final.pth"] and resumed == ["final.pth"] and exact
          and first.step == 4 == second.step and eval_out.shape == (cfg.EVAL.BATCH_SIZE, 16, 2)
          and np.isfinite(eval_out).all())
    out["cli"] = dict(written=written, resumed_written=resumed, restored_exactly=exact,
                      final_param_diff_unbroken_vs_resumed=diff, seconds=time.perf_counter() - t0)
    log(f"train CLI: wrote {written}; checkpoint_2.pth restored step, AdamW moments, EMA and weights "
        f"{'exactly' if exact else 'NOT exactly'}; the resumed run wrote {resumed} (final weights "
        f"{diff:.3e} from the unbroken run's: its loader restarts its epochs); evaluation sampling "
        f"{eval_out.shape}; {out['cli']['seconds']:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"train CLI: {out['cli']}")
    shutil.rmtree(runs, ignore_errors=True)
    return out


def distillation(load_cfg, device_breakdown, launches, smi, dev="cuda", extra_opts=()) -> dict:
    """Phase 9: progressive distillation on the card at full width.
    ``launches`` gathers the timed steps' launch counts into the kernels
    line. ``dev`` is the card and ``extra_opts`` none (another device and a
    smaller model only to rehearse the phase)."""
    import shutil

    import numpy as np
    import torch

    from autonomous_driving_with_diffusion_model_tpu_torch import distill as distill_cli
    from autonomous_driving_with_diffusion_model_tpu_torch.data import (
        DeviceResidentLoader,
        get_loader,
        maybe_device_resident,
        normalize_images,
    )
    from autonomous_driving_with_diffusion_model_tpu_torch.diffusion import (
        DistillDraws,
        grid_chain,
        make_distill_step,
        make_schedule_from_cfg,
    )
    from autonomous_driving_with_diffusion_model_tpu_torch.driving import DiffusionPlanner
    from autonomous_driving_with_diffusion_model_tpu_torch.models import build_model, init_scorer, train_scorer
    from autonomous_driving_with_diffusion_model_tpu_torch.ops import kernels
    from autonomous_driving_with_diffusion_model_tpu_torch.train import create_train_state, export_torch_checkpoint
    from autonomous_driving_with_diffusion_model_tpu_torch.train.program import DistillProgram
    from autonomous_driving_with_diffusion_model_tpu_torch.utils.constants import GuidanceType

    out = {}
    dev = torch.device(dev)

    def stage(cfg, d):
        """(teacher, student state, step, student steps) of the config's
        first stage on device d: seed 0's weights, the EVAL.SAMPLE_STEPS grid."""
        sched = make_schedule_from_cfg(cfg, d)
        grid = grid_chain(sched.num_train_timesteps, int(cfg.EVAL.SAMPLE_STEPS), 1)[0]
        init_state, step = make_distill_step(
            sched, grid, use_cond=GuidanceType[cfg.TRAIN.USE_COND], free_scale=float(cfg.GUIDANCE.FREE_SCALE),
            lr=1e-4, warmup=1, decay_steps=20)
        teacher = build_model(cfg, device=d, seed=0).requires_grad_(False)
        return teacher, init_state(teacher), step, len(grid.ts)

    # 9.1 one distill step, GPU against CPU: full width, B = 2, the same
    # weights, batch and draws; the student's first-step gradients by
    # phase 8's rule, each check shown to catch a planted fault
    cfg = load_cfg(CONFIGS[0])
    rng = np.random.default_rng(9)
    B, H, W = 2, cfg.TRAIN.IMAGE_HEIGHT, cfg.TRAIN.IMAGE_WIDTH
    batch = {"image": normalize_images(torch.from_numpy(rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8))),
             "trajs": torch.from_numpy(rng.uniform(-1, 1, (B, 16, 7)).astype(np.float32)),
             "target": torch.from_numpy(rng.uniform(-1, 1, (B, 2)).astype(np.float32))}
    n_grid = len(grid_chain(cfg.TRAIN.SAMPLE_STEPS, int(cfg.EVAL.SAMPLE_STEPS), 1)[0].ts)
    draws = DistillDraws(torch.from_numpy(rng.integers(0, n_grid, B)),
                         torch.from_numpy(rng.standard_normal((B, 16, 7)).astype(np.float32)))
    res = {}
    for d in (torch.device("cpu"), dev):
        t0 = time.perf_counter()
        teacher, st, step, _ = stage(cfg, d)
        m = step(st, teacher, {k: v.to(d) for k, v in batch.items()}, draws)
        res[d.type] = dict(loss=float(m["loss"]), seconds=time.perf_counter() - t0,
                           grads={n: p.grad.detach().cpu().clone() for n, p in st.student.named_parameters()})
        del teacher, st
    gpu, cpu = res[dev.type], res["cpu"]
    encoder = [n for n in cpu["grads"] if n.startswith("perception.")]
    unet = [n for n in cpu["grads"] if n not in encoder]
    row = dict(tensors=len(cpu["grads"]), loss=dict(gpu=gpu["loss"], cpu=cpu["loss"]),
               loss_rel=abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"]),
               seconds=dict(gpu=gpu["seconds"], cpu=cpu["seconds"]))
    row["grad_worst_over_tol"], row["grad_worst_tensor"] = grad_ratio(gpu["grads"], cpu["grads"], unet)
    row["by_norm_worst_over_tol"], row["by_norm_worst_tensor"] = norm_ratio(gpu["grads"], cpu["grads"], encoder)
    row["encoder_grad_rel_norm"] = rel_norm(gpu["grads"], cpu["grads"], encoder)
    block = next(n for n in unet if n.startswith("downs.0.0.") and n.endswith("weight"))
    enc = next(n for n in encoder if n.endswith("weight"))
    row["planted_faults_over_tol"] = {
        f"{block} gradient zeroed": grad_ratio({block: torch.zeros_like(gpu["grads"][block])}, cpu["grads"],
                                               [block])[0],
        f"{enc} gradient x (1 + 5e-2)": norm_ratio({enc: gpu["grads"][enc] * (1 + 5e-2)}, cpu["grads"], [enc])[0]}
    caught = all(r > 1.0 for r in row["planted_faults_over_tol"].values())
    ok = (row["loss_rel"] <= LOSS_RTOL and row["grad_worst_over_tol"] <= 1.0 and row["by_norm_worst_over_tol"] <= 1.0
          and np.isfinite(gpu["loss"]))
    log(f"distill GPU vs CPU, full width, B={B}, one step: loss GPU {gpu['loss']:.6f} CPU {cpu['loss']:.6f} (rel "
        f"{row['loss_rel']:.3e}, tolerance {LOSS_RTOL}); the student's first-step gradients of {len(unet)} U-Net "
        f"tensors: worst {row['grad_worst_over_tol']:.3f} of the tolerance ({STEP_GRAD_TOL} x the tensor's largest "
        f"+ {STEP_GRAD_FLOOR}) at {row['grad_worst_tensor']}; {len(encoder)} encoder tensors by norm: worst "
        f"{row['by_norm_worst_over_tol']:.3f} of the tolerance ({ENCODER_GRAD_RTOL} of the norm) at "
        f"{row['by_norm_worst_tensor']} ({row['encoder_grad_rel_norm']:.3e} of their norm); planted "
        + ", ".join(f"{k}: {r:.1f}" for k, r in row["planted_faults_over_tol"].items())
        + f" of the tolerance ({'caught' if caught else 'NOT caught'}); GPU {gpu['seconds']:.1f} s, CPU "
        f"{cpu['seconds']:.1f} s {'ok' if ok and caught else 'FAIL'}")
    if not caught:
        raise AssertionError(f"the distill gradient check does not catch a planted fault: {row}")
    if not ok:
        raise AssertionError(f"the GPU distill step differs from the CPU's: {row}")
    out["gpu_vs_cpu"] = row
    del res, gpu, cpu

    # 9.2 the timed distill step, TRAIN.BATCH_SIZE 32 from the 64 frames
    # device-resident, without guidance and under CFG
    root = os.path.join(REPO, "build", "phase8_data")
    if not os.path.isdir(root):
        write_dataset(root, TRAIN_FRAMES, H, W)
    out["timed"] = {}
    for path in CONFIGS[:2]:
        cfg = load_cfg(path)
        cfg.merge_from_list(["TRAIN.ROOT", root])
        loader = maybe_device_resident(get_loader(cfg), cfg, dev)
        if not isinstance(loader, DeviceResidentLoader):
            raise AssertionError(f"{TRAIN_FRAMES} frames were not made device-resident")
        teacher, st, step, n_steps = stage(cfg, dev)
        step = DistillProgram(step, dev)  # as the distill CLI steps: one CUDA graph replay an iteration
        data = iter(loader)

        def one(it):
            nonlocal data
            try:
                b = next(data)
            except StopIteration:
                data = iter(loader)
                b = next(data)
            b["image"] = normalize_images(b["image"])
            return step(st, teacher, b, generator=distill_cli.iteration_generator(0, it, dev))

        n_warm, n_timed = 2, 6  # the first is the program's eager step and its capture
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()  # from the build on, as in phase 8
        for it in range(n_warm):
            one(it)
        torch.cuda.synchronize()
        times = []
        for it in range(n_warm, n_warm + n_timed):
            t0 = time.perf_counter()
            m = one(it)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2**20
        kernels.reset_launch_counts()
        m = one(n_warm + n_timed)
        torch.cuda.synchronize()
        got = {k: getattr(kernels, k).launches for k in launches}
        fwd = 5 if cfg.TRAIN.USE_COND == "FREE_GUIDANCE" else 3  # teacher 2 (4 under CFG) + student 1
        want = {"fused_residual_block": 16 * fwd, "fused_conv1d_gn_mish": fwd}
        if got != want:
            raise AssertionError(f"distill step {path}: launches {got} != {want}")
        for k in launches:
            launches[k] += got[k]
        busy = device_breakdown(lambda: one(n_warm + n_timed + 1))
        p50 = float(np.median(times))
        loss = float(m["loss"])
        out["timed"][path] = dict(step_ms_p50=p50, step_ms=times, samples_per_s=cfg.TRAIN.BATCH_SIZE / p50 * 1e3,
                                  peak_mib=peak, launches_per_step=got, profile=busy, loss=loss,
                                  batch=cfg.TRAIN.BATCH_SIZE, student_steps=n_steps)
        log(f"distill step {path}: B={cfg.TRAIN.BATCH_SIZE} at {W}x{H}, a {n_steps}-step student, p50 {p50:.2f} ms "
            f"over {n_timed} steps after {n_warm} warm ({cfg.TRAIN.BATCH_SIZE / p50 * 1e3:.1f} samples/s), peak "
            f"{peak:.1f} MiB, launches per step {got} (expected {want}), loss {loss:.4f}; profiled step "
            f"{busy['wall_ms']:.2f} ms, device busy {busy['device_ms']:.2f} ms ({busy['busy_share']:.3f}), by kind "
            f"{busy['by_kind']}; top 'other' kernels (ms) {busy.get('top_other')}; on {smi}")
        if not np.isfinite(loss):
            raise AssertionError(f"distill step {path}: loss {loss}")
        del teacher, st, loader, data

    # 9.3 the distill CLI on the card from a teacher .pth: 100 -> 50 -> 25
    work = os.path.join(REPO, "build", "phase9")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = load_cfg(CONFIGS[0])
    teacher_pth = os.path.join(work, "teacher.pth")
    export_torch_checkpoint(create_train_state(build_model(cfg, device=dev, seed=0), cfg), cfg, teacher_pth)
    workdir = os.path.join(work, "distill")
    t0 = time.perf_counter()
    manifest = distill_cli.main(distill_cli.parse_args([
        "--config", os.path.join(REPO, CONFIGS[0]), "--checkpoint", teacher_pth, "--workdir", workdir,
        "--start-steps", str(DISTILL_START), "--stages", "2", "--iters", str(DISTILL_ITERS),
        *([] if dev.type == "cuda" else ["--device", str(dev)]), "--opts", "TRAIN.ROOT", root, *extra_opts]))
    cli_s = time.perf_counter() - t0
    written = sorted(os.listdir(workdir))
    ok = (written == ["distill.json", "student_25.pth", "student_50.pth"]
          and [s["num_steps"] for s in manifest["stages"]] == [50, 25]
          and all(np.isfinite(s["final_loss"]) for s in manifest["stages"]))
    out["cli"] = dict(written=written, stages=[{k: s[k] for k in ("num_steps", "final_loss", "seconds")}
                                               for s in manifest["stages"]], seconds=cli_s)
    log(f"distill CLI: --start-steps {DISTILL_START} --stages 2 --iters {DISTILL_ITERS} wrote {written} in "
        f"{cli_s:.1f} s; stages {out['cli']['stages']} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"distill CLI: {out['cli']}")

    # 9.4 the 25-step student deployed through the planner, GPU against CPU
    last = manifest["stages"][-1]
    cfg = load_cfg(CONFIGS[0])
    cfg.merge_from_list(["EVAL.CHECKPOINT", last["checkpoint"]])
    cfg.TPU.SAMPLE_TIMESTEPS = list(last["timesteps"])
    frames = np.random.default_rng(10).integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    gpu = DiffusionPlanner(cfg, seed=0, device=dev)
    kernels.reset_launch_counts()
    first = gpu.plan(frames[0])
    torch.cuda.synchronize()
    got = {k: getattr(kernels, k).launches for k in launches}
    want = {"fused_residual_block": 16 * len(last["timesteps"]), "fused_conv1d_gn_mish": len(last["timesteps"])}
    for k in launches:
        launches[k] += got[k]
    cpu = DiffusionPlanner(cfg, seed=0, device="cpu")
    cpu.init_trajs = gpu.init_trajs.cpu()
    ref = cpu.plan(frames[0])
    diff = float(np.abs(first - ref).max())
    gpu.plan(frames[1])  # warm
    torch.cuda.synchronize()
    times = []
    for i in range(5):
        t0 = time.perf_counter()
        gpu.plan(frames[i % 2])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    p50 = float(np.median(times))
    ok = got == want and np.allclose(first, ref, **PLAN_TOL) and np.isfinite(first).all()
    out["deploy"] = dict(steps=len(last["timesteps"]), launches=got, gpu_vs_cpu_max_abs_m=diff, plan_ms_p50=p50,
                         plan_ms=times)
    log(f"distill deploy: the {len(last['timesteps'])}-step student through DiffusionPlanner, launches {got} "
        f"(expected {want}), GPU vs CPU plan max_abs_diff={diff:.3e} m (PLAN_TOL {PLAN_TOL}), plan p50 {p50:.2f} ms "
        f"over 5 plans, on {smi} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"deployed student: {out['deploy']}")
    del gpu, cpu
    shutil.rmtree(work, ignore_errors=True)

    # 9.5 the learned scorer's fit on the card: N = 512 candidate sets of K =
    # 8, GPU against CPU from the same initial weights, then the timed fit
    rng = np.random.default_rng(11)
    trajs = rng.standard_normal((SCORER_N, SCORER_K, 16, 7)).astype(np.float32)
    trajs[..., :2] *= 5.0
    targets = (0.3 * rng.standard_normal((SCORER_N, 2))).astype(np.float32)
    outcomes = (np.linalg.norm(trajs[:, :, -1, :2] / 23.3 - targets[:, None], axis=-1)
                + 0.1 * rng.standard_normal((SCORER_N, SCORER_K))).astype(np.float32)
    groups = np.arange(SCORER_N) // 8
    p0 = init_scorer(0)
    fits = {}
    for d in ("cpu", dev):
        fits[str(d)] = train_scorer(trajs, targets, outcomes, steps=SCORER_CHECK_STEPS, groups=groups, params=p0,
                                    device=d)
    (pg, mg), (pc, mc) = fits[str(dev)], fits["cpu"]
    worst = max(float(np.abs(pg[a][b] - pc[a][b]).max() / (SCORER_PARAM_RTOL * np.abs(pc[a][b] - p0[a][b]).max()
                                                            + 1e-7)) for a in pc for b in pc[a])
    mse_rel = abs(mg["val_mse"] - mc["val_mse"]) / abs(mc["val_mse"])
    ok = mg["val_indices"] == mc["val_indices"] and worst <= 1.0 and mse_rel <= SCORER_MSE_RTOL
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, timed = train_scorer(trajs, targets, outcomes, groups=groups, params=p0, device=dev)
    fit_s = time.perf_counter() - t0
    out["scorer"] = dict(n=SCORER_N, k=SCORER_K, check_steps=SCORER_CHECK_STEPS, param_worst_over_tol=worst,
                         val_mse_rel=mse_rel, metrics_gpu={k: v for k, v in mg.items() if k != "val_indices"},
                         metrics_cpu={k: v for k, v in mc.items() if k != "val_indices"}, fit_s=fit_s,
                         fit_metrics={k: v for k, v in timed.items() if k != "val_indices"})
    log(f"scorer fit: N={SCORER_N} K={SCORER_K}, {SCORER_CHECK_STEPS} steps GPU vs CPU from the same weights: "
        f"parameters worst {worst:.3f} of the tolerance ({SCORER_PARAM_RTOL} of the largest move), val MSE "
        f"{mg['val_mse']:.6f} / {mc['val_mse']:.6f} (rel {mse_rel:.2e}), regret {mg['val_top1_regret']:.4f} / "
        f"{mc['val_top1_regret']:.4f}; the default 3000-step fit on the card {fit_s:.2f} s (val MSE "
        f"{timed['val_mse']:.4f}, regret {timed['val_top1_regret']:.4f}, random {timed['val_top1_regret_random']:.4f})"
        f" on {smi} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"scorer fit on the card differs from the CPU's: {out['scorer']}")
    return out


def data_parallel(load_cfg, smi, dev="cuda", extra_opts=()) -> dict:
    """Phase 10: data-parallel training on the one card. (a) the train CLI
    under torchrun on one NCCL rank, its encoder started from a
    torchvision ResNet-34 ``.pth`` the phase writes, and one iteration of
    the CLI in this process from the same file (the encoder on the card
    the file's); (b) two gloo ranks on the card at
    TRAIN.BATCH_SIZE 16 each against this process's step at 32 on the same
    global batch and draws, BatchNorm frozen and train. Every subprocess has
    a timeout; a failure fails the phase. ``dev`` is the card and
    ``extra_opts`` none (the CPU, gloo and a smaller model only to rehearse
    the phase)."""
    import shutil
    import socket

    import torch

    from autonomous_driving_with_diffusion_model_tpu_torch.models import PERCEPTION_BUILDERS, init_parameters
    from autonomous_driving_with_diffusion_model_tpu_torch.parallel.check import case_config, run_case
    from autonomous_driving_with_diffusion_model_tpu_torch.train import cli

    out = {}
    cuda = torch.device(dev).type == "cuda"
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = REPO
    work = os.path.join(REPO, "build", "phase10")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    # a torchvision-layout ResNet-34 .pth for TRAIN.PRETRAINED_BACKBONE: a
    # 1000-way fc, running statistics from one train-mode forward
    net = init_parameters(PERCEPTION_BUILDERS["resnet34"](num_classes=1000),
                          torch.Generator().manual_seed(3)).to(dev).train()
    with torch.no_grad():
        net(torch.randn(2, 64, 96, 3, generator=torch.Generator().manual_seed(3)).to(dev))
    backbone = os.path.join(work, "resnet34_torchvision.pth")
    tv = {k: v.cpu() for k, v in net.state_dict().items()}
    torch.save(tv, backbone)
    del net

    # 10.1 NCCL: torchrun, one rank, the train CLI for NCCL_ITERS iterations from
    # the backbone: DDP's 11 eager steps, then its step (the all-reduce in it)
    # captured and replayed
    root = os.path.join(REPO, "build", "phase8_data")
    project = os.path.join(work, "nccl")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1", "-m",
         f"{PKG}.train", "--config", os.path.join(REPO, CONFIGS[0]), "--max-iter", str(NCCL_ITERS),
         *([] if cuda else ["--device", "cpu"]), "--opts", "TRAIN.ROOT", root, "PROJECT_DIR", project,
         "TRAIN.SAMPLE_INTERVAL", "0", "TRAIN.LOG_INTERVAL", "1", "TRAIN.PRETRAINED_BACKBONE", backbone,
         *extra_opts],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT_S)
    nccl_s = time.perf_counter() - t0
    train_log = ""
    if os.path.exists(os.path.join(project, "train.log")):
        with open(os.path.join(project, "train.log")) as f:
            train_log = f.read()
    checkpoints = os.path.join(project, "checkpoints")
    written = sorted(os.listdir(checkpoints)) if os.path.isdir(checkpoints) else []
    ok = (proc.returncode == 0 and written == ["final.pth"] and "Data-parallel: 1 rank(s)" in train_log
          and ("(nccl)" if cuda else "(gloo)") in train_log and f"iter: [{NCCL_ITERS}/{NCCL_ITERS}]" in train_log
          and f"Initializing perception from ImageNet backbone {backbone}" in train_log
          and ("captured as a CUDA graph after 11 eager step(s)" in train_log or not cuda))
    out["nccl"] = dict(rc=proc.returncode, written=written, seconds=nccl_s)
    log(f"DDP NCCL: torchrun --nproc_per_node 1 train CLI, {NCCL_ITERS} iterations from a torchvision backbone: "
        f"rc {proc.returncode}, wrote {written}, {nccl_s:.1f} s; log: "
        f"{[l.split('| ')[-1] for l in train_log.splitlines() if any(w in l for w in ('Data-parallel', 'backbone', 'captured'))]} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"DDP NCCL run: {out['nccl']}\n{proc.stderr[-4000:]}")

    # 10.1b the train CLI in this process, one iteration from the backbone: the
    # first step's LR is 0 and BatchNorm frozen, so the encoder on the card
    # after it is the file's, bit for bit; the fc head the model's own
    state = cli.main(cli.parse_args(
        ["--config", os.path.join(REPO, CONFIGS[0]), "--max-iter", "1", "--device", str(dev), "--opts",
         "TRAIN.ROOT", root, "PROJECT_DIR", os.path.join(work, "backbone"), "TRAIN.SAMPLE_INTERVAL", "0",
         "TRAIN.PRETRAINED_BACKBONE", backbone, *extra_opts]))
    enc = state.model.perception.state_dict()
    compared = [k for k in tv if not k.startswith("fc.") and not k.endswith("num_batches_tracked")]
    differ = [k for k in compared
              if enc[k].device.type != torch.device(dev).type or not torch.equal(enc[k].cpu(), tv[k])]
    ok = not differ and state.step == 1 and enc["fc.weight"].shape[0] != 1000
    out["backbone"] = dict(tensors_compared=len(compared), differ=differ, fc_shape=list(enc["fc.weight"].shape))
    log(f"TRAIN.PRETRAINED_BACKBONE: after one iteration of the train CLI the encoder's {len(compared)} weights "
        f"and running statistics on the card equal the file's: {not differ}; the fc head "
        f"{tuple(enc['fc.weight'].shape)} is the model's own {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"pretrained backbone: {out['backbone']}")
    del state, enc

    # 10.2 two gloo ranks on the card against one process on the global batch
    B = int(load_cfg(CONFIGS[0]).TRAIN.BATCH_SIZE) // DDP_WORLD
    cases = [{"name": bn, "batch": B, "steps": 2, "opts": ["TPU.BN_MODE", bn, "TRAIN.LR_WARMUP", "1", *extra_opts]}
             for bn in ("frozen", "train")]
    with open(os.path.join(work, "cases.json"), "w") as f:
        json.dump(cases, f)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", f"{PKG}.parallel.check", "--rank", str(r), "--world", str(DDP_WORLD), "--port",
         str(port), "--device", str(dev), "--backend", "gloo", "--local-rank", "0", "--config",
         os.path.join(REPO, CONFIGS[0]), "--cases", os.path.join(work, "cases.json"), "--out", work],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True) for r in range(DDP_WORLD)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=SUBPROCESS_TIMEOUT_S)
            errs.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks_s = time.perf_counter() - t0
    for rc, err in errs:
        if rc != 0:
            raise AssertionError(f"DDP gloo rank failed (rc {rc}):\n{err[-4000:]}")
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False) for r in range(DDP_WORLD)]
    out["gloo"] = {"ranks_seconds": ranks_s}
    for case in cases:
        name = case["name"]
        r0, r1 = ranks[0][name], ranks[1][name]
        identical = r0["losses"] == r1["losses"] and all(
            torch.equal(r0[k][n], r1[k][n]) for k in ("grads", "params", "ema") for n in r0[k])
        t0 = time.perf_counter()
        want = run_case(case_config(case["opts"], os.path.join(REPO, CONFIGS[0])), dev, B * DDP_WORLD, case["steps"])
        one_s = time.perf_counter() - t0
        encoder = [n for n in want["grads"] if n.startswith("perception.")]
        unet = [n for n in want["grads"] if n not in encoder]
        row = dict(ranks_identical=identical, losses=dict(ranks=r0["losses"], one_process=want["losses"]),
                   one_process_s=one_s)
        row["loss_max_rel"] = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], want["losses"]))
        row["grad_worst_over_tol"], row["grad_worst_tensor"] = grad_ratio(r0["grads"], want["grads"], unet)
        row["encoder_grad_rel_norm"] = rel_norm(r0["grads"], want["grads"], encoder)
        ok = identical and row["loss_max_rel"] <= LOSS_RTOL and row["grad_worst_over_tol"] <= 1.0
        if name == "frozen":  # the encoder by each tensor's norm, as in phase 8
            row["by_norm_worst_over_tol"], row["by_norm_worst_tensor"] = norm_ratio(r0["grads"], want["grads"],
                                                                                    encoder)
            ok = ok and row["by_norm_worst_over_tol"] <= 1.0
        else:
            row["bn_stat_max_rel"] = max(float(((r0["stats_first"][k] - v).abs() / (v.abs() + 1.0)).max())
                                         for k, v in want["stats_first"].items())
            ok = ok and row["bn_stat_max_rel"] <= STAT_TOL
        out["gloo"][name] = row
        log(f"DDP gloo, {DDP_WORLD} ranks on the card at B={B} each against one process at B={B * DDP_WORLD}, "
            f"BN_MODE {name}: ranks identical {identical}; losses {r0['losses']} vs {want['losses']} (max rel "
            f"{row['loss_max_rel']:.3e}); first-step gradients of {len(unet)} U-Net tensors worst "
            f"{row['grad_worst_over_tol']:.3f} of the tolerance at {row['grad_worst_tensor']}; the encoder "
            f"{row['encoder_grad_rel_norm']:.3e} of its norm"
            + (f", by tensor worst {row['by_norm_worst_over_tol']:.3f} of {ENCODER_GRAD_RTOL} of the norm at "
               f"{row['by_norm_worst_tensor']}" if name == "frozen" else
               f" (reported, as in phase 8); BN statistics max rel {row['bn_stat_max_rel']:.3e} (tolerance "
               f"{STAT_TOL})")
            + f"; ranks {ranks_s:.1f} s for both cases, one process {one_s:.1f} s {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"two gloo ranks differ from one process ({name}): {row}")
        del want
    shutil.rmtree(work, ignore_errors=True)
    return out


def carla_task(spec):
    """tests/test_integration_episode.py's task (``spec``: the port's
    ``TransformSpec``): a fixed route from x = 5 to 100 through a red light
    at x = 57 (the caller places it), 3 walkers and a scenario vehicle on its
    own route ahead."""
    return {
        "weather": "ClearNoon", "route_id": 0, "num_zombie_vehicles": 0, "num_zombie_walkers": 3,
        "ego_route": [spec(x=5.0, y=0.0), spec(x=100.0, y=0.0)], "endless": False, "target_speed": 6.0,
        "scenario_actors": {"adv": [spec(x=110.0, y=0.0), spec(x=140.0, y=0.0)]},
        "scenario_actor_configs": {"adv": {"model": "vehicle.*", "agent_entry_point": "basic_agent:BasicAgent",
                                           "agent_kwargs": {"target_speed": 4.0}}},
    }


def carla(load_cfg, device_breakdown, launches, smi, dev="cuda", extra_opts=()) -> dict:
    """Phase 11: the CARLA env layer on the card, over ``tests/mock_carla.py``
    installed as ``carla``. Per config an ``InteractAgent`` on the card
    drives ``CarlaDrivingEnv`` through the integration task, in turns with
    the same planner on ``FakeDrivingEnv`` (carla, fake, fake, carla; 10
    ticks each after a warm one): tick and env ``step`` times, launches per
    tick, one profiled tick, the counters and the episode's stats so far,
    and the host's garbage collections during the ticks; under CFG a
    CPU agent with the same weights and init noise shadows 10 more ticks from
    the same observations (plans within PLAN_TOL, raw controls within
    CONTROL_TOL). Then ``evaluate_cli`` without ``--fake-env`` (one Endless
    route, 20 steps: a "carla" record whose route length is the env's), the
    collector writing COLLECT_SAMPLES samples from the env under the expert,
    the audit of them, and one training step at B = COLLECT_SAMPLES from them.
    ``dev`` is the card and ``extra_opts`` none (the CPU and a smaller model
    only to rehearse the phase)."""
    import dataclasses
    import gc
    import shutil

    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import mock_carla

    sys.modules["carla"] = mock_carla
    from autonomous_driving_with_diffusion_model_tpu_torch.data import augment_batch, get_loader, normalize_images
    from autonomous_driving_with_diffusion_model_tpu_torch.data.validate import validate_dataset
    from autonomous_driving_with_diffusion_model_tpu_torch.diffusion import make_schedule_from_cfg
    from autonomous_driving_with_diffusion_model_tpu_torch.driving import (
        DiffusionPlanner,
        FakeDrivingEnv,
        InteractAgent,
        evaluate_cli,
    )
    from autonomous_driving_with_diffusion_model_tpu_torch.driving.scoring import episode_stats
    from autonomous_driving_with_diffusion_model_tpu_torch.models import build_model
    from autonomous_driving_with_diffusion_model_tpu_torch.sim import DataCollector, carla_env
    from autonomous_driving_with_diffusion_model_tpu_torch.sim.suites import TransformSpec
    from autonomous_driving_with_diffusion_model_tpu_torch.train import cli, create_train_state, make_train_step

    dev = torch.device(dev)

    def load(path):
        cfg = load_cfg(path)
        if extra_opts:
            cfg.merge_from_list(list(extra_opts))
        return cfg

    def steps_of(cfg):
        return len(cfg.TPU.SAMPLE_TIMESTEPS) or cfg.EVAL.SAMPLE_STEPS

    def pct(xs, q):
        return float(np.percentile(xs, q))

    def make_env():
        mock_carla._Vehicle._next_id = 1
        env = carla_env.CarlaDrivingEnv(seed=0, tasks=[carla_task(TransformSpec)])
        env.world.actors.append(mock_carla.TrafficLight(x=57.0, state="Red"))
        return env

    def stats_so_far(env):
        return episode_stats(env.counters, route_length_m=env._route_length_m(), route_completed_m=env.completed_m,
                             is_route_completed=False, endless=env._endless, timeout=False,
                             episode_length=env.steps, total_reward=env.episode_reward)

    out = {"configs": {}}
    t_phase = time.perf_counter()
    for path in CONFIGS:
        cfg = load(path)
        n_fwd = steps_of(cfg)
        per_tick = {"fused_residual_block": 16 * n_fwd, "fused_conv1d_gn_mish": n_fwd}
        gpu = DiffusionPlanner(cfg, seed=0, device=dev)
        env = make_env()
        agent = InteractAgent(cfg, env, planner=gpu)
        state = env.reset()
        # the same agent's planner on FakeDrivingEnv at 900x256 (phase 6's env), in
        # turns with the native env (carla, fake, fake, carla), so that what the
        # env layer adds to a tick is read against a tick without it in this call
        fake = FakeDrivingEnv(image_hw=(256, 900), seed=0)
        fake_agent = InteractAgent(cfg, fake, planner=gpu)
        states = {"carla": state, "fake": fake.reset()}
        sides = {"carla": (agent, env), "fake": (fake_agent, fake)}
        tick_ms, env_ms = {"carla": [], "fake": []}, {"carla": [], "fake": []}
        resets, runs, half = 0, [], LATENCY_TICKS // 2

        def run_ticks(mode):
            nonlocal resets
            a, e = sides[mode]
            s = states[mode]
            for i in range(half + 1):
                t0 = time.perf_counter()
                control = a.compute_control(s)
                t1 = time.perf_counter()
                s, _, done, _ = e.step({0: control})
                t2 = time.perf_counter()
                if i:  # the first tick of each run is a warm one
                    tick_ms[mode].append((t2 - t0) * 1e3)
                    env_ms[mode].append((t2 - t1) * 1e3)
                if not np.isfinite(control).all():
                    raise AssertionError(f"{path}: non-finite control {control}")
                if done:  # a random-weight planner may end an episode early
                    s = e.reset()
                    resets += mode == "carla"
            states[mode] = s

        host_objects = len(gc.get_objects())
        gc_before = [g["collections"] for g in gc.get_stats()]
        for mode in ("carla", "fake", "fake", "carla"):
            _, got = counted(launches, lambda: run_ticks(mode))
            want = {k: v * (half + 1) for k, v in per_tick.items()}
            if got != want:
                raise AssertionError(f"{path} on {mode}: launches {got} != {want}")
            runs.append(dict(mode=mode, tick_ms_p50=pct(tick_ms[mode][-half:], 50), launches=got))
        gc_runs = [g["collections"] - b for g, b in zip(gc.get_stats(), gc_before)]
        state = states["carla"]
        busy = device_breakdown(lambda: env.step({0: agent.compute_control(state)})[0])
        state = env.last_obs
        row = {"steps": n_fwd, "launches_per_tick": per_tick, "runs": runs,
               "tick_ms_p50": pct(tick_ms["carla"], 50), "tick_ms_p90": pct(tick_ms["carla"], 90),
               "tick_ms": tick_ms["carla"], "env_step_ms_p50": pct(env_ms["carla"], 50),
               "env_step_ms_p90": pct(env_ms["carla"], 90), "env_step_ms": env_ms["carla"],
               "fake_tick_ms_p50": pct(tick_ms["fake"], 50), "fake_tick_ms_p90": pct(tick_ms["fake"], 90),
               "fake_tick_ms": tick_ms["fake"], "fake_env_step_ms_p50": pct(env_ms["fake"], 50),
               "episode_resets": resets, "profiled_tick": busy, "host_objects_tracked": host_objects,
               "gc_collections_during_ticks": gc_runs}
        log(f"carla {path}: tick p50 {row['tick_ms_p50']:.2f} ms, p90 {row['tick_ms_p90']:.2f} ms over "
            f"{2 * half} ticks of CarlaDrivingEnv (mock_carla, 900x256), the env's step p50 "
            f"{row['env_step_ms_p50']:.2f} ms, p90 {row['env_step_ms_p90']:.2f} ms of them; in turns with "
            f"FakeDrivingEnv 900x256: tick p50 {row['fake_tick_ms_p50']:.2f} ms, p90 {row['fake_tick_ms_p90']:.2f} "
            f"ms, its step p50 {row['fake_env_step_ms_p50']:.2f} ms (run p50s "
            + ", ".join(f"{r['mode']} {r['tick_ms_p50']:.2f}" for r in runs)
            + f"; each run after one warm tick); launches per tick {per_tick}; profiled tick "
            f"{busy['wall_ms']:.2f} ms, device busy {busy['device_ms']:.2f} ms ({busy['busy_share']:.3f}); "
            f"episode resets {resets}; {host_objects} objects tracked by the collector, collections per "
            f"generation during the ticks {gc_runs}; on {smi}")
        del fake, fake_agent

        if path == CONFIGS[1]:  # the CFG shadow: a CPU agent plans from the same observations
            cpu = DiffusionPlanner(cfg, seed=0, device="cpu")
            cpu.init_trajs = gpu.init_trajs.cpu()
            frames = {"gpu": [], "cpu": []}
            gpu_agent = InteractAgent(cfg, env, planner=gpu, on_frame=lambda s, t, c: frames["gpu"].append((t, c)))
            shadow = InteractAgent(cfg, None, planner=cpu, on_frame=lambda s, t, c: frames["cpu"].append((t, c)))
            row["shadow"] = []
            for tick in range(SHADOW_TICKS):
                _, got = counted(launches, lambda: gpu_agent.compute_control(state))
                if got != per_tick:
                    raise AssertionError(f"{path} shadow tick {tick}: launches {got} != {per_tick}")
                shadow.compute_control(state)
                (tg, cg), (tc, cc) = frames["gpu"][tick], frames["cpu"][tick]
                plan_diff = float(np.abs(tg - tc).max())
                raw_diff = float(np.abs(tg[0, 0, -3:] - tc[0, 0, -3:]).max())
                branch = not near_threshold(tc[0, 0, -3:], CONTROL_TOL)
                ok = (np.allclose(tg, tc, **PLAN_TOL) and raw_diff <= CONTROL_TOL
                      and (not branch or (np.array_equal(cg == 0, cc == 0)
                                          and np.abs(cg - cc).max() <= CONTROL_TOL)))
                row["shadow"].append(dict(tick=tick, plan_max_abs_m=plan_diff, raw_control_max_abs=raw_diff,
                                          controls_compared=branch, control_gpu=cg.tolist(),
                                          control_cpu=cc.tolist()))
                log(f"carla {path} shadow tick {tick}: GPU vs CPU plan max_abs_diff {plan_diff:.3e} m, raw "
                    f"controls {raw_diff:.3e}; controls {[round(float(v), 4) for v in cg]} "
                    f"({'compared' if branch else 'raw near a threshold: branch not compared'}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{path} shadow tick {tick}: the CPU agent's plan differs")
                state, _, done, _ = env.step({0: cg})
                if done:
                    raise AssertionError(f"{path}: the episode ended during the shadow ticks")
            del cpu, shadow, gpu_agent
        row["counters"] = dataclasses.asdict(env.counters)
        row["episode_stat"] = {k: float(v) for k, v in stats_so_far(env).items()}
        log(f"carla {path}: after {env.steps} steps counters {row['counters']}; episode_stat so far "
            f"{ {k: round(v, 4) for k, v in row['episode_stat'].items()} }")
        env.close()
        out["configs"][path] = row
        del gpu, agent

    # 11.2 the evaluation CLI on the native env
    ckpt = os.path.join(REPO, "chiprun_out", "eval_carla_ckpt.json")
    os.makedirs(os.path.dirname(ckpt), exist_ok=True)
    if os.path.exists(ckpt):
        os.remove(ckpt)  # a resumed run would skip the route
    traced = []
    native = carla_env.CarlaDrivingEnv

    class Traced(native):
        def reset(self):
            obs = super().reset()
            traced.append(self._route_length_m())
            return obs

    argv = ["--env-id", "Endless-v0", "--weather-group", "simple", "--max-steps", str(EVAL_STEPS),
            "--checkpoint-json", ckpt]
    if dev.type != "cuda":
        argv += ["--device", str(dev)]
    if extra_opts:
        argv += ["--opts", *extra_opts]
    mock_carla._Vehicle._next_id = 1
    carla_env.CarlaDrivingEnv = Traced
    t0 = time.perf_counter()
    try:
        data, got = counted(launches, lambda: evaluate_cli.main(argv))
    finally:
        carla_env.CarlaDrivingEnv = native
    records = data["_checkpoint"]["records"]
    n_fwd = steps_of(load(CONFIGS[0]))
    ok = (len(records) == 1 and records[0]["meta"]["env_kind"] == "carla" and records[0]["num_steps"] == EVAL_STEPS
          and records[0]["status"] == "Completed" and len(traced) == 1 and traced[0] > 0
          and records[0]["meta"]["route_length"] == traced[0]
          and got == {"fused_residual_block": 16 * n_fwd * EVAL_STEPS, "fused_conv1d_gn_mish": n_fwd * EVAL_STEPS})
    out["evaluate_cli"] = dict(record=records[0] if records else None, launches=got, traced_length_m=traced,
                               seconds=time.perf_counter() - t0)
    log(f"carla evaluate_cli (no --fake-env): {len(records)} record(s): "
        + "; ".join(f"{r['route_id']} {r['status']} num_steps {r['num_steps']} meta {r['meta']} scores "
                    f"{r['scores']}" for r in records)
        + f"; the env's traced length {traced}; launches {got}; {out['evaluate_cli']['seconds']:.1f} s "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"evaluate_cli on the CARLA env: {records}, traced {traced}, launches {got}")

    # 11.3 collection under the expert, the audit, one training step from the samples
    root = os.path.join(REPO, "build", "phase11_data")
    shutil.rmtree(root, ignore_errors=True)
    mock_carla._Vehicle._next_id = 1
    env = carla_env.CarlaDrivingEnv(seed=2, num_zombie_vehicles=2)
    t0 = time.perf_counter()
    saved = DataCollector(env, root, total_to_save=COLLECT_SAMPLES, save_every_n_frame=1,
                          buffer_frames=2).run(max_env_steps=20 * COLLECT_SAMPLES)
    collect_s = time.perf_counter() - t0
    env.close()
    audit = validate_dataset(root)
    ok = (saved == COLLECT_SAMPLES and audit["ok"] and audit["num_valid_samples"] == COLLECT_SAMPLES
          and audit["image_hw"] == (256, 900))
    out["collect"] = dict(saved=saved, seconds=collect_s, audit=audit)
    log(f"carla collect: {saved} samples from CarlaDrivingEnv under the expert in {collect_s:.2f} s (PNGs by "
        f"data/png.py); validate_dataset ok {audit['ok']}, valid {audit['num_valid_samples']}, image_hw "
        f"{audit['image_hw']}, red-light fraction {audit.get('red_light_fraction')}, action means "
        f"{audit.get('action_means')} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"collection: saved {saved}, audit {audit}")
    cfg = load(CONFIGS[0])
    cfg.merge_from_list(["TRAIN.ROOT", root, "TRAIN.BATCH_SIZE", str(COLLECT_SAMPLES)])
    batch = next(iter(get_loader(cfg)))
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    st = create_train_state(build_model(cfg, device=dev, seed=0), cfg)
    step = make_train_step(make_schedule_from_cfg(cfg, dev), cfg)
    aug, gen = cli.iteration_generators(0, dev)
    batch["image"] = normalize_images(augment_batch(batch["image"], aug, 0))
    step_ms = []
    for i in range(2):  # the first step includes cuDNN's first choice of algorithms
        t0 = time.perf_counter()
        if i == 0:
            loss, got = counted(launches, lambda: float(step(st, batch, generator=gen)["loss"]))
        else:
            second = float(step(st, batch, generator=gen)["loss"])
        step_ms.append((time.perf_counter() - t0) * 1e3)
    ok = (bool(np.isfinite(loss)) and bool(np.isfinite(second))
          and got == {"fused_residual_block": 16, "fused_conv1d_gn_mish": 1})
    out["train_step"] = dict(batch=COLLECT_SAMPLES, loss=loss, second_loss=second, launches=got, step_ms=step_ms)
    log(f"carla train step on the collected samples, B = {COLLECT_SAMPLES}: loss {loss:.6f} (second step "
        f"{second:.6f}), launches {got}, first step {step_ms[0]:.1f} ms (cuDNN's first choices included), second "
        f"{step_ms[1]:.1f} ms; on {smi} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"training step on the collected data: loss {loss}, launches {got}")
    jax_side = sorted(m for m in sys.modules if m.split(".")[0] == "autonomous_driving_with_diffusion_model_tpu")
    if jax_side:
        raise AssertionError(f"phase 11 imported the JAX package: {jax_side}")
    sys.modules.pop("carla", None)
    out["seconds"] = time.perf_counter() - t_phase
    return out


def learnability(device_breakdown, launches, smi, dev="cuda", quick=False) -> dict:
    """Phase 12: the learnability harness (``learnability.py``) at full
    width, ResNet-34 at 900x256, ``MODEL.DIM`` 64, bfloat16, BatchNorm
    frozen: (a) its dataset (120 training frames with the port's PNG writer,
    24 held-out samples); (b) one bf16 training step at B = 2 on the card
    against the CPU's fp32 and bf16 steps from the same weights, batch and
    draws; (c) its ``train`` (the train CLI) at B = LEARN_BATCH for
    LEARN_ITERS iterations: the meter's step p50, samples/s, peak memory,
    launches per step, and one profiled step outside the CLI; (d) its
    ``evaluate`` from that checkpoint at LEARN_TICKS ticks (launches per
    plan; the held-out plans against a CPU planner's); (e) its ``distill``,
    8 -> 4 -> 2 steps, and the 2-step student's plans. ``dev`` is the card
    and ``quick`` False (the CPU and the tiny model only to rehearse it)."""
    import shutil

    import numpy as np
    import torch

    from autonomous_driving_with_diffusion_model_tpu_torch import learnability as lb
    from autonomous_driving_with_diffusion_model_tpu_torch.data import (
        TrajDataset,
        augment_batch,
        get_loader,
        maybe_device_resident,
        normalize_images,
    )
    from autonomous_driving_with_diffusion_model_tpu_torch.diffusion import make_schedule_from_cfg
    from autonomous_driving_with_diffusion_model_tpu_torch.driving import DiffusionPlanner
    from autonomous_driving_with_diffusion_model_tpu_torch.models import build_model
    from autonomous_driving_with_diffusion_model_tpu_torch.train import (
        StepDraws,
        cli,
        create_train_state,
        make_train_step,
    )
    from autonomous_driving_with_diffusion_model_tpu_torch.utils.config import create_cfg

    dev = torch.device(dev)
    hw = (64, 96) if quick else (256, 900)
    out = {}
    t_phase = time.perf_counter()
    work = os.path.join(REPO, "build", "phase12")
    shutil.rmtree(work, ignore_errors=True)
    root, run_dir = os.path.join(work, "data"), os.path.join(work, "run")

    def per_forward(n):
        return {"fused_residual_block": 16 * n, "fused_conv1d_gn_mish": n}

    plans = []  # the denoising steps of each plan the planners begin
    plan_begin = DiffusionPlanner.plan_begin

    def counting_begin(self, *a, **kw):
        plans.append(self._sample.num_steps)
        return plan_begin(self, *a, **kw)

    # 12.a the dataset
    t0 = time.perf_counter()
    samples = lb.write_dataset(root, 40, seed=0, hw=hw)
    heldout = lb.heldout_samples(8)
    out["dataset"] = dict(n_train=len(samples), n_heldout=len(heldout), seconds=time.perf_counter() - t0)
    log(f"learnability data: {len(samples)} training frames of {hw[1]}x{hw[0]} written by data/png.py in "
        f"{out['dataset']['seconds']:.1f} s; {len(heldout)} held-out samples")

    # 12.b one bf16 step at B = 2 on the card against the CPU's fp32 and
    # bf16 steps: the same weights, batch (two training frames) and draws
    base = lb.train_opts(root, run_dir, hw=hw, max_iter=LEARN_ITERS, batch=LEARN_BATCH, quick=quick, log_interval=1)

    def config(*opts):
        cfg = create_cfg()
        cfg.merge_from_list(base + list(opts))
        return cfg

    ds = TrajDataset(root)
    items = [ds[0], ds[len(ds) - 1]]  # a left and a right curve
    batch = {"image": normalize_images(torch.from_numpy(np.stack([it["image"] for it in items]))),
             "trajs": torch.from_numpy(np.stack([it["trajs"] for it in items])),
             "target": torch.from_numpy(np.stack([it["target"] for it in items]))}
    rng = np.random.default_rng(12)
    B = len(items)
    draws = StepDraws(torch.from_numpy(rng.integers(0, config().TRAIN.TIME_STEPS, B)),
                      torch.from_numpy(rng.standard_normal((B, 16, 7)).astype(np.float32)), torch.tensor([True]))

    def one_step(dtype, d):
        t0 = time.perf_counter()
        cfg = config("TPU.COMPUTE_DTYPE", dtype)
        st = create_train_state(build_model(cfg, device=d, seed=0), cfg)
        m = make_train_step(make_schedule_from_cfg(cfg, d), cfg)(st, {k: v.to(d) for k, v in batch.items()}, draws)
        return dict(loss=float(m["loss"]), seconds=time.perf_counter() - t0,
                    grads={n: p.grad.detach().float().cpu() for n, p in st.model.named_parameters()})

    f32 = one_step("float32", torch.device("cpu"))
    b16 = one_step("bfloat16", torch.device("cpu"))
    card, got = counted(launches, lambda: one_step("bfloat16", dev))
    norm = sum(float(v.square().sum()) for v in f32["grads"].values()) ** 0.5

    def grad_gap(g):
        return sum(float((g[n] - f32["grads"][n]).square().sum()) for n in g) ** 0.5 / norm

    row = dict(batch=B, losses=dict(cpu_fp32=f32["loss"], cpu_bf16=b16["loss"], card_bf16=card["loss"]),
               cpu_loss_gap=abs(b16["loss"] - f32["loss"]), card_loss_gap=abs(card["loss"] - f32["loss"]),
               cpu_grad_gap=grad_gap(b16["grads"]), card_grad_gap=grad_gap(card["grads"]),
               card_vs_cpu_bf16_grad=sum(float((card["grads"][n] - b16["grads"][n]).square().sum())
                                         for n in card["grads"]) ** 0.5 / norm,
               launches=got, seconds=dict(cpu_fp32=f32["seconds"], cpu_bf16=b16["seconds"], card=card["seconds"]))
    row["loss_bound"] = BF16_STEP_GAP * row["cpu_loss_gap"] + BF16_LOSS_SLACK
    row["grad_bound"] = BF16_STEP_GAP * row["cpu_grad_gap"] + BF16_GRAD_SLACK
    ok = (row["card_loss_gap"] <= row["loss_bound"] and row["card_grad_gap"] <= row["grad_bound"]
          and got == per_forward(1) and np.isfinite(card["loss"])
          and all(bool(torch.isfinite(g).all()) for g in card["grads"].values()))
    out["bf16_step"] = row
    log(f"learnability bf16 step, B={B} at {hw[1]}x{hw[0]}: losses CPU fp32 {f32['loss']:.6f}, CPU bf16 "
        f"{b16['loss']:.6f}, card bf16 {card['loss']:.6f}: the card's gap to fp32 {row['card_loss_gap']:.3e} "
        f"(bound {row['loss_bound']:.3e} = {BF16_STEP_GAP} x the CPU's {row['cpu_loss_gap']:.3e} + "
        f"{BF16_LOSS_SLACK}); gradients' distance to fp32 over its norm, card {row['card_grad_gap']:.3e} (bound "
        f"{row['grad_bound']:.3e} = {BF16_STEP_GAP} x the CPU's {row['cpu_grad_gap']:.3e} + {BF16_GRAD_SLACK}), "
        f"card vs CPU bf16 {row['card_vs_cpu_bf16_grad']:.3e}; launches {got}; CPU fp32 {f32['seconds']:.1f} s, "
        f"CPU bf16 {b16['seconds']:.1f} s, card {card['seconds']:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the card's bf16 step is outside the bound: {row}")
    del f32, b16, card

    # 12.c the train CLI through learnability.train: its meter, peak memory,
    # launches per step; then one profiled step outside the CLI
    torch.cuda.reset_peak_memory_stats()
    trained, got = counted(launches, lambda: lb.train(root, run_dir, hw=hw, max_iter=LEARN_ITERS,
                                                      batch=LEARN_BATCH, quick=quick, device=dev, log_interval=1))
    peak = torch.cuda.max_memory_allocated() / 2**20
    ckpt = trained["checkpoint"]
    cfg = config()
    loader = maybe_device_resident(get_loader(cfg), cfg, dev)
    st = create_train_state(build_model(cfg, device=dev, seed=0), cfg)
    step = make_train_step(make_schedule_from_cfg(cfg, dev), cfg)
    data = iter(loader)

    def one(it):
        nonlocal data
        try:
            b = next(data)
        except StopIteration:
            data = iter(loader)
            b = next(data)
        b = {k: torch.as_tensor(v).to(dev, non_blocking=True) for k, v in b.items()}  # as the CLI does
        aug, g = cli.iteration_generators(it, dev)
        b["image"] = normalize_images(augment_batch(b["image"], aug, it * cfg.TRAIN.BATCH_SIZE))
        return step(st, b, generator=g)

    for it in range(2):
        one(it)
    busy = device_breakdown(lambda: one(2))
    del st, loader, data
    meter = trained["meter_s"]
    ok = (got == {k: v * LEARN_ITERS for k, v in per_forward(1).items()} and os.path.exists(ckpt)
          and len(meter) == LEARN_ITERS and np.isfinite(trained["step_s_p50"]))
    out["train"] = dict(batch=LEARN_BATCH, iters=LEARN_ITERS, step_ms_p50=trained["step_s_p50"] * 1e3,
                        meter_ms=[v * 1e3 for v in meter], samples_per_s=trained["samples_per_s"], peak_mib=peak,
                        launches=got, launches_per_step={k: v / LEARN_ITERS for k, v in got.items()},
                        cli_seconds=trained["cli_seconds"], profile=busy)
    log(f"learnability train CLI: B={LEARN_BATCH} at {hw[1]}x{hw[0]}, bf16, BN frozen, {LEARN_ITERS} iterations "
        f"in {trained['cli_seconds']:.1f} s; its meter's step p50 {trained['step_s_p50'] * 1e3:.2f} ms over "
        f"iterations 2-{LEARN_ITERS} ({trained['samples_per_s']:.1f} samples/s), peak {peak:.1f} MiB, launches "
        f"per step {out['train']['launches_per_step']}; one profiled step {busy['wall_ms']:.2f} ms, device busy "
        f"{busy['device_ms']:.2f} ms ({busy['busy_share']:.3f}), by kind {busy['by_kind']}; on {smi} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"learnability train: launches {got}, checkpoint {ckpt}, meter {meter}")

    # 12.d evaluate from that checkpoint: 160 / 10 launches per DDIM-10 plan;
    # the held-out plans against a CPU planner's on the same checkpoint
    DiffusionPlanner.plan_begin = counting_begin
    try:
        plans.clear()
        t0 = time.perf_counter()
        res, got = counted(launches, lambda: lb.evaluate(ckpt, heldout, hw, quick=quick, device=dev,
                                                         cl_steps=LEARN_TICKS[0], cv_steps=LEARN_TICKS[1]))
        eval_s = time.perf_counter() - t0
        n_plans = len(plans)
        ok = (set(plans) == {10} and got == per_forward(10 * n_plans)
              and all(np.isfinite(v) for v in res.values() if isinstance(v, float)))
    finally:
        DiffusionPlanner.plan_begin = plan_begin
    cfg = lb.make_cfg(hw=hw, quick=quick)
    gpu = DiffusionPlanner(cfg, checkpoint=ckpt, device=dev)
    cpu = DiffusionPlanner(cfg, checkpoint=ckpt, device="cpu")
    cpu.init_trajs = gpu.init_trajs.cpu()
    diffs = []
    for s in heldout:
        frame = lb.heldout_frame(s, hw)
        a, b = gpu.plan(frame), cpu.plan(frame)
        diffs.append(float(np.abs(a - b).max()))
        ok = ok and np.allclose(a, b, **BF16_PLAN_TOL) and np.isfinite(a).all()
    del gpu, cpu
    out["evaluate"] = dict(result=res, plans=n_plans, launches=got, launches_per_plan=per_forward(10),
                           gpu_vs_cpu_heldout_max_abs_m=max(diffs), seconds=eval_s)
    log(f"learnability evaluate ({LEARN_ITERS}-iteration checkpoint, {LEARN_TICKS[0]} straight and "
        f"{LEARN_TICKS[1]} curved ticks): {n_plans} plans of DDIM-10 bf16, launches {got} ({per_forward(10)} per "
        f"plan), {eval_s:.1f} s; the {len(heldout)} held-out plans GPU vs CPU max_abs_diff {max(diffs):.3e} m "
        f"(BF16_PLAN_TOL {BF16_PLAN_TOL}); keys {json.dumps(res)} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"learnability evaluate: plans {sorted(set(plans))}, launches {got}, diffs {diffs}")

    # 12.e distill 8 -> 4 -> 2 and plan with the 2-step student (and the
    # teacher at 8 and 2 steps)
    DiffusionPlanner.plan_begin = counting_begin
    try:
        plans.clear()
        t0 = time.perf_counter()
        dres, got = counted(launches, lambda: lb.distill(
            ckpt, root, heldout, hw, quick=quick, device=dev, batch=LEARN_BATCH, workdir=work, cl_steps=10,
            cv_steps=10, eval_ks=(2,), **LEARN_DISTILL))
        distill_s = time.perf_counter() - t0
    finally:
        DiffusionPlanner.plan_begin = plan_begin
    # a distill step: the teacher's two forwards without a gradient, the student's one with
    fwd = 3 * LEARN_DISTILL["iters"] * LEARN_DISTILL["stages"] + sum(plans)
    student = dres["students"].get("2", {})
    ok = (got == per_forward(fwd) and dres["stage_steps"] == [4, 2] and set(plans) == {8, 2}
          and all(np.isfinite(v) for v in student.values()) and len(student) == 5)
    out["distill"] = dict(result=dres, plans=len(plans), plan_steps=sum(plans), launches=got, seconds=distill_s)
    log(f"learnability distill: {LEARN_DISTILL}, stages {dres['stage_steps']} in {dres['seconds']:.1f} s; the "
        f"2-step student {student}, the teacher at 8 {dres['teacher'].get('8')} and at 2 {dres['teacher'].get('2')}; "
        f"{len(plans)} plans ({sum(plans)} denoising steps), launches {got} (expected {per_forward(fwd)}: 3 "
        f"forwards a distill step, 1 a denoising step) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"learnability distill: launches {got}, plans {plans}, result {dres}")
    shutil.rmtree(work, ignore_errors=True)
    jax_side = sorted(m for m in sys.modules if m.split(".")[0] == "autonomous_driving_with_diffusion_model_tpu")
    if jax_side:
        raise AssertionError(f"phase 12 imported the JAX package: {jax_side}")
    out["seconds"] = time.perf_counter() - t_phase
    return out


def compiled_plan(load_cfg, device_breakdown, launches, smi, dev="cuda") -> dict:
    """Phase 13: the plan as one program (``driving/program.py``, a CUDA
    graph per key) for phase 4's three configs, phase 7's planner paths,
    HOIST_PERCEPTION off and a CFG student's key (held to the CPU planner
    too, ``plan_tol``). Per path, on one frame: the graph's plan against
    the eager body ``_plan`` on the same inputs (GRAPH_TOL in float32,
    plan_tol's bf16 bound in bfloat16; whether bit-identical); the first
    plan's launch counts (its one replay: 16 / 1 per forward) and the
    counts the capture recorded; the warm run's and the capture's seconds;
    eager and graph plan p50 in turns over PLAN_REPS plans; the peak MiB of
    the eager body and of the graph's first plan (its build included),
    above what the path held before; one profiled replay's busy share and
    its kernels as the profiler counts them (two launches per residual
    block, one per head) against the recorded counts, a profile that lost
    records retaken up to PROFILE_TRIES times. Then a capture on a
    worker thread (a pipelined agent's) replayed on the main thread.
    ``launches`` gathers the first plans' counts into the kernels line;
    ``dev`` is the card (the CPU only to rehearse the phase: no graph
    there)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from autonomous_driving_with_diffusion_model_tpu_torch.driving import DiffusionPlanner
    from autonomous_driving_with_diffusion_model_tpu_torch.models import init_scorer, save_scorer
    from autonomous_driving_with_diffusion_model_tpu_torch.ops import kernels

    out = {"paths": {}}
    cfg0 = load_cfg(CONFIGS[0])
    frames = np.random.default_rng(13).integers(
        0, 256, (4, cfg0.TRAIN.IMAGE_HEIGHT, cfg0.TRAIN.IMAGE_WIDTH, 3), dtype=np.uint8)
    target = np.array([0.3, 0.1], np.float32)
    scorer_npz = os.path.join(REPO, "chiprun_out", "phase13_scorer.npz")
    os.makedirs(os.path.dirname(scorer_npz), exist_ok=True)
    paths = [("default", CONFIGS[0], {}), ("free_guidance", CONFIGS[1], {}),
             ("classifier_guidance", CONFIGS[2], {})] + serving_paths(scorer_npz)
    # HOIST_PERCEPTION off: the encoder in every step, at batch 2 under CFG,
    # and at batch 8 over DDIM-100 (800 encodes a plan: the largest graph)
    paths += [("hoist_off_free_guidance", CONFIGS[1], {"TPU.HOIST_PERCEPTION": False}),
              ("hoist_off_k8", CONFIGS[0], {"TPU.HOIST_PERCEPTION": False, "TPU.NUM_HYPOTHESES": 8})]
    # the key every CFG student replays (learnability.student_cfg): the
    # guidance scale baked in, a distilled 2-step grid, bfloat16; also held
    # to the CPU planner of the same weights and draw
    paths += [("cfg_student_2step_bf16", CONFIGS[1], {"GUIDANCE.FREE_SCALE": 1.0, "TPU.SAMPLE_TIMESTEPS": [98, 34],
                                                      "TPU.COMPUTE_DTYPE": "bfloat16"})]
    mib = lambda b: b / 2**20
    for name, path, opts in paths:
        t_path = time.perf_counter()
        cfg = load_cfg(path)
        cfg.merge_from_list([str(v) for kv in opts.items() for v in kv])
        if cfg.TPU.HYPOTHESIS_SCORER == "learned":
            save_scorer(scorer_npz, init_scorer(0, cfg.MODEL.HORIZON, cfg.MODEL.TRANSITION_DIM))
        n_fwd = len(cfg.TPU.SAMPLE_TIMESTEPS) or cfg.EVAL.SAMPLE_STEPS
        want = {"fused_residual_block": 16 * n_fwd, "fused_conv1d_gn_mish": n_fwd}
        gpu = DiffusionPlanner(cfg, seed=0, device=dev)
        tgt = target if gpu.use_guidance_type.name != "NO_GUIDANCE" else None
        tgt_t = torch.from_numpy(target[None] if tgt is not None else np.zeros((1, 2), np.float32)).to(dev)

        def eager(f):
            trajs, best = gpu._plan(gpu.init_trajs, torch.from_numpy(f).to(dev), tgt_t, gpu.step_noise)
            return trajs.cpu().numpy(), int(best)

        def graph(f):
            return gpu.plan_hypotheses(f, tgt)

        eager(frames[1])  # what the body builds at its first call
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ref, ref_best = eager(frames[0])
        eager_peak = mib(torch.cuda.max_memory_allocated() - base)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        got, best = graph(frames[0])  # the build and the first replay
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        for k in launches:
            launches[k] += counts[k]
        graph_peak = mib(torch.cuda.max_memory_allocated() - base)
        program = gpu._program.programs.get(gpu._program.key)
        is_bf16 = cfg.TPU.COMPUTE_DTYPE == "bfloat16"
        tol = plan_tol(cfg)["atol"] if is_bf16 else GRAPH_TOL
        diff = float(np.abs(got - ref).max())
        ok = (program is not None and diff <= tol and wrapper_calls(counts) == want and np.isfinite(got).all()
              and (program.graph is not None) == (torch.device(dev).type == "cuda")
              and (wrapper_calls(program.launches) == want or torch.device(dev).type != "cuda"))
        e_ms, g_ms = [], []
        for i in range(PLAN_REPS):
            for run, ms in ((eager, e_ms), (graph, g_ms)):
                t0 = time.perf_counter()
                run(frames[i % len(frames)])  # ends in a copy to the host
                ms.append((time.perf_counter() - t0) * 1e3)
        recorded = {"conv_gn_mish_kernel": 2 * want["fused_residual_block"],
                    "conv1d_gn_mish_kernel": want["fused_conv1d_gn_mish"]}
        attempts = []
        for _ in range(PROFILE_TRIES):
            busy = device_breakdown(lambda: graph(frames[2]))
            profiled = busy["port_kernel_launches"]
            attempts.append(profiled)
            if profiled == recorded or any(profiled[k] > recorded[k] for k in recorded):
                break
        ok = ok and profiled == recorded
        cpu_diff = None
        if name == "cfg_student_2step_bf16":
            cpu = DiffusionPlanner(cfg, seed=0, device="cpu")
            cpu.init_trajs = gpu.init_trajs.cpu()
            cpu_diff = float(np.abs(got - cpu.plan_hypotheses(frames[0], tgt)[0]).max())
            ok = ok and cpu_diff <= plan_tol(cfg)["atol"]
            del cpu
        row = dict(steps=n_fwd, gpu_vs_cpu_max_abs_m=cpu_diff, hypotheses=gpu.num_hypotheses,
                   dtype=str(cfg.TPU.COMPUTE_DTYPE),
                   first_plan_launches=counts, recorded_launches=None if program is None else program.launches,
                   graph_vs_eager_max_abs_m=diff, bit_identical=bool(np.array_equal(got, ref)), tolerance_m=tol,
                   best=best, eager_best=ref_best,
                   warm_s=None if program is None else program.warm_s,
                   capture_s=None if program is None else program.capture_s,
                   eager_ms_p50=float(np.median(e_ms)), graph_ms_p50=float(np.median(g_ms)),
                   eager_ms=e_ms, graph_ms=g_ms, eager_peak_mib=eager_peak, graph_peak_mib=graph_peak,
                   profile=busy, profiler_launches=profiled, expected_profiler_launches=recorded,
                   profile_attempts=attempts,
                   seconds=time.perf_counter() - t_path)
        out["paths"][name] = row
        log(f"compiled plan {name}: graph vs eager max_abs {diff:.3e} m (tolerance {tol}, bit-identical "
            f"{row['bit_identical']}), best {best} / eager {ref_best}; first plan launches {counts} (expected "
            f"{want}), recorded {row['recorded_launches']}; warm {row['warm_s'] or 0:.2f} s, capture "
            f"{row['capture_s'] or 0:.2f} s; plan p50 eager {row['eager_ms_p50']:.2f} ms, graph "
            f"{row['graph_ms_p50']:.2f} ms over {PLAN_REPS} each in turns ({n_fwd} steps); peak above the path's "
            f"base: eager {eager_peak:.1f} MiB, graph's first plan {graph_peak:.1f} MiB; profiled replay "
            f"{busy['device_ms']:.2f} of {busy['wall_ms']:.2f} ms busy ({busy['busy_share']:.3f}), by kind "
            f"{busy['by_kind']}, port kernels counted {profiled} (expected {recorded}; profile "
            f"{len(attempts)} of at most {PROFILE_TRIES}, the earlier ones counted {attempts[:-1]}); "
            + ("" if cpu_diff is None else f"GPU vs CPU plan {cpu_diff:.3e} m (bound {plan_tol(cfg)['atol']}); ")
            + f"path "
            f"{row['seconds']:.1f} s; on {smi} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"compiled plan {name}: {row}")
        del gpu, program

    # a pipelined agent's worker thread captures; the main thread replays
    cfg = load_cfg(CONFIGS[2])
    gpu = DiffusionPlanner(cfg, seed=0, device=dev)
    with ThreadPoolExecutor(max_workers=1) as pool:
        worker = pool.submit(gpu.plan_hypotheses, frames[0], target).result()[0]
    main_thread = gpu.plan_hypotheses(frames[0], target)[0]
    same = bool(np.array_equal(worker, main_thread))
    out["worker_thread_capture"] = dict(bit_identical=same, programs=len(gpu._program.programs))
    log(f"compiled plan: captured on a worker thread, replayed on the main thread ({CONFIGS[2]}): "
        f"bit-identical {same}, programs {len(gpu._program.programs)} {'ok' if same else 'FAIL'}")
    if not same or len(gpu._program.programs) != 1:
        raise AssertionError(f"worker-thread capture: {out['worker_thread_capture']}")
    return out


def compiled_train(load_cfg, device_breakdown, launches, smi, dev="cuda") -> dict:
    """Phase 14: the training-side steps as one program each
    (``train/program.py``, a CUDA graph per key): the train step at B = 32
    in float32 (BN frozen, BN train, REMAT) and at B = 64 in bfloat16, the
    distill step at B = 32 (default and CFG) and the scorer's 3000-step fit.
    Per step: the eager step on one state and the program on its twin from
    the same weights, batch and draws, in turns, TRAIN_REPS times after the
    first of each (the program's first is its eager step on a side stream
    and the capture); every loss, and at the end every parameter, AdamW
    moment and count, EMA shadow and BatchNorm buffer, bit-identical; each
    replay's launch counts equal to the eager step's and to the capture's
    record (16 / 1 per forward); eager and graph step p50; the warm step's
    and the capture's seconds; the peak MiB of the eager step and of the
    program's build above the case's base; one profiled eager step and one
    profiled replay (busy share; the replay's kernels as the profiler counts
    them against the capture's record, a profile that lost records retaken
    up to PROFILE_TRIES times). The scorer: the fit's eager loop against
    its replayed step, bit-identical parameters, both timed. Then a plan and
    a sample on a model trained by replays against a fresh model loaded with
    its weights (a replay bumps the ``_version`` of what it writes). ``launches`` gathers the replays'
    counts into the kernels line; ``dev`` is the card (the CPU only to
    rehearse the phase: no graph there)."""
    import torch

    dev = torch.device(dev)
    card = dev.type == "cuda"
    # cuDNN's default backward algorithms sum with atomics, so two eager steps
    # from one state differ in their last bits; deterministic ones let the
    # comparison ask for bit-identity (phase 8 times the default algorithms)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _compiled_train(load_cfg, device_breakdown, launches, smi, dev, card)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _compiled_train(load_cfg, device_breakdown, launches, smi, dev, card) -> dict:
    import copy

    import numpy as np
    import torch

    from autonomous_driving_with_diffusion_model_tpu_torch.data import normalize_images
    from autonomous_driving_with_diffusion_model_tpu_torch.diffusion import (
        grid_chain,
        make_distill_step,
        make_schedule_from_cfg,
        sampler_from_cfg,
    )
    from autonomous_driving_with_diffusion_model_tpu_torch.distill import iteration_generator
    from autonomous_driving_with_diffusion_model_tpu_torch.driving import DiffusionPlanner
    from autonomous_driving_with_diffusion_model_tpu_torch.models import build_model, init_scorer
    from autonomous_driving_with_diffusion_model_tpu_torch.models.scorer import HypothesisScorer, scorer_step
    from autonomous_driving_with_diffusion_model_tpu_torch.ops import kernels
    from autonomous_driving_with_diffusion_model_tpu_torch.train import create_train_state, make_train_step
    from autonomous_driving_with_diffusion_model_tpu_torch.train.cli import iteration_generators
    from autonomous_driving_with_diffusion_model_tpu_torch.train.program import (
        DistillProgram,
        TrainProgram,
        replay_steps,
    )
    from autonomous_driving_with_diffusion_model_tpu_torch.utils.constants import GuidanceType

    out = {"steps": {}, "cudnn_deterministic": True}
    mib = lambda b: b / 2**20
    t_phase = time.perf_counter()

    def batch_of(cfg, B, seed):
        rng = np.random.default_rng(seed)
        H, W = cfg.TRAIN.IMAGE_HEIGHT, cfg.TRAIN.IMAGE_WIDTH
        return {"image": normalize_images(torch.from_numpy(rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)).to(dev)),
                "trajs": torch.from_numpy(rng.uniform(-1, 1, (B, 16, 7)).astype(np.float32)).to(dev),
                "target": torch.from_numpy(rng.uniform(-1, 1, (B, 2)).astype(np.float32)).to(dev)}

    def same_tensors(xs, ys):
        return all(torch.equal(x, y) for x, y in zip(xs, ys, strict=True))

    def opt_tensors(opt, params):
        return [opt.state[p][k] for p in params for k in ("step", "exp_avg", "exp_avg_sq")]

    def timed(run):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = run()
        torch.cuda.synchronize()
        return m, (time.perf_counter() - t0) * 1e3

    def turns(name, eager, graph, program, per_fwd, n_fwd, finals, extra):
        """The in-turns comparison and its record; ``eager(it)`` and
        ``graph(it)`` run iteration ``it`` on the two states."""
        t_case = time.perf_counter()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        m_e, first_eager_ms = timed(lambda: eager(0))
        eager_peak = mib(torch.cuda.max_memory_allocated() - base)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        m_g, build_ms = timed(lambda: graph(0))
        build_peak = mib(torch.cuda.max_memory_allocated() - base)
        prog = program.programs[program.key]
        same_loss = [bool(torch.equal(m_e["loss"], m_g["loss"]))]
        want = {"fused_residual_block": 16 * n_fwd, "fused_conv1d_gn_mish": n_fwd}
        e_ms, g_ms, counts = [], [], []
        for it in range(1, 1 + TRAIN_REPS):
            kernels.reset_launch_counts()
            m_e, ms = timed(lambda: eager(it))
            e_ms.append(ms)
            eager_counts = kernels.launch_counts()
            kernels.reset_launch_counts()
            m_g, ms = timed(lambda: graph(it))
            g_ms.append(ms)
            counts.append(kernels.launch_counts())
            for k in launches:
                launches[k] += counts[-1][k]
            same_loss.append(bool(torch.equal(m_e["loss"], m_g["loss"])))
        a, b = finals()
        identical = all(same_loss) and same_tensors(a, b)
        recorded = {"conv_gn_mish_kernel": 2 * prog.launches.get("fused_residual_block", 0),
                    "conv1d_gn_mish_kernel": prog.launches.get("fused_conv1d_gn_mish", 0)}
        eager_busy = device_breakdown(lambda: eager(1 + TRAIN_REPS))
        attempts = []
        for i in range(PROFILE_TRIES):
            busy = device_breakdown(lambda: graph(2 + TRAIN_REPS + i))
            profiled = busy["port_kernel_launches"]
            attempts.append(profiled)
            if profiled == recorded or any(profiled[k] > recorded[k] for k in recorded):
                break
        ok = (identical and all(c == eager_counts and wrapper_calls(c) == want for c in counts)
              and (wrapper_calls(prog.launches) == want if card else prog.graph is None)
              and (profiled == recorded or not card) and np.isfinite(float(m_g["loss"])))
        row = dict(**extra, bit_identical=identical, losses_bit_identical=same_loss, launches_per_replay=counts[-1],
                   expected_launches=want, recorded_launches=prog.launches, eager_launches=eager_counts,
                   first_eager_ms=first_eager_ms, build_ms=build_ms, warm_s=prog.warm_s, capture_s=prog.capture_s,
                   eager_ms_p50=float(np.median(e_ms)), graph_ms_p50=float(np.median(g_ms)), eager_ms=e_ms,
                   graph_ms=g_ms, eager_peak_mib=eager_peak, build_peak_mib=build_peak,
                   eager_profile=eager_busy, profile=busy, profiler_launches=profiled,
                   expected_profiler_launches=recorded, profile_attempts=attempts, loss=float(m_g["loss"]),
                   seconds=time.perf_counter() - t_case)
        out["steps"][name] = row
        log(f"compiled train {name}: graph vs eager bit-identical {identical} over {1 + TRAIN_REPS} steps in turns; "
            f"launches per replay {counts[-1]} (eager {eager_counts}, expected {want}), recorded "
            f"{prog.launches}; warm {prog.warm_s:.2f} s, capture {prog.capture_s:.2f} s; step p50 eager "
            f"{row['eager_ms_p50']:.2f} ms, graph {row['graph_ms_p50']:.2f} ms over {TRAIN_REPS} each; peak above "
            f"the base: eager step {eager_peak:.1f} MiB, the program's build {build_peak:.1f} MiB; profiled eager "
            f"step {eager_busy['device_ms']:.2f} of {eager_busy['wall_ms']:.2f} ms busy "
            f"({eager_busy['busy_share']:.3f}), replay {busy['device_ms']:.2f} of {busy['wall_ms']:.2f} ms "
            f"({busy['busy_share']:.3f}), by kind {busy['by_kind']}, port kernels counted {profiled} (recorded "
            f"{recorded}; profile {len(attempts)} of at most {PROFILE_TRIES}); {row['seconds']:.1f} s; on {smi} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"compiled train {name}: {row}")

    # 14.1 the train step
    train_cases = [("train_frozen", 32, []), ("train_bn_train", 32, ["TPU.BN_MODE", "train"]),
                   ("train_remat", 32, ["TPU.REMAT", "True"]),
                   ("train_bf16_b64", 64, ["TPU.COMPUTE_DTYPE", "bfloat16"])]
    for name, B, opts in train_cases:
        cfg = load_cfg(CONFIGS[0])
        cfg.merge_from_list(["TRAIN.LR_WARMUP", "1", *opts])
        a = create_train_state(build_model(cfg, device=dev, seed=0), cfg)
        b = create_train_state(copy.deepcopy(a.model), cfg)
        sched = make_schedule_from_cfg(cfg, dev)
        step = make_train_step(sched, cfg)
        program = TrainProgram(make_train_step(sched, cfg), dev)
        batch = batch_of(cfg, B, 14)

        def finals(a=a, b=b):
            def flat(st):
                ps = list(st.model.parameters())
                return [*ps, *st.model.buffers(), *opt_tensors(st.optimizer, ps), *st.ema.shadow_params]
            return flat(a), flat(b)

        turns(name, lambda it: step(a, batch, generator=iteration_generators(it, dev)[1]),
              lambda it: program(b, batch, generator=iteration_generators(it, dev)[1]), program, 1,
              2 if cfg.TPU.REMAT else 1, finals,
              dict(batch=B, dtype=str(cfg.TPU.COMPUTE_DTYPE), bn_mode=str(cfg.TPU.BN_MODE), remat=bool(cfg.TPU.REMAT)))
        del a, b, program, step

    # 14.2 the distill step: the phase-9 stage of each config, one teacher
    for name, path in (("distill_default", CONFIGS[0]), ("distill_cfg", CONFIGS[1])):
        cfg = load_cfg(path)
        sched = make_schedule_from_cfg(cfg, dev)
        grid = grid_chain(sched.num_train_timesteps, int(cfg.EVAL.SAMPLE_STEPS), 1)[0]
        made = [make_distill_step(sched, grid, use_cond=GuidanceType[cfg.TRAIN.USE_COND],
                                  free_scale=float(cfg.GUIDANCE.FREE_SCALE), lr=1e-4, warmup=1, decay_steps=20)
                for _ in range(2)]
        teacher = build_model(cfg, device=dev, seed=0).requires_grad_(False)
        sa, sb = made[0][0](teacher), made[1][0](teacher)
        program = DistillProgram(made[1][1], dev)
        batch = batch_of(cfg, 32, 15)
        n_fwd = 5 if cfg.TRAIN.USE_COND == "FREE_GUIDANCE" else 3

        def finals(sa=sa, sb=sb):
            def flat(st):
                ps = list(st.student.parameters())
                return [*ps, *st.student.buffers(), *opt_tensors(st.optimizer, ps), *st.ema.shadow_params]
            return flat(sa), flat(sb)

        turns(name, lambda it: made[0][1](sa, teacher, batch, generator=iteration_generator(0, it, dev)),
              lambda it: program(sb, teacher, batch, generator=iteration_generator(0, it, dev)), program, 1, n_fwd,
              finals, dict(batch=32, student_steps=len(grid.ts)))
        del sa, sb, teacher, program, made

    # 14.3 the scorer's fit: its eager loop and its replayed step
    rng = np.random.default_rng(11)
    n_tr = SCORER_N - SCORER_N // 5
    tr = [torch.from_numpy(a).to(dev) for a in (
        rng.standard_normal((n_tr, SCORER_K, 16, 7)).astype(np.float32) * np.float32(5.0),
        (0.3 * rng.standard_normal((n_tr, 2))).astype(np.float32),
        rng.standard_normal((n_tr, SCORER_K)).astype(np.float32))]
    p0 = init_scorer(0)
    fits = {}
    for kind in ("eager", "graph", "eager_again", "graph_again"):
        net = HypothesisScorer.from_params(p0).to(dev)
        step = scorer_step(net, *tr, lr=3e-3, weight_decay=0.1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind.startswith("eager"):
            for _ in range(SCORER_STEPS):
                loss = step()
            info = {}
        else:
            loss, info = replay_steps(step, SCORER_STEPS, dev, list(net.parameters()))
        torch.cuda.synchronize()
        fits[kind] = dict(s=time.perf_counter() - t0, loss=loss, params=[p.detach().clone() for p in net.parameters()],
                          info=info)
    identical = (torch.equal(fits["eager"]["loss"], fits["graph"]["loss"])
                 and same_tensors(fits["eager"]["params"], fits["graph"]["params"]))
    net = HypothesisScorer.from_params(p0).to(dev)
    busy = device_breakdown(lambda: replay_steps(scorer_step(net, *tr, lr=3e-3, weight_decay=0.1), 200, dev,
                                                 list(net.parameters())))
    row = dict(n_train=n_tr, k=SCORER_K, steps=SCORER_STEPS, bit_identical=identical,
               eager_s=[fits["eager"]["s"], fits["eager_again"]["s"]], graph_s=[fits["graph"]["s"], fits["graph_again"]["s"]],
               warm_s=fits["graph"]["info"]["warm_s"], capture_s=fits["graph"]["info"]["capture_s"],
               replays=fits["graph"]["info"]["replays"], profile_200_steps=busy)
    row["eager_step_ms"] = min(row["eager_s"]) / SCORER_STEPS * 1e3
    row["graph_step_ms"] = min(row["graph_s"]) / SCORER_STEPS * 1e3
    out["scorer_fit"] = row
    ok = identical and (row["replays"] == SCORER_STEPS - 1 or not card)
    log(f"compiled train scorer fit: {SCORER_STEPS} full-batch AdamW steps on {n_tr} sets of K={SCORER_K}, eager "
        f"loop {row['eager_s'][0]:.2f} / {row['eager_s'][1]:.2f} s, replayed step {row['graph_s'][0]:.2f} / "
        f"{row['graph_s'][1]:.2f} s (warm {row['warm_s']:.3f} s, capture {row['capture_s']:.3f} s, "
        f"{row['replays']} replays), per step {row['eager_step_ms']:.3f} / {row['graph_step_ms']:.3f} ms; "
        f"parameters and loss bit-identical {identical}; 200 replayed steps profiled: {busy['device_ms']:.2f} of "
        f"{busy['wall_ms']:.2f} ms busy ({busy['busy_share']:.3f}); on {smi} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"compiled scorer fit: {row}")

    # 14.4 a plan and a sample after graph steps: the trained model against
    # a fresh model loaded with its weights
    cfg = load_cfg(CONFIGS[1])
    cfg.merge_from_list(["TRAIN.LR_WARMUP", "1"])
    planner = DiffusionPlanner(cfg, seed=0, device=dev)
    st = create_train_state(planner.model.requires_grad_(True), cfg)
    sched = make_schedule_from_cfg(cfg, dev)
    program = TrainProgram(make_train_step(sched, cfg), dev)
    batch = batch_of(cfg, 4, 16)
    frame = np.random.default_rng(16).integers(0, 256, (cfg.TRAIN.IMAGE_HEIGHT, cfg.TRAIN.IMAGE_WIDTH, 3),
                                               dtype=np.uint8)
    target = np.array([0.3, 0.1], np.float32)
    init = torch.randn((1, 16, 7), generator=torch.Generator().manual_seed(16)).to(dev)
    target_t = torch.from_numpy(target[None]).to(dev)

    def sample(model):
        with torch.no_grad():
            return sampler_from_cfg(model.eval(), sched, cfg)(init, image=batch["image"][:1], target=target_t)

    program(st, batch, generator=iteration_generators(0, dev)[1])
    planner.model.eval()
    before = planner.plan(frame, target)  # captured and packed on these weights
    sample(planner.model)
    for it in (1, 2, 3):
        program(st, batch, generator=iteration_generators(it, dev)[1])
    planner.model.eval()
    fresh = DiffusionPlanner(cfg, seed=0, device=dev)
    fresh.model.load_state_dict(planner.model.state_dict())
    fresh.init_trajs = planner.init_trajs
    got, want = planner.plan(frame, target), fresh.plan(frame, target)
    s_got, s_want = sample(planner.model), sample(fresh.model)
    ok = (bool(np.array_equal(got, want)) and bool(torch.equal(s_got, s_want)) and not np.array_equal(got, before)
          and (program.programs[program.key].graph is not None or not card))
    out["after_graph_steps"] = dict(plan_equal=bool(np.array_equal(got, want)), sample_equal=bool(torch.equal(s_got, s_want)),
                                    plan_moved_m=float(np.abs(got - before).max()))
    log(f"compiled train: after 3 replayed steps ({CONFIGS[1]}, B=4) the trained model's plan equals a fresh "
        f"model's on its weights {out['after_graph_steps']['plan_equal']} (moved "
        f"{out['after_graph_steps']['plan_moved_m']:.3e} m from the plan before), its sample "
        f"{out['after_graph_steps']['sample_equal']} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"a plan or sample after graph steps used stale weights: {out['after_graph_steps']}")
    out["seconds"] = time.perf_counter() - t_phase
    return out


@contextlib.contextmanager
def multi_wave_only():
    """Every launch of the residual block on its multi-wave code: the card
    is said to hold no one-wave cluster, and no launch has a streamed
    geometry."""
    from autonomous_driving_with_diffusion_model_tpu_torch.ops import kernels

    real = kernels._max_active_clusters, kernels.streamed_geometry
    kernels._max_active_clusters = lambda *a, **kw: 0
    kernels.streamed_geometry = lambda *a, **kw: None
    try:
        yield
    finally:
        kernels._max_active_clusters, kernels.streamed_geometry = real


FOLD_BATCHES = (16, 32)  # phase 5: the folded path at the k8 plan's batch and at the training batch


def folded(calls, case, graph_ms, bound_ms, smi) -> dict:
    """Phase 5's batch-folding part: the default U-Net forward's 16 residual
    calls (``calls``, phase 3's hooks) at each batch of ``FOLD_BATCHES``,
    float32, each checked against its plain version and counted by path as
    the blocks launch their cached packs; then the 16 calls in one graph on
    their paths (folded, the Cin = 7 launch one-wave), on the multi-wave code
    at the same shapes, and in their plain version, beside the summed bound.
    ``case``, ``graph_ms`` and ``bound_ms`` are phase 5's."""
    import torch

    from autonomous_driving_with_diffusion_model_tpu_torch.models import ResidualTemporalMapBlock
    from autonomous_driving_with_diffusion_model_tpu_torch.ops import kernels

    kcall = lambda c: (lambda: c[0](*c[2], weights_cached=True))
    pcall = lambda c: (lambda: c[1](*c[2]))
    keys = ("fused_residual_block", *kernels.PATHS)
    out = {}
    with torch.no_grad():
        for B in FOLD_BATCHES:
            gen = torch.Generator().manual_seed(50 + B)
            mine = [case(m, a, B, torch.float32, gen) for n, m, a in calls if isinstance(m, ResidualTemporalMapBlock)]
            kernels.reset_launch_counts()
            for c in mine:
                got = kcall(c)()
                want = c[1](*c[2])
                torch.cuda.synchronize()
                if not torch.allclose(got, want, **KERNEL_TOL["float32"]) or not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"folded: B={B} {tuple(c[2][0].shape)} max_abs_err "
                                         f"{(got - want).abs().max().item()}")
            counts = {k: kernels.launch_counts()[k] for k in keys}
            with multi_wave_only():
                multi_ms = graph_ms([kcall(c) for c in mine])
            row = dict(calls=len(mine), launches=counts, ms=graph_ms([kcall(c) for c in mine]),
                       multi_wave_ms=multi_ms, plain_ms=graph_ms([pcall(c) for c in mine]),
                       bound_ms=sum(bound_ms(c[0], c[2])[0] for c in mine))
            out[f"b{B}"] = row
            log(f"folded time fused_residual_block: one forward's {len(mine)} calls at B={B}, device ms: "
                f"as launched {row['ms']:.4f}, multi-wave {multi_ms:.4f}, plain {row['plain_ms']:.4f}, bound "
                f"{row['bound_ms']:.4f}; launches {counts}, on {smi}")
            if counts[kernels.PATHS[3]] != 2 * len(mine) - 1 or counts[kernels.PATHS[0]] != 1:
                raise AssertionError(f"folded: B={B} launches by path {counts}, expected "
                                     f"{2 * len(mine) - 1} folded and the Cin = 7 launch one-wave")
    return out


def film(case, graph_ms, bound_ms, smi, dev="cuda", extra_opts=()) -> dict:
    """Phase 15: the FiLM residual block and the head at Diffusion Policy's
    published widths, batch 1 (``FILM_OPTS``; ``extra_opts`` narrow it for
    a rehearsal on the CPU). ``case``, ``graph_ms`` and ``bound_ms`` are
    phase 5's. Each call is checked and timed as the blocks launch it (its
    path, one-wave or streamed) and on the multi-wave code at the same
    shape; the streamed launches of a forward are counted at capture."""
    import torch

    from autonomous_driving_with_diffusion_model_tpu_torch.models import Conv1dBlock, build_model
    from autonomous_driving_with_diffusion_model_tpu_torch.models.conditional_unet1d import (
        ConditionalResidualBlock1D,
    )
    from autonomous_driving_with_diffusion_model_tpu_torch.ops import kernels
    from autonomous_driving_with_diffusion_model_tpu_torch.utils.config import create_cfg

    cfg = create_cfg()
    cfg.merge_from_list(list(FILM_OPTS) + list(extra_opts))
    model = build_model(cfg, device=dev, seed=0)
    calls = []
    hooks = [m.register_forward_hook(lambda mod, args, out, n=n: calls.append((n, mod, args)))
             for n, m in model.named_modules() if isinstance(m, (ConditionalResidualBlock1D, Conv1dBlock))]
    obs = cfg.MODEL.N_OBS_STEPS * (cfg.MODEL.OBS_FEATURE_DIM + 2)
    with torch.no_grad():
        model(torch.zeros(1, cfg.MODEL.HORIZON, cfg.MODEL.TRANSITION_DIM, device=dev),
              torch.ones(1, device=dev), torch.zeros(1, obs, device=dev))
    for h in hooks:
        h.remove()
    blocks = [a for _, m, a in calls if isinstance(m, ConditionalResidualBlock1D)]
    shapes = {(a[0].shape[1], a[0].shape[2], m.blocks[0].block[0].out_channels) for _, m, a in calls
              if isinstance(m, ConditionalResidualBlock1D)}
    if len(blocks) != 12 or len(calls) != 13 or len(shapes) != 10:
        raise AssertionError(f"film: {len(blocks)} blocks, {len(calls)} calls, {len(shapes)} geometries "
                             f"in one forward; expected 12, 13 and 10")

    gen = torch.Generator().manual_seed(15)
    cases = [case(m, a, 1, torch.float32, gen) for n, m, a in calls]
    # as the blocks launch their cached packs: one-wave and PDL where they apply
    kcall = lambda c: ((lambda: c[0](*c[2], weights_cached=True)) if c[0] is kernels.fused_residual_block
                       else (lambda: c[0](*c[2])))
    pcall = lambda c: (lambda: c[1](*c[2]))
    rows, max_err = [], {"fused_residual_block": 0.0, "fused_conv1d_gn_mish": 0.0}
    kernels.reset_launch_counts()
    with torch.no_grad():
        for (n, m, a), c in zip(calls, cases):
            fn, plain, args = c
            before = kernels.launch_counts()
            got = kcall(c)()
            want = plain(*args)
            torch.cuda.synchronize()
            after = kernels.launch_counts()
            err = (got - want).abs().max().item()
            ok = torch.allclose(got, want, **KERNEL_TOL["float32"]) and bool(torch.isfinite(got).all())
            max_err[fn.__name__] = max(max_err[fn.__name__], err)
            C = int(args[2 if fn is kernels.fused_residual_block else 1].shape[-1])
            row = dict(kernel=fn.__name__, block=n, shape=list(args[0].shape), C=C, max_abs_err=err,
                       one_wave=after[kernels.PATHS[0]] - before[kernels.PATHS[0]],
                       pdl=after[kernels.PATHS[1]] - before[kernels.PATHS[1]],
                       streamed=after[kernels.PATHS[2]] - before[kernels.PATHS[2]],
                       film=after[kernels.FILM] - before[kernels.FILM])
            row["path"] = ("head" if fn is not kernels.fused_residual_block else
                           "+".join(p for p, k in (("one-wave", row["one_wave"]), ("streamed", row["streamed"]),
                                                   ("multi-wave", 2 - row["one_wave"] - row["streamed"])) if k))
            rows.append(row)
            log(f"film check {fn.__name__:22s} {n:22s} L={row['shape'][1]:2d} {row['shape'][2]:4d}->{C:4d} "
                f"max_abs_err={err:.3e} path {row['path']}: launches one-wave {row['one_wave']} streamed "
                f"{row['streamed']} PDL {row['pdl']} FiLM {row['film']} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"film: {fn.__name__} at {n}: max_abs_err {err}")
        counts = kernels.launch_counts()
        want_counts = {"fused_residual_block": 12, kernels.FILM: 12, "fused_conv1d_gn_mish": 1,
                       kernels.PATHS[0]: 7, kernels.PATHS[2]: 17}
        if {k: counts[k] for k in want_counts} != want_counts:
            raise AssertionError(f"film: launch counts {counts}, expected {want_counts}")
        log(f"film launches of one forward's calls: {counts}")

        # each call 20 times in one graph; the forward's calls in one graph
        # (1.0 GB of weights: none stay in the 50 MB L2 between passes)
        reps = 20
        weights = lambda c: sum(a.numel() * a.element_size() for a in c[2][2 if c[0] is kernels.fused_residual_block
                                                                            else 1:] if a is not None)
        for row, c in zip(rows, cases):
            b, by = bound_ms(c[0], c[2])
            with multi_wave_only():
                multi_us = graph_ms([kcall(c)] * reps) / reps * 1e3
            row.update(kernel_us=graph_ms([kcall(c)] * reps) / reps * 1e3, multi_wave_us=multi_us,
                       plain_us=graph_ms([pcall(c)] * reps) / reps * 1e3, bound_us=b * 1e3, bound_by=by,
                       weight_bytes=weights(c))
            row["tb_s"] = row["weight_bytes"] / row["kernel_us"] / 1e6
            row["multi_wave_tb_s"] = row["weight_bytes"] / multi_us / 1e6
            log(f"film time {row['kernel']:22s} {row['block']:22s} L={row['shape'][1]:2d} "
                f"{row['shape'][2]:4d}->{row['C']:4d} {row['path']:20s}: kernel_us={row['kernel_us']:.2f} "
                f"({row['tb_s']:.3f} TB/s) multi-wave_us={multi_us:.2f} ({row['multi_wave_tb_s']:.3f} TB/s) "
                f"plain_us={row['plain_us']:.2f} bound_us={row['bound_us']:.2f} ({by}) on {smi}")
        out = {"rows": rows, "launches": {k: counts[k] for k in counts}}
        # the calls with a streamed launch, one after the other as in a
        # forward: per call and in one graph, against the multi-wave code
        wide = [(r, c) for r, c in zip(rows, cases) if r["streamed"]]
        nbytes = sum(r["weight_bytes"] for r, _ in wide)
        wide_ms = graph_ms([kcall(c) for _, c in wide])
        with multi_wave_only():
            wide_multi_ms = graph_ms([kcall(c) for _, c in wide])
        out["wide"] = dict(calls=len(wide), weight_bytes=nbytes, ms=wide_ms, multi_wave_ms=wide_multi_ms,
                           tb_s=nbytes / wide_ms / 1e9, multi_wave_tb_s=nbytes / wide_multi_ms / 1e9,
                           sum_of_calls_ms=sum(r["kernel_us"] for r, _ in wide) / 1e3,
                           sum_of_calls_multi_wave_ms=sum(r["multi_wave_us"] for r, _ in wide) / 1e3)
        log(f"film time the {len(wide)} calls with streamed launches in one graph: {wide_ms:.4f} ms "
            f"({out['wide']['tb_s']:.3f} TB/s) against {wide_multi_ms:.4f} ms ({out['wide']['multi_wave_tb_s']:.3f} "
            f"TB/s) on the multi-wave code; {nbytes / 1e9:.4f} GB on {smi}")
        # the forward's residual calls captured in one graph: launches by path at capture
        mine = [c for c in cases if c[0] is kernels.fused_residual_block]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for c in mine:
                kcall(c)()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        kernels.reset_launch_counts()
        with torch.cuda.graph(graph):
            for c in mine:
                kcall(c)()
        captured = kernels.launch_counts()
        out["captured"] = {k: captured[k] for k in ("fused_residual_block", *kernels.PATHS, kernels.FILM)}
        log(f"film launches captured in one forward's graph: {out['captured']}")
        if captured[kernels.PATHS[2]] != 17 or captured[kernels.PATHS[0]] != 7:
            raise AssertionError(f"film: captured launches {out['captured']}, expected 17 streamed and 7 one-wave")
        del graph
        for kname in max_err:
            mine = [c for c in cases if c[0].__name__ == kname]
            first = 2 if kname == "fused_residual_block" else 1  # the weights follow x (and t)
            nbytes = sum(a.numel() * a.element_size() for c in mine for a in c[2][first:] if a is not None)
            ms = graph_ms([kcall(c) for c in mine])
            out[kname] = dict(calls=len(mine), max_abs_err=max_err[kname], ms=ms,
                              plain_ms=graph_ms([pcall(c) for c in mine]),
                              bound_ms=sum(bound_ms(c[0], c[2])[0] for c in mine), weight_bytes=nbytes,
                              weight_tb_s=nbytes / (ms / 1e3) / 1e12)
            log(f"film time {kname}: one forward's {len(mine)} calls, device ms: kernel {ms:.4f}, plain "
                f"{out[kname]['plain_ms']:.4f}, bound {out[kname]['bound_ms']:.4f}; weights "
                f"{nbytes / 1e9:.4f} GB at {out[kname]['weight_tb_s']:.3f} TB/s on {smi}")
    del model, cases
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, PKG)):
        print(f"chip_smoke: {PKG}/ is not beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from autonomous_driving_with_diffusion_model_tpu_torch.driving import DiffusionPlanner
    from autonomous_driving_with_diffusion_model_tpu_torch.models import (
        Conv1dBlock,
        ResidualTemporalMapBlock,
    )
    from autonomous_driving_with_diffusion_model_tpu_torch.ops import build, kernels
    from autonomous_driving_with_diffusion_model_tpu_torch.utils.config import (
        create_cfg,
        merge_possible_with_base,
    )

    dev = torch.device("cuda")

    t_start = time.perf_counter()
    phase_s = {}

    def phase_done(n):
        phase_s[n] = time.perf_counter() - t_start
        log(f"phase {n} done at {phase_s[n]:.1f} s of command time")

    # ---------------------------------------------------------------- 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    bw, flops, bf16_flops = card_rates(name)
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---------------------------------------------------------------- 2. build
    t0 = time.time()
    build.build_all()
    for src, report in build.ptxas_report.items():
        log(f"ptxas ({src}):\n{report}")
    log(f"build: {time.time() - t0:.1f} s")

    def load_cfg(path):
        cfg = create_cfg()
        merge_possible_with_base(cfg, os.path.join(REPO, path))
        return cfg

    # main-path shapes and weights: one forward of the default planner's U-Net
    planner = DiffusionPlanner(load_cfg(CONFIGS[0]), seed=0)
    calls = []
    hooks = [
        m.register_forward_hook(lambda mod, args, out, n=n: calls.append((n, mod, args)))
        for n, m in planner.model.named_modules()
        if isinstance(m, (ResidualTemporalMapBlock, Conv1dBlock))
    ]
    with torch.no_grad():
        feat = planner.model.encode_image(torch.zeros(1, 256, 900, 3, device=dev))
        planner.model(planner.init_trajs[:1], time=torch.ones(1, device=dev), img_feature=feat)
    for h in hooks:
        h.remove()
    del planner
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("build_model left TF32 on: the float32 model would not compute in float32")
    log("float32 math: build_model turned TF32 off for cuDNN and cuBLAS")

    def case(mod, args, B, dtype, gen):
        """(kernel, plain version, arguments) for block ``mod`` at batch B,
        with its weights and random inputs of the shape the path gave it."""
        L, cin = args[0].shape[1:]
        x = torch.randn(B, L, cin, generator=gen).to(dev, dtype)
        params = mod.kernel_params(dtype)
        if isinstance(mod, ResidualTemporalMapBlock):
            t = torch.randn(B, args[1].shape[1], generator=gen).to(dev, dtype)
            return kernels.fused_residual_block, kernels.residual_block_plain, (x, t) + params
        return kernels.fused_conv1d_gn_mish, kernels.conv1d_gn_mish_plain, (x,) + params

    report = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda, "shapes": []}

    # ---------------------------------------------------------------- 3. check
    gen = torch.Generator().manual_seed(0)
    max_err = {"fused_residual_block": 0.0, "fused_conv1d_gn_mish": 0.0}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            tol = KERNEL_TOL[str(dtype).split(".")[1]]
            for B in (1, 2):
                for n, m, a in calls:
                    fn, plain, args = case(m, a, B, dtype, gen)
                    got = fn(*args).float()
                    want = plain(*args).float()
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    ok = torch.allclose(got, want, **tol) and bool(torch.isfinite(got).all())
                    if dtype == torch.float32:
                        max_err[fn.__name__] = max(max_err[fn.__name__], err)
                    log(f"check {fn.__name__:22s} {n:22s} B={B} {tuple(args[0].shape)} "
                        f"{str(dtype)[6:]:8s} max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"{fn.__name__} at {n} B={B} {dtype}: max_abs_err {err}")

    phase_done(3)
    # ---------------------------------------------------------------- 4. path
    launches = {"fused_residual_block": 0, "fused_conv1d_gn_mish": 0}
    plans = {}
    frames = np.random.default_rng(1).integers(0, 256, (4, 256, 900, 3), dtype=np.uint8)
    target = np.array([0.3, 0.1], np.float32)
    for path in CONFIGS:
        cfg = load_cfg(path)
        gpu = DiffusionPlanner(cfg, seed=0, device=dev)
        tgt = target if gpu.use_guidance_type.name != "NO_GUIDANCE" else None
        n_fwd = len(cfg.TPU.SAMPLE_TIMESTEPS) or cfg.EVAL.SAMPLE_STEPS
        kernels.reset_launch_counts()
        first = gpu.plan(frames[0], tgt)
        torch.cuda.synchronize()
        got = {"fused_residual_block": kernels.fused_residual_block.launches,
               "fused_conv1d_gn_mish": kernels.fused_conv1d_gn_mish.launches}
        want = {"fused_residual_block": 16 * n_fwd, "fused_conv1d_gn_mish": n_fwd}
        log(f"path {path}: launches {got}, expected {want}")
        if got != want:
            raise AssertionError(f"{path}: launch counts {got} != {want}")
        for k in launches:
            launches[k] += got[k]
        if first.shape != (1, cfg.MODEL.HORIZON, cfg.MODEL.TRANSITION_DIM) or not np.isfinite(first).all():
            raise AssertionError(f"{path}: plan shape {first.shape} or non-finite values")

        cpu = DiffusionPlanner(cfg, seed=0, device="cpu")
        cpu.init_trajs = gpu.init_trajs.cpu()
        ref = cpu.plan(frames[0], tgt)
        diff = float(np.abs(first - ref).max())
        ok = np.allclose(first, ref, **PLAN_TOL)
        log(f"path {path}: GPU vs CPU plan max_abs_diff={diff:.3e} m {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{path}: GPU plan differs from the CPU plan by {diff} m")
        del cpu

        gpu.plan(frames[1], tgt)  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(5):
            t0 = time.perf_counter()
            gpu.plan(frames[i % len(frames)], tgt)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        p50 = float(np.median(times))
        peak = torch.cuda.max_memory_allocated() / 2**20
        busy = device_breakdown(lambda: gpu.plan(frames[2], tgt))
        plans[path] = {"steps": n_fwd, "plan_ms_p50": p50, "plan_ms": times, "peak_mib": peak,
                       "gpu_vs_cpu_max_abs_m": diff, "profile": busy}
        log(f"path {path}: plan p50 {p50:.2f} ms over {len(times)} plans ({n_fwd} steps), "
            f"peak {peak:.1f} MiB, on {smi}")
        log(f"path {path}: profiled plan {busy['wall_ms']:.2f} ms, device busy {busy['device_ms']:.2f} ms "
            f"({busy['busy_share']:.3f}); device ms by kind {busy['by_kind']}")
        del gpu
    report["plans"] = plans

    phase_done(4)
    # ---------------------------------------------------------------- 5. time
    def eager_cycle_ms(fns, reps=20, warm=3):
        """Mean ms of each fn, called eagerly in turn as one forward calls
        them: CUDA events between the calls, so the host's time to issue a
        call counts wherever the card waits for it."""
        for _ in range(warm):
            for f in fns:
                f()
        ev = [[torch.cuda.Event(enable_timing=True) for _ in range(len(fns) + 1)] for _ in range(reps)]
        for r in range(reps):
            ev[r][0].record()
            for i, f in enumerate(fns):
                f()
                ev[r][i + 1].record()
        torch.cuda.synchronize()
        return [sum(ev[r][i].elapsed_time(ev[r][i + 1]) for r in range(reps)) / reps for i in range(len(fns))]

    def graph_ms(fns, reps=20):
        """Device ms of one pass over fns: the pass is captured once in a
        CUDA graph and replayed, so no host time falls between launches."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for f in fns:
                f()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for f in fns:
                f()
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def geometries(fn, args):
        """The geometry of each launch of one call, as the wrapper launches it."""
        B, L, cin = args[0].shape
        if fn is kernels.fused_residual_block:
            return kernels.residual_block_geometry(B, L, cin, args[2].shape[2], args[1].shape[1],
                                                   args[12] is not None)
        return (kernels.head_geometry(B, L, cin, args[1].shape[2], args[1].shape[0], 8,
                                      args[0].element_size(), args[1].element_size()),)

    def describe(geo):
        if isinstance(geo, kernels.HeadGeometry):
            return (f"P={kernels.HEAD_P} S={geo.S} threads={geo.threads} copies={geo.width}B "
                    f"stage={geo.stage} ctas={geo.ctas}")
        return f"cs={geo.cs} ctas={geo.ctas}"

    def bound_ms(fn, args):
        x = args[0]
        B, L, cin = x.shape
        tensors = [a for a in args if a is not None]
        if fn is kernels.fused_residual_block:
            C, E = args[2].shape[2], args[1].shape[1]
            # E x C for the time bias, E x 2C for FiLM's scale and shift
            ops = 2 * B * (L * 5 * cin * C + L * 5 * C * C + E * args[6].shape[1]
                           + (L * cin * C if args[12] is not None else 0))
        else:
            C = args[1].shape[2]
            ops = 2 * B * L * 5 * cin * C
        nbytes = sum(a.numel() * a.element_size() for a in tensors) + B * L * C * x.element_size()
        rate = flops if x.dtype == torch.float32 else bf16_flops
        t_bytes, t_ops = nbytes / bw * 1e3, ops / rate * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    gen = torch.Generator().manual_seed(1)
    cases = [case(m, a, 1, torch.float32, gen) for n, m, a in calls]
    cases16 = [case(m, a, 1, torch.bfloat16, gen) for n, m, a in calls]
    # the residual block as the blocks launch their cached packs: on the
    # one-wave path with programmatic dependent launch where it applies
    kcall = lambda c: ((lambda: c[0](*c[2], weights_cached=True)) if c[0] is kernels.fused_residual_block
                       else (lambda: c[0](*c[2])))
    pcall = lambda c: (lambda: c[1](*c[2]))
    template_lib = build.library(kernels.SOURCE)

    def empty(geo):
        """An empty kernel launched as a launch of geometry ``geo`` is: in
        clusters of ``geo.cs`` for the template, with no cluster for the head
        (whose geometry has no ``cs``); with its shared memory."""
        def f():
            stream = torch.cuda.current_stream().cuda_stream
            err = template_lib.adm_empty_launch(geo.ctas, geo.threads, getattr(geo, "cs", 0),
                                                geo.smem, stream)
            if err != 0:
                raise RuntimeError(f"empty launch failed (CUDA error {err}, {geo})")
        return f

    def one_wave_paths(mine, geos, ms):
        """The batch-1 forward's residual calls on each path: with PDL (the
        ``ms`` above), on the one-wave path without it, and on today's path
        (the card said to hold no one-wave cluster); the same at batch 2;
        the launch floor at the one-wave geometries; each path's launches."""
        def today(fns):
            with multi_wave_only():
                return graph_ms(fns)

        plain_calls = [(lambda c=c: c[0](*c[2])) for c in mine]
        gen2 = torch.Generator().manual_seed(2)
        mine2 = [case(m, a, 2, torch.float32, gen2) for n, m, a in calls if isinstance(m, ResidualTemporalMapBlock)]
        wide = []
        for c, (g1, g2) in zip(mine, zip(geos[::2], geos[1::2])):
            x, t, w1, w2, wres = c[2][0], c[2][1], c[2][2], c[2][8], c[2][12]
            cin, C, E = x.shape[2], w1.shape[2], t.shape[1]
            L = x.shape[1]
            wide.append(kernels.one_wave_geometry(g1, L, cin, C, 5, 8, E, kernels.EPI_TBIAS, 4))
            wide.append(kernels.one_wave_geometry(g2, L, C, C, 5, 8, cin, kernels.EPI_RES_CONV if wres is not None
                                                  else kernels.EPI_RES_ID, 4))
        kernels.reset_launch_counts()
        for f in [kcall(c) for c in mine]:
            f()
        counts = kernels.launch_counts()
        out = dict(ms_one_wave_no_pdl=graph_ms(plain_calls), ms_today=today([kcall(c) for c in mine]),
                   ms_b2=graph_ms([kcall(c) for c in mine2]), ms_b2_today=today([kcall(c) for c in mine2]),
                   floor_ms_one_wave=graph_ms([empty(g) for g in wide]),
                   launches=2 * counts["fused_residual_block"],
                   one_wave_launches=counts["fused_residual_block.one_wave"],
                   pdl_launches=counts["fused_residual_block.pdl"])
        kernels.reset_launch_counts()
        for f in [kcall(c) for c in mine2]:
            f()
        counts = kernels.launch_counts()
        out.update(one_wave_launches_b2=counts["fused_residual_block.one_wave"],
                   pdl_launches_b2=counts["fused_residual_block.pdl"])
        log(f"time fused_residual_block paths: batch 1 one forward ms: PDL {ms:.4f}, one-wave "
            f"without PDL {out['ms_one_wave_no_pdl']:.4f}, today's path {out['ms_today']:.4f}, launch floor "
            f"at the one-wave geometries {out['floor_ms_one_wave']:.4f}; launches {out['launches']}, one-wave "
            f"{out['one_wave_launches']}, PDL {out['pdl_launches']}; batch 2: {out['ms_b2']:.4f} against "
            f"today's {out['ms_b2_today']:.4f}, one-wave {out['one_wave_launches_b2']}, PDL "
            f"{out['pdl_launches_b2']} of {out['launches']}, on {smi}")
        return out

    summary = {}
    with torch.no_grad():
        # one forward's calls of each kernel, in forward order: the weights of
        # a whole forward (61 MB) exceed the 50 MB L2, as in a plan
        for kname in ("fused_residual_block", "fused_conv1d_gn_mish"):
            mine = [c for c in cases if c[0].__name__ == kname]
            bounds = [bound_ms(c[0], c[2]) for c in mine]
            geos = [g for c in mine for g in geometries(c[0], c[2])]
            summary[kname] = dict(
                ms=graph_ms([kcall(c) for c in mine]),
                plain_ms=graph_ms([pcall(c) for c in mine]),
                bound_ms=sum(b for b, _ in bounds),
                bound_by="bytes" if all(by == "bytes" for _, by in bounds) else "operations",
                floor_ms=graph_ms([empty(g) for g in geos]),
                calls=len(mine), ctas=sum(g.ctas for g in geos),
            )
            if kname == "fused_residual_block":
                summary[kname].update(one_wave_paths(mine, geos, summary[kname]["ms"]))
            log(f"time {kname}: one forward's {len(mine)} calls ({len(geos)} launches, "
                f"{summary[kname]['ctas']} CTAs in all), device ms: kernel "
                f"{summary[kname]['ms']:.4f}, plain {summary[kname]['plain_ms']:.4f}, "
                f"bound {summary[kname]['bound_ms']:.7f}, launch floor {summary[kname]['floor_ms']:.4f} "
                f"on {smi}")
            # the same forward in bfloat16, the bound from bf16 bytes
            mine16 = [c for c in cases16 if c[0].__name__ == kname]
            bounds16 = [bound_ms(c[0], c[2]) for c in mine16]
            summary[kname].update(
                ms_bf16=graph_ms([kcall(c) for c in mine16]),
                plain_ms_bf16=graph_ms([pcall(c) for c in mine16]),
                bound_ms_bf16=sum(b for b, _ in bounds16),
                bound_by_bf16="bytes" if all(by == "bytes" for _, by in bounds16) else "operations",
            )
            log(f"time {kname} bfloat16: one forward's {len(mine16)} calls, device ms: kernel "
                f"{summary[kname]['ms_bf16']:.4f}, plain {summary[kname]['plain_ms_bf16']:.4f}, "
                f"bound {summary[kname]['bound_ms_bf16']:.7f} ({summary[kname]['bound_by_bf16']}) on {smi}")
        k_eager = eager_cycle_ms([kcall(c) for c in cases])
        p_eager = eager_cycle_ms([pcall(c) for c in cases])
        for (n, m, a), c, ke, pe in zip(calls, cases, k_eager, p_eager):
            fn, _, args = c
            b, by = bound_ms(fn, args)
            geos = geometries(fn, args)
            # the same call 20 times in one graph: device time with the
            # block's weights warm in L2
            reps = 20
            row = dict(kernel=fn.__name__, block=n, shape=list(args[0].shape),
                       C=int(args[2 if fn is kernels.fused_residual_block else 1].shape[-1]),
                       geometry=[describe(g) for g in geos],
                       kernel_us=graph_ms([kcall(c)] * reps) / reps * 1e3,
                       plain_us=graph_ms([pcall(c)] * reps) / reps * 1e3,
                       kernel_eager_us=ke * 1e3, plain_eager_us=pe * 1e3,
                       bound_us=b * 1e3, bound_by=by,
                       floor_us=graph_ms([empty(g) for g in geos] * reps) / reps * 1e3)
            report["shapes"].append(row)
            log(f"time {fn.__name__:22s} {n:22s} L={row['shape'][1]:2d} {row['shape'][2]:4d}->{row['C']:4d} "
                f"{'; '.join(row['geometry'])}: "
                f"kernel_us={row['kernel_us']:.2f} plain_us={row['plain_us']:.2f} "
                f"(eager, host included: {row['kernel_eager_us']:.1f} / {row['plain_eager_us']:.1f}) "
                f"bound_us={row['bound_us']:.5f} ({by}) floor_us={row['floor_us']:.3f} on {smi}")

        # the floor one launch pays: an empty kernel launched as the kernels
        # are, 20 in one graph (the template in clusters, the head plainly)
        report["launch_floor_us"] = []
        floors = [kernels.Geometry(cs, 1, threads, 0, ctas)
                  for ctas, threads, cs in ((8, 256, 1), (8, 1024, 1), (64, 1024, 8), (128, 1024, 8))]
        floors += [geometries(c[0], c[2])[0] for c in cases if c[0] is kernels.fused_conv1d_gn_mish][:1]
        for geo in floors:
            us = graph_ms([empty(geo)] * 20) / 20 * 1e3
            report["launch_floor_us"].append(dict(geometry=describe(geo), threads=geo.threads,
                                                  smem=geo.smem, us=us))
            how = (f"no cluster, {geo.smem} bytes of shared memory (the head's)"
                   if isinstance(geo, kernels.HeadGeometry) else f"in clusters of {geo.cs}")
            log(f"time empty launch: {geo.ctas} CTAs of {geo.threads} threads {how}: "
                f"{us:.3f} us of device time per launch in a graph, on {smi}")

        # each residual block at every cluster size the geometry can pick,
        # both launches forced to it (the same call 20 times in one graph)
        pick = kernels.launch_geometry
        try:
            for (n, m, a), c, row in zip(calls, cases, report["shapes"]):
                if c[0] is not kernels.fused_residual_block:
                    continue
                row["sweep_us"] = {}
                for cs in (1, 2, 4, 8):
                    kernels.launch_geometry = lambda *p, cs=cs, **kw: pick(*p, cs=cs)
                    row["sweep_us"][cs] = graph_ms([kcall(c)] * 20) / 20 * 1e3
                kernels.launch_geometry = pick
                log(f"sweep {n:22s} L={row['shape'][1]:2d} {row['shape'][2]:4d}->{row['C']:4d}: us at cs "
                    f"1/2/4/8 = {'/'.join(f'{v:.2f}' for v in row['sweep_us'].values())} "
                    f"(picked {'; '.join(row['geometry'])}) on {smi}")
        finally:
            kernels.launch_geometry = pick
    report["folded"] = folded(calls, case, graph_ms, bound_ms, smi)

    phase_done(5)
    # -------------------------------------------------------------- 6. agents
    report["agents"] = agents(load_cfg, case, device_breakdown, launches, max_err, smi)

    phase_done(6)
    # ------------------------------------------------- 7. the rest of serving
    report["serving"] = serving(load_cfg, device_breakdown, launches, smi)
    phase_done(7)
    # ------------------------------------------------------------ 8. training
    report["training"] = training(load_cfg, calls, case, graph_ms, bound_ms, device_breakdown, launches, smi)
    phase_done(8)
    # -------------------------------------------------------- 9. distillation
    report["distillation"] = distillation(load_cfg, device_breakdown, launches, smi)
    phase_done(9)
    # ----------------------------------------------------- 10. data parallel
    report["data_parallel"] = data_parallel(load_cfg, smi)
    phase_done(10)
    # ------------------------------------------------------ 11. the CARLA env
    report["carla"] = carla(load_cfg, device_breakdown, launches, smi)
    phase_done(11)
    # ----------------------------------------------- 12. the learnability harness
    report["learnability"] = learnability(device_breakdown, launches, smi)
    phase_done(12)
    # ------------------------------------------------- 13. the compiled plan
    report["compiled_plan"] = compiled_plan(load_cfg, device_breakdown, launches, smi)
    phase_done(13)
    # ----------------------------------- 14. the training-side steps compiled
    report["compiled_train"] = compiled_train(load_cfg, device_breakdown, launches, smi)
    phase_done(14)
    # ----------------------- 15. Diffusion Policy's FiLM blocks and head
    report["film"] = film(case, graph_ms, bound_ms, smi)
    phase_done(15)
    report["phase_done_s"] = phase_s

    kernels_line = []
    for kname in ("fused_residual_block", "fused_conv1d_gn_mish"):
        s = summary[kname]
        b32 = report["training"]["b32"][kname]
        source = kernels.HEAD_SOURCE if kname == "fused_conv1d_gn_mish" else kernels.SOURCE
        kernels_line.append(dict(
            name=kname, route="cuda", source=f"{PKG}/ops/csrc/{source}",
            replaces=REPLACES[kname], launches=launches[kname], max_abs_err=max_err[kname],
            ms=s["ms"], plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
            bound_by=s["bound_by"], library_ms=None, floor_ms=s["floor_ms"],
            ms_bf16=s["ms_bf16"], plain_ms_bf16=s["plain_ms_bf16"], bound_ms_bf16=s["bound_ms_bf16"],
            ms_b32=b32["ms"], plain_ms_b32=b32["plain_ms"], bound_ms_b32=b32["bound_ms"],
            recompute_backward_ms_b32=b32["recompute_backward_ms"],
            per=f"one U-Net forward at batch 1, device time: its {s['calls']} calls; ms, plain_ms, "
                f"bound_ms in float32, the *_bf16 keys in bfloat16, the *_b32 keys float32 at batch 32 "
                f"(the training batch), recompute_backward_ms_b32 the autograd.Function's backward of "
                f"those calls; diffusion_policy_cnn: phase 15's, Diffusion Policy's CNN at its published "
                f"widths, one batch-1 forward's calls in float32",
            library_note="no single PyTorch call computes this function",
            paths={k: v for k, v in s.items() if k.endswith(("today", "no_pdl", "b2", "one_wave", "launches"))},
            diffusion_policy_cnn=report["film"][kname],
        ))
    report["kernels"] = kernels_line
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    log(smi)
    log(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
