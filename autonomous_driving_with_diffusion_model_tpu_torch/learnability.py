"""Learnability end to end: the port's whole pipeline learns to plan
(counterpart of the repo root's ``learnability.py``, with the same
functions, flags, JSON keys and gates).

    python -m autonomous_driving_with_diffusion_model_tpu_torch.learnability        # on the card
    python -m autonomous_driving_with_diffusion_model_tpu_torch.learnability --quick --device cpu

1. writes a small synthetic expert dataset in the reference's on-disk layout
   (``{root}/front/*.png``, ``bev/*.png``, ``waypoints/*.txt``) with the
   port's PNG writer: each sample a rendered road view whose marking angle
   encodes the route curvature, paired with the unicycle expert's 16-step
   trajectory, so the model must read the image to predict the turn;
2. trains the flagship model (ResNet-34 on 900x256, ``MODEL.DIM`` 64) with
   the port's train CLI (``train/cli.py``: loader, on-device augmentation,
   bfloat16 step, EMA, ``.pth`` checkpoints) past the EMA's activation;
3. evaluates the EMA checkpoint through the port's ``DiffusionPlanner`` on
   held-out samples: waypoint RMS in meters against the expert, the
   curvature classes' separation, and an untrained baseline;
4. drives the same checkpoint closed loop on ``FakeDrivingEnv`` (frames
   rendered from the ego's state), straight and on an S-curve, against the
   untrained weights; optionally the K = 8 scorers, a learned scorer, the
   controllability sweep and progressive distillation.

Writes ``LEARNABILITY_torch.json`` (and ``DISTILL_torch.json`` with
``--distill``). The untrained baseline is a torch-seeded random net (seed
3): a baseline of the JAX script's kind, with other values. It runs on the
card unless ``--device cpu`` is given; with no card it raises.
``train``, ``evaluate`` and ``distill`` take reduced counts for a short run.
Every planner plans from one fixed init-noise draw (``TPU.FIXED_INIT_NOISE``),
so a few-step sampler's closed loop depends on it: ``distill_draws``
evaluates a ``--distill`` run's teacher and students again per draw (the
planners' seeds, and an injected draw such as JAX's).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import os.path as osp
import re
import shutil
import subprocess
import tempfile
import time

import numpy as np

MAGIC = 23.315
DT = 0.1
SPEED = 5.0
TARGET_SPEED = 10.0  # the collector's speed normalizer (data_collect.py:132)
CLASSES = (-0.05, 0.0, 0.05)  # curvature rad/step: left, straight, right


# ------------------------------------------------------------------ renderer


def render_frame(curv: float, rng, hw=(256, 900)) -> np.ndarray:
    """Synthetic road view: a vanishing-road trapezoid with a center marking
    whose tilt encodes curvature. Cheap, deterministic given (curv, rng)."""
    h, w = hw
    img = np.zeros((h, w, 3), np.uint8)
    img[:, :, :] = (60, 70, 90)  # sky-ish
    horizon = h // 3
    img[horizon:, :, :] = (50, 50, 48)  # road
    # center marking: a bright line from bottom-center leaning with curvature
    xs = np.arange(h - 1, horizon, -1)
    frac = (h - 1 - xs) / max(h - 1 - horizon, 1)  # 0 at bottom -> 1 at horizon
    # marking bends sideways proportionally to curvature (+-180 px at |0.05|)
    cx = (w / 2) + np.clip(curv, -0.1, 0.1) / 0.05 * 180.0 * frac**1.5
    half = np.maximum(2.0, 14.0 * (1.0 - frac))
    for row, c, hf in zip(xs, cx, half):
        lo = int(np.clip(c - hf, 0, w - 1))
        hi = int(np.clip(c + hf, 0, w - 1))
        img[row, lo : hi + 1] = (230, 220, 120)
    noise = rng.integers(0, 18, img.shape, np.uint8)
    return np.clip(img.astype(np.int16) + noise - 9, 0, 255).astype(np.uint8)


def expert_trajectory(curv: float, rng) -> np.ndarray:
    """16-step unicycle rollout in the dataset's normalized ego frame
    (x = lateral/23.315, y = -forward/23.315, yaw = dyaw_deg/180, speed/10,
    [throttle, steer, brake])."""
    fwd = lat = 0.0
    heading = 0.0
    v = SPEED + rng.uniform(-0.3, 0.3)
    rows = []
    steer = float(np.clip(curv / 0.05 * 0.35, -1, 1))
    for _ in range(16):
        heading += curv
        fwd += v * DT * math.cos(heading)
        lat += v * DT * math.sin(heading)
        rows.append(
            [
                lat / MAGIC,
                -fwd / MAGIC,
                math.degrees(heading) / 180.0,
                v / TARGET_SPEED,
                0.6,
                steer,
                0.0,
            ]
        )
    return np.asarray(rows, np.float32)


def write_dataset(root: str, n_per_class: int, seed: int, hw) -> list:
    """The training set, RGB PNGs by ``data/png.py:write_png`` (no OpenCV):
    the same pixels and waypoint text as the JAX script's ``cv2`` writer."""
    from .data.png import write_png

    for sub in ("front", "bev", "waypoints"):
        os.makedirs(osp.join(root, sub), exist_ok=True)
    rng = np.random.default_rng(seed)
    samples = []
    idx = 0
    for curv in CLASSES:
        for _ in range(n_per_class):
            c = curv + rng.uniform(-0.004, 0.004)
            frame = render_frame(c, rng, hw)
            traj = expert_trajectory(c, rng)
            write_png(osp.join(root, "front", f"{idx:06d}.png"), frame, 1, level=1)
            # bev copies keep train.evaluate paintable; reuse the front frame
            write_png(osp.join(root, "bev", f"{idx:06d}.png"), frame[:256, :256], 1, level=1)
            target = traj[-1, :2]
            with open(osp.join(root, "waypoints", f"{idx:06d}.txt"), "w") as f:
                f.write(f"{target[0]} {target[1]}\n")
                for row in traj:
                    f.write(" ".join(str(float(v)) for v in row) + "\n")
            samples.append({"curv": c, "traj": traj, "frame_idx": idx})
            idx += 1
    return samples


def heldout_samples(n_per_class: int) -> list:
    """The held-out samples: per class ``n_per_class`` curvatures and their
    expert trajectories, frame indices from 900 (rendered when planned)."""
    rng_h = np.random.default_rng(7)
    heldout = [
        {"curv": c + rng_h.uniform(-0.004, 0.004), "traj": None, "frame_idx": 900 + i}
        for i, c in enumerate([cl for cl in CLASSES for _ in range(n_per_class)])
    ]
    for s in heldout:
        s["traj"] = expert_trajectory(s["curv"], np.random.default_rng(50 + s["frame_idx"]))
    return heldout


# ------------------------------------------------- curved-route closed loop


def build_s_curve_route(step_m: float = 0.5):
    """Route with real curvature: straight 30 m, left arc (R=20 m, 60 deg),
    straight 20 m, right arc (R=20 m, 60 deg), straight 20 m. Returns
    (points (N, 2), cumulative arc length (N,))."""
    pts = [np.zeros(2)]
    heading = 0.0
    segments = [(30.0, 0.0), (20.0 * math.pi / 3, 1 / 20.0),
                (20.0, 0.0), (20.0 * math.pi / 3, -1 / 20.0), (20.0, 0.0)]
    for length, kappa in segments:
        n = int(round(length / step_m))
        for _ in range(n):
            heading += kappa * step_m
            pts.append(pts[-1] + step_m * np.array([math.cos(heading), math.sin(heading)]))
    pts = np.asarray(pts)
    s = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(pts, axis=0), axis=-1))])
    return pts, s


def ego_lookahead(route, s_cum, pos, yaw, lookahead_m=8.0):
    """(forward, lateral-left, nearest_idx) of the point ``lookahead_m``
    ahead (by arc length) of the nearest route point, in the ego frame."""
    d = np.linalg.norm(route - np.asarray(pos)[None], axis=-1)
    i = int(np.argmin(d))
    j = int(np.searchsorted(s_cum, s_cum[i] + lookahead_m))
    j = min(j, len(route) - 1)
    dx, dy = route[j] - np.asarray(pos)
    f = math.cos(yaw) * dx + math.sin(yaw) * dy
    lat = -math.sin(yaw) * dx + math.cos(yaw) * dy
    return f, lat, i


# The training pairing: image rendered with curvature class c <-> expert
# trajectory whose lateral offset at the 8 m horizon is ~68*c meters. The
# closed-loop camera therefore renders c = lateral-of-8m-lookahead / 68:
# route curvature AND the car's own heading error, so the learned
# image->steer mapping closes the loop.
LOOKAHEAD_GAIN_M_PER_CLASS = 68.0


def closed_loop_curved(planner, hw, max_steps=400, use_target=True):
    """Drive the S-curve with state-consistent rendering. Returns (arc-length
    completion fraction, mean distance-to-route m)."""
    from .driving.fake_env import FakeDrivingEnv
    from .driving.plan import DiffusionPlanner

    route, s_cum = build_s_curve_route()

    def camera(e):
        _, lat, _ = ego_lookahead(route, s_cum, e.pos, e.yaw)
        c = float(np.clip(lat / LOOKAHEAD_GAIN_M_PER_CLASS, -0.1, 0.1))
        return render_frame(c, np.random.default_rng(7919 * e.steps + 3), hw)

    env = FakeDrivingEnv(route=route, image_hw=hw, seed=0, image_fn=camera)
    obs = env.reset()
    devs, best_s = [], 0.0
    for _ in range(max_steps):
        f, lat, i = ego_lookahead(route, s_cum, env.pos, env.yaw)
        target = (
            np.asarray([lat / MAGIC, -f / MAGIC], np.float32) if use_target else None
        )
        traj = planner.plan(np.asarray(obs["camera"][0], np.uint8), target)
        control = DiffusionPlanner.post_process_control_interact(*traj[0, 0, -3:])
        obs, _, done, _ = env.step({0: control})
        d = np.linalg.norm(route - env.pos[None], axis=-1)
        i = int(np.argmin(d))
        devs.append(float(d[i]))
        best_s = max(best_s, float(s_cum[i]))
        if done or (s_cum[-1] - best_s) < 2.0 or devs[-1] > 8.0:
            break
    return best_s / float(s_cum[-1]), float(np.mean(devs)) if devs else 0.0


# ------------------------------------------------- learned hypothesis scorer


def _route_geometry(route):
    """(segments, segment lengths, cumulative arc length) of a polyline."""
    seg = np.diff(route, axis=0)
    seg_len = np.linalg.norm(seg, axis=1)
    s_cum = np.concatenate([[0.0], np.cumsum(seg_len)])
    return seg, seg_len, s_cum


def route_deviation_and_progress(route, pos, geom=None):
    """Perpendicular distance from ``pos`` to the route POLYLINE plus the arc
    length of the projection point, segment-accurate for any waypoint
    spacing."""
    seg, seg_len, s_cum = geom if geom is not None else _route_geometry(route)
    rel = np.asarray(pos)[None] - route[:-1]
    t = np.clip(np.einsum("ij,ij->i", rel, seg) / (seg_len**2 + 1e-12), 0.0, 1.0)
    d = np.linalg.norm(rel - t[:, None] * seg, axis=1)
    i = int(np.argmin(d))
    return float(d[i]), float(s_cum[i] + t[i] * seg_len[i])


_STUB_FRAME = np.zeros((1, 1, 3), np.uint8)


def candidate_outcome(env, cand: np.ndarray, geom=None) -> float:
    """Execute one candidate plan OPEN-LOOP from the env's current state and
    return the realized outcome (lower = better): mean perpendicular route
    deviation over the horizon plus a shortfall penalty if the rollout gains
    less arc length than the nominal cruise. State (incl. RNG) is restored
    afterwards; rendering is stubbed for the rollout."""
    from .driving.plan import DiffusionPlanner

    route = np.asarray(env.route, np.float64)
    if geom is None:
        geom = _route_geometry(route)
    snap = env.snapshot()
    saved = env.image_fn, env.bev_hw
    env.image_fn, env.bev_hw = (lambda e: _STUB_FRAME), (1, 1)
    _, s0 = route_deviation_and_progress(route, env.pos, geom)
    devs = []
    for row in cand:
        control = DiffusionPlanner.post_process_control_interact(*row[-3:])
        env.step({0: control})
        devs.append(route_deviation_and_progress(route, env.pos, geom)[0])
    _, s1 = route_deviation_and_progress(route, env.pos, geom)
    env.image_fn, env.bev_hw = saved
    env.restore(snap)
    nominal = SPEED * DT * len(cand)
    return float(np.mean(devs) + 2.0 * max(0.0, 1.0 - (s1 - s0) / nominal))


def collect_outcome_dataset(planner, hw, episodes=6, steps_per_ep=80, seed=0):
    """Closed-loop exploration with counterfactual labeling: at each state,
    plan K fresh-noise hypotheses, label EVERY candidate by open-loop rollout
    (candidate_outcome), then execute a RANDOM candidate. Episodes alternate
    the straight route and the S-curve. Returns (trajs (N, K, H, C), targets
    (N, 2), outcomes (N, K), episode ids (N,))."""
    from .driving.fake_env import FakeDrivingEnv
    from .driving.plan import DiffusionPlanner

    straight = np.stack([np.arange(0.0, 200.0, 0.5), np.zeros(400)], axis=-1)
    curve, curve_s = build_s_curve_route()
    trajs_all, targets_all, outcomes_all, groups = [], [], [], []
    for ep in range(episodes):
        curved = ep % 2 == 1
        route = curve if curved else straight
        geom = _route_geometry(route)
        s_cum = geom[2]

        def camera(e, _route=route, _s=s_cum, _curved=curved):
            # deterministic per-step render so snapshot/restore is exact
            if not _curved:
                return render_frame(0.0, np.random.default_rng(7919 * e.steps + 1), hw)
            _, lat, _ = ego_lookahead(_route, _s, e.pos, e.yaw)
            c = float(np.clip(lat / LOOKAHEAD_GAIN_M_PER_CLASS, -0.1, 0.1))
            return render_frame(c, np.random.default_rng(7919 * e.steps + 3), hw)

        env = FakeDrivingEnv(route=route, image_hw=hw, seed=seed + ep, image_fn=camera)
        obs = env.reset()
        rng = np.random.default_rng(100 + ep)
        for _ in range(steps_per_ep):
            f, lat, _ = ego_lookahead(route, s_cum, env.pos, env.yaw)
            target = np.asarray([lat / MAGIC, -f / MAGIC], np.float32)
            trajs, _ = planner.plan_hypotheses(
                np.asarray(obs["camera"][0], np.uint8), target
            )
            outcomes_all.append([candidate_outcome(env, t, geom) for t in trajs])
            trajs_all.append(trajs)
            targets_all.append(target)
            groups.append(ep)
            k = int(rng.integers(0, len(trajs)))
            control = DiffusionPlanner.post_process_control_interact(*trajs[k][0, -3:])
            obs, _, done, _ = env.step({0: control})
            if done:
                break
    return (
        np.stack(trajs_all),
        np.stack(targets_all),
        np.asarray(outcomes_all, np.float32),
        np.asarray(groups, np.int32),
    )


def analytic_scorer_regrets(trajs, targets, outcomes, idx) -> dict:
    """Top-1 regret of the three analytic scorers (the formulas of
    ``driving/plan.py``) on rows ``idx`` of the outcome dataset: the offline
    baseline for the learned net. The TargetGuidance loss is taken per
    candidate, as the planner's ``guidance_loss`` scorer takes it."""
    import torch

    from .diffusion.guidance import target_guidance_loss

    t, g, o = trajs[idx], targets[idx], outcomes[idx]
    dist = np.sum((t[:, :, -1, :2] / MAGIC - g[:, None, :]) ** 2, axis=-1)
    jerk = np.diff(t[..., :2], n=2, axis=2)
    jerk = np.sum(jerk * jerk, axis=(2, 3))
    tt, gt = torch.from_numpy(np.asarray(t, np.float32)), torch.from_numpy(np.asarray(g, np.float32))
    with torch.no_grad():
        gl = np.asarray([[float(target_guidance_loss((tr / MAGIC)[None, :, :2], gt[n][None]))
                          for tr in tt[n]] for n in range(len(tt))], np.float32)

    def regret(score):
        pick = score.argmin(axis=1)
        return float(np.mean(o[np.arange(len(idx)), pick] - o.min(axis=1)))

    return {
        "distance": regret(dist),
        "jerk": regret(jerk),
        "guidance_loss": regret(gl),
    }


# ------------------------------------------------------------------ metrics


def heldout_frame(sample, hw) -> np.ndarray:
    """The frame a held-out sample is planned from."""
    return render_frame(sample["curv"], np.random.default_rng(1000 + sample["frame_idx"]), hw)


def heldout_l2_m(planner, heldout, hw, use_target=False):
    """RMS waypoint error (meters) of the planner's plans vs expert, plus the
    left/right separation check (does the plan read the image?)."""
    errs, lat_by_class = [], {}
    for s in heldout:
        frame = heldout_frame(s, hw)
        target = s["traj"][-1, :2] if use_target else None
        plan = planner.plan(frame, target)[0]  # (16, 7), xy in meters
        expert_xy = s["traj"][:, :2] * MAGIC
        errs.append(np.sqrt(np.mean((plan[:, :2] - expert_xy) ** 2)))
        cls = int(np.sign(round(s["curv"] / 0.05)))
        lat_by_class.setdefault(cls, []).append(float(plan[-1, 0]))
    sep_ok = bool(
        np.mean(lat_by_class.get(-1, [0.0])) < np.mean(lat_by_class.get(0, [0.0]))
        < np.mean(lat_by_class.get(1, [0.0]))
    ) or bool(
        np.mean(lat_by_class.get(-1, [0.0])) > np.mean(lat_by_class.get(0, [0.0]))
        > np.mean(lat_by_class.get(1, [0.0]))
    )
    return float(np.mean(errs)), sep_ok, {str(k): float(np.mean(v)) for k, v in lat_by_class.items()}


def closed_loop_completion(planner, hw, steps=120, seed=0, use_target=False):
    """Straight-route fake env with state-consistent rendered frames; returns
    (completion fraction, mean |lateral deviation| m) over ``steps`` ticks."""
    from .driving.fake_env import FakeDrivingEnv
    from .driving.plan import DiffusionPlanner

    rng = np.random.default_rng(seed)
    env = FakeDrivingEnv(
        image_hw=hw, seed=seed, image_fn=lambda e: render_frame(0.0, rng, hw)
    )
    obs = env.reset()
    # straight-ahead target in the dataset's normalized ego frame
    # (forward = -y; expert_trajectory stores y = -fwd/MAGIC)
    target = np.asarray([0.0, -SPEED * DT * 16 / MAGIC], np.float32) if use_target else None
    lat_devs = []
    for _ in range(steps):
        traj = planner.plan(np.asarray(obs["camera"][0], np.uint8), target)
        control = DiffusionPlanner.post_process_control_interact(*traj[0, 0, -3:])
        obs, _, done, _ = env.step({0: control})
        lat_devs.append(abs(float(env.pos[1])))
        if done:
            break
    total = np.linalg.norm(env.route[-1] - env.route[0])
    progress = float(np.clip((env.pos[0] - env.route[0][0]) / total, 0.0, 1.0))
    return progress, float(np.mean(lat_devs)) if lat_devs else 0.0


def distill_gates(teacher_at, students, measured, start):
    """The distillation claim:

    * ``rms_match_4_2``: at 4/2 steps the student must MATCH the naive
      teacher (held-out RMS within 5% of the same-step-count teacher);
    * ``rms_beat_at_1``: at 1 step the student must strictly beat it;
    * ``completion_held``: the 4-step student holds the full-grid teacher's
      closed-loop completion;
    * ``lateral_bounded_2x``: student mean |lateral| at k steps <= 2x the
      max of the full-grid teacher's and the teacher's run naively at k.

    A pure function of the recorded per-point metrics, so a result can be
    re-gated without re-running the measurement.
    """
    t_full = teacher_at[str(start)]
    return {
        "rms_match_4_2": all(
            students[k]["heldout_rms_m"] <= 1.05 * teacher_at[k]["heldout_rms_m"]
            for k in measured
        ),
        "rms_beat_at_1": (
            students["1"]["heldout_rms_m"] < teacher_at["1"]["heldout_rms_m"]
            if "1" in measured
            else True
        ),
        "completion_held": (
            students.get("4", {}).get("completion", 0.0)
            >= t_full["completion"] - 0.05
        ),
        "lateral_bounded_2x": all(
            students[k]["mean_abs_lat_m"]
            <= 2.0 * max(t_full["mean_abs_lat_m"], teacher_at[k]["mean_abs_lat_m"])
            for k in measured
        ),
    }


def closed_loop_expert_pace(steps=120, seed=0):
    """Model-free pace baseline for ``closed_loop_completion``: the env's
    expert autopilot (5 m/s cruise) on the SAME step budget. The 198 m
    straight route is not finishable in 120 ticks at sane speeds, so
    trained-planner completion is read against this number, not 1.0."""
    from .driving.fake_env import FakeDrivingEnv

    env = FakeDrivingEnv(image_hw=(8, 8), bev_hw=(8, 8), seed=seed)
    env.reset()
    for _ in range(steps):
        _, _, done, _ = env.step({0: None})
        if done:
            break
    total = np.linalg.norm(env.route[-1] - env.route[0])
    return float(np.clip((env.pos[0] - env.route[0][0]) / total, 0.0, 1.0))


# ------------------------------------------------------------ the pipeline


def make_cfg(use_cond="NO_GUIDANCE", hw=(256, 900), quick=False, **tpu):
    """The evaluation config: DDIM-10 in bfloat16 (DDIM-2, scale 15 under
    classifier guidance), ``TPU.<key>`` set from ``tpu``."""
    from .utils.config import create_cfg

    cfg = create_cfg()
    cfg.TRAIN.IMAGE_HEIGHT, cfg.TRAIN.IMAGE_WIDTH = hw
    cfg.EVAL.SAMPLE_STEPS = 10
    cfg.EVAL.SCHEDULER = "ddim"
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.TRAIN.USE_COND = use_cond
    if use_cond == "FREE_GUIDANCE":
        cfg.GUIDANCE.USE_COND = "FREE_GUIDANCE"
        cfg.GUIDANCE.FREE_SCALE = 7.5
    elif use_cond == "CLASSIFIER_GUIDANCE":
        # the reference's best published eval config
        # (configs/guidance/classifier_guidance.yaml): DDIM-2, TargetGuidance
        cfg.GUIDANCE.USE_COND = "CLASSIFIER_GUIDANCE"
        cfg.GUIDANCE.CLASSIFIER_SCALE = 15.0
        cfg.GUIDANCE.LOSS_LIST = [["TargetGuidance", []]]
        cfg.EVAL.SAMPLE_STEPS = 2
    for k, v in tpu.items():
        setattr(cfg.TPU, k, v)
    if quick:
        cfg.MODEL.DIM = 8
        cfg.MODEL.PERCEPTION = "tiny"
    return cfg


def card_name(device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or "cpu"."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def meter_times(train_log: str) -> list:
    """The train CLI's iteration meter: seconds per iteration over each
    ``TRAIN.LOG_INTERVAL``, in log order (``train.log``'s ``time:`` field)."""
    with open(train_log) as f:
        return [float(m.group(1)) for m in re.finditer(r"iter: \[\d+/\d+\]\s+time: ([0-9.]+)", f.read())]


def train_opts(data_root, run_dir, *, hw, max_iter, batch, use_cond="NO_GUIDANCE", bn_mode="frozen",
               quick=False, log_interval=None) -> list:
    """The train CLI's ``--opts``, the JAX script's: bfloat16, ``TPU.BN_MODE``,
    a checkpoint at the end only, no sampling."""
    if log_interval is None:
        log_interval = 20 if quick else 100
    opts = [
        "TRAIN.ROOT", data_root,
        "PROJECT_DIR", run_dir,
        "TRAIN.BATCH_SIZE", str(batch),
        "TRAIN.MAX_ITER", str(max_iter),
        "TRAIN.LOG_INTERVAL", str(log_interval),
        "TRAIN.SAVE_INTERVAL", str(max_iter),
        "TRAIN.SAMPLE_INTERVAL", "-1",
        "TRAIN.NUM_WORKERS", "4",
        "TRAIN.IMAGE_HEIGHT", str(hw[0]),
        "TRAIN.IMAGE_WIDTH", str(hw[1]),
        "TPU.COMPUTE_DTYPE", "bfloat16",
        "TRAIN.USE_COND", use_cond,
        "TPU.BN_MODE", bn_mode,
    ]
    if quick:
        opts += ["MODEL.DIM", "8", "MODEL.PERCEPTION", "tiny"]
    return opts


def train(data_root, run_dir, *, hw, max_iter, batch, use_cond="NO_GUIDANCE", bn_mode="frozen",
          quick=False, device=None, log_interval=None) -> dict:
    """Train through the port's train CLI (in this process) with
    :func:`train_opts`. Returns the final checkpoint's path and the CLI's
    iteration meter: its step p50 (the first interval, the warm-up, left
    out where there are more) and samples/s."""
    from .train import cli

    opts = train_opts(data_root, run_dir, hw=hw, max_iter=max_iter, batch=batch, use_cond=use_cond,
                      bn_mode=bn_mode, quick=quick, log_interval=log_interval)
    argv = ["--device", str(device), "--opts", *opts] if device is not None else ["--opts", *opts]
    print(f"[learnability] training: python -m autonomous_driving_with_diffusion_model_tpu_torch.train "
          f"{' '.join(argv)}", flush=True)
    t0 = time.perf_counter()
    state = cli.main(cli.parse_args(argv))
    seconds = time.perf_counter() - t0
    del state
    times = meter_times(osp.join(run_dir, "train.log"))
    steady = times[1:] or times
    p50 = float(np.median(steady)) if steady else float("nan")
    ckpt = osp.join(run_dir, "checkpoints", "final.pth")
    if not osp.exists(ckpt):  # encoders other than ResNet-34 save the port's own .pt
        ckpt = osp.join(run_dir, "checkpoints", "final.pt")
    return {"checkpoint": ckpt, "cli_seconds": seconds, "step_s_p50": p50,
            "samples_per_s": batch / p50 if p50 > 0 else float("nan"), "meter_s": times}


def _scorer_row(planner, hw, cv_steps, cl_steps):
    comp, dev = closed_loop_completion(planner, hw, steps=cl_steps, use_target=True)
    cvc, cvd = closed_loop_curved(planner, hw, max_steps=cv_steps, use_target=True)
    return {
        "completion": round(comp, 3),
        "mean_abs_lat_m": round(dev, 3),
        "curved_completion": round(cvc, 3),
        "curved_mean_dev_m": round(cvd, 3),
    }


def evaluate(ckpt, heldout, hw, *, use_cond="NO_GUIDANCE", quick=False, device=None, cl_steps=120,
             cv_steps=None, learned_scorer=False, workdir=None) -> dict:
    """Plan from checkpoint ``ckpt`` through ``DiffusionPlanner``: held-out
    RMS, the straight and curved closed loops against the untrained
    baseline, the expert's pace, and per mode the controllability sweep
    (classifier guidance), the K = 8 scorers and the learned scorer (CFG).
    Returns the result keys of the JAX script's JSON."""
    from .driving.fake_env import FakeDrivingEnv
    from .driving.plan import DiffusionPlanner

    if cv_steps is None:
        cv_steps = 30 if quick else 400
    guided = use_cond != "NO_GUIDANCE"
    cfg_of = lambda **tpu: make_cfg(use_cond, hw, quick, **tpu)
    print(f"[learnability] evaluating checkpoint {ckpt}", flush=True)
    trained = DiffusionPlanner(cfg_of(), checkpoint=ckpt, device=device)
    untrained = DiffusionPlanner(cfg_of(), checkpoint=None, seed=3, device=device)

    l2_trained, sep_ok, lat_means = heldout_l2_m(trained, heldout, hw, guided)
    l2_untrained, _, _ = heldout_l2_m(untrained, heldout, hw, guided)
    print(
        f"[learnability] held-out waypoint RMS: trained {l2_trained:.3f} m, "
        f"untrained {l2_untrained:.3f} m, class separation {sep_ok} {lat_means}",
        flush=True,
    )

    cl_trained, dev_trained = closed_loop_completion(trained, hw, steps=cl_steps, use_target=guided)
    cl_untrained, dev_untrained = closed_loop_completion(untrained, hw, steps=cl_steps, use_target=guided)
    cl_expert = closed_loop_expert_pace(steps=cl_steps)
    print(
        f"[learnability] closed-loop completion: trained {cl_trained:.2f} "
        f"(|lat| {dev_trained:.2f} m), untrained {cl_untrained:.2f} "
        f"(|lat| {dev_untrained:.2f} m), expert pace {cl_expert:.2f} "
        f"(step-budget cap, not 1.0)",
        flush=True,
    )

    # curved-route closed loop: the learned image->steer mapping steers
    # through real curvature, not just lane-keeps a straight road
    cv_comp_t, cv_dev_t = closed_loop_curved(trained, hw, max_steps=cv_steps, use_target=guided)
    cv_comp_u, cv_dev_u = closed_loop_curved(untrained, hw, max_steps=cv_steps, use_target=guided)
    print(
        f"[learnability] curved closed-loop: trained completion {cv_comp_t:.2f} "
        f"(dev {cv_dev_t:.2f} m), untrained {cv_comp_u:.2f} (dev {cv_dev_u:.2f} m)",
        flush=True,
    )
    del untrained

    # controllability sweep (classifier guidance): the SAME checkpoint asked
    # for arbitrary lateral targets on a straight road. TargetGuidance pulls
    # the argmin-distance waypoint, so that is the one measured; the target
    # sits inside the plan's ~8 m reach, or the loss's erratic-update guard
    # redirects the pull to the origin. At the final DDIM step scale 7.5
    # lands the waypoint on the target, the published 15 reflects past it.
    controllability = {}
    if use_cond == "CLASSIFIER_GUIDANCE" and not quick:
        targets_m = [-3.0, -1.5, 0.0, 1.5, 3.0]
        fwd_m = 6.5  # inside the ~8 m plan reach (see guard note above)

        def pulled_lat(traj, x):
            d = np.linalg.norm(traj[:, :2] - np.asarray([x, -fwd_m])[None], axis=-1)
            return float(traj[int(np.argmin(d)), 0])

        sweep = {}
        for scale in (15.0, 7.5):
            cfg_s = cfg_of()
            cfg_s.GUIDANCE.CLASSIFIER_SCALE = scale
            if scale == trained.cfg.GUIDANCE.CLASSIFIER_SCALE:
                planner_s = trained  # the flagship planner already runs this scale
            else:
                planner_s = DiffusionPlanner(cfg_s, checkpoint=ckpt, device=device)
            lats = []
            for i, x in enumerate(targets_m):
                frame = render_frame(0.0, np.random.default_rng(3000 + i), hw)
                tgt = np.asarray([x / MAGIC, -fwd_m / MAGIC], np.float32)
                lats.append(pulled_lat(planner_s.plan(frame, tgt)[0], x))
            err = [abs(v - x) for v, x in zip(lats, targets_m)]
            sweep[f"scale_{scale:g}"] = {
                "pulled_waypoint_lat_m": [round(v, 3) for v in lats],
                "mean_abs_err_m": round(float(np.mean(err)), 3),
                "monotonic": bool(np.all(np.diff(lats) > 0)),
            }

        # closed loop: guidance toward a laterally offset target must steer
        # the ego to that side through the action head
        offsets_m, tail_lat = [-2.0, 0.0, 2.0], []
        for off in offsets_m:
            rng_cl = np.random.default_rng(0)
            env = FakeDrivingEnv(
                image_hw=hw, seed=0, image_fn=lambda e: render_frame(0.0, rng_cl, hw)
            )
            obs = env.reset()
            tgt = np.asarray([off / MAGIC, -fwd_m / MAGIC], np.float32)
            lats = []
            for _ in range(120):
                traj = trained.plan(np.asarray(obs["camera"][0], np.uint8), tgt)
                control = DiffusionPlanner.post_process_control_interact(*traj[0, 0, -3:])
                obs, _, done, _ = env.step({0: control})
                lats.append(float(env.pos[1]))
                if done:
                    break
            tail_lat.append(round(float(np.mean(lats[40:])), 3))

        controllability = {
            "targets_m": targets_m,
            "target_fwd_m": fwd_m,
            "open_loop": sweep,
            "closed_loop_offsets_m": offsets_m,
            "closed_loop_tail_lat_m": tail_lat,
            "pass": bool(
                sweep["scale_7.5"]["mean_abs_err_m"] < 0.3
                and sweep["scale_7.5"]["monotonic"]
                and sweep["scale_15"]["monotonic"]
                and tail_lat[0] < -1.0 < 1.0 < tail_lat[2]
            ),
        }
        print(f"[learnability] controllability: {controllability}", flush=True)

    # K = 8 hypothesis scorers: the TargetGuidance objective as selector vs
    # comfort (jerk) vs the distance default, closed loop, same checkpoint
    scorer_cl = {}
    learned_scorer_info = {}
    if use_cond == "FREE_GUIDANCE" and not quick:
        for scorer in ("guidance_loss", "jerk", "auto"):
            planner_k = DiffusionPlanner(cfg_of(NUM_HYPOTHESES=8, HYPOTHESIS_SCORER=scorer), checkpoint=ckpt,
                                         device=device)
            scorer_cl[scorer] = _scorer_row(planner_k, hw, 400, cl_steps)
            print(f"[learnability] K=8 scorer={scorer}: {scorer_cl[scorer]}", flush=True)

    # learned scorer: counterfactual outcome dataset -> train
    # models/scorer.py -> closed loop
    if learned_scorer and use_cond == "FREE_GUIDANCE" and not quick:
        from .models.scorer import save_scorer, train_scorer

        t0s = time.time()
        collector = DiffusionPlanner(cfg_of(NUM_HYPOTHESES=8, FIXED_INIT_NOISE=False), checkpoint=ckpt,
                                     device=device)
        trajs_d, targets_d, outcomes_d, groups_d = collect_outcome_dataset(collector, hw)
        print(
            f"[learnability] outcome dataset: {trajs_d.shape[0]} states x "
            f"{trajs_d.shape[1]} candidates in {time.time() - t0s:.0f}s",
            flush=True,
        )
        params, sm = train_scorer(trajs_d, targets_d, outcomes_d, seed=0, groups=groups_d, device=device)
        val_idx = np.asarray(sm.pop("val_indices"))
        analytic = analytic_scorer_regrets(trajs_d, targets_d, outcomes_d, val_idx)
        scorer_path = osp.join(workdir, "scorer.npz")
        save_scorer(scorer_path, params)
        planner_l = DiffusionPlanner(
            cfg_of(NUM_HYPOTHESES=8, HYPOTHESIS_SCORER="learned", SCORER_CHECKPOINT=scorer_path),
            checkpoint=ckpt, device=device,
        )
        scorer_cl["learned"] = _scorer_row(planner_l, hw, 400, cl_steps)
        learned_scorer_info = {
            **{k: round(v, 5) if isinstance(v, float) else v for k, v in sm.items()},
            "val_top1_regret_analytic": {k: round(v, 5) for k, v in analytic.items()},
            "scorer_path": scorer_path,
        }
        print(
            f"[learnability] K=8 scorer=learned: {scorer_cl['learned']} | "
            f"offline val regret learned {sm['val_top1_regret']:.4f} vs "
            f"analytic {analytic}",
            flush=True,
        )

    return {
        "heldout_waypoint_rms_m_trained": round(l2_trained, 4),
        "heldout_waypoint_rms_m_untrained": round(l2_untrained, 4),
        "class_separation_ok": sep_ok,
        "final_lateral_mean_by_class_m": lat_means,
        "closedloop_completion_trained": round(cl_trained, 3),
        "closedloop_completion_untrained": round(cl_untrained, 3),
        "closedloop_completion_expert_pace": round(cl_expert, 3),
        "closedloop_mean_abs_lat_m_trained": round(dev_trained, 3),
        "closedloop_mean_abs_lat_m_untrained": round(dev_untrained, 3),
        "curved_completion_trained": round(cv_comp_t, 3),
        "curved_completion_untrained": round(cv_comp_u, 3),
        "curved_mean_dev_m_trained": round(cv_dev_t, 3),
        "curved_mean_dev_m_untrained": round(cv_dev_u, 3),
        "k8_scorer_closedloop": scorer_cl,
        "learned_scorer": learned_scorer_info,
        "controllability": controllability,
    }


def student_cfg(stage, use_cond, hw, quick=False, **tpu):
    """The evaluation config of a distill stage's student: its grid, and
    under CFG ``GUIDANCE.FREE_SCALE`` 1.0 (the student bakes the guidance
    scale in; the sampler runs one forward per step)."""
    cfg = make_cfg(use_cond, hw, quick, **{**tpu, "SAMPLE_TIMESTEPS": stage["timesteps"]})
    if use_cond == "FREE_GUIDANCE":
        cfg.GUIDANCE.FREE_SCALE = 1.0
    return cfg


def graph_vs_eager_m(planner, heldout, hw, use_target) -> float:
    """The largest |plan - eager plan| (m) over the held-out frames: the
    planner's program (a CUDA graph replay on the card) against its eager
    body ``_plan`` on the same inputs."""
    import torch

    worst = 0.0
    for s in heldout:
        frame = heldout_frame(s, hw)
        tgt = np.asarray(s["traj"][-1, :2] if use_target else np.zeros(2), np.float32).reshape(1, 2)
        trajs, _ = planner.plan_hypotheses(frame, tgt if use_target else None)
        eager, _ = planner._plan(planner.init_trajs, torch.from_numpy(frame).to(planner.device),
                                 torch.from_numpy(tgt).to(planner.device), planner.step_noise)
        worst = max(worst, float(np.abs(trajs - eager.cpu().numpy()).max()))
    return worst


def evaluate_distilled(manifest, ckpt, heldout, hw, *, use_cond="NO_GUIDANCE", quick=False, device=None,
                       start=50, eval_ks=(4, 2, 1), cl_steps=120, cv_steps=None, seed=0, init_trajs=None,
                       **tpu) -> dict:
    """The teacher ``ckpt`` at ``start`` steps, and each student of the
    distill ``manifest`` at ``eval_ks`` steps beside the teacher run at the
    same step count: held-out RMS and both closed loops per point, and
    ``distill_gates`` over them. Every planner draws its fixed init noise
    from ``seed`` (``DiffusionPlanner``'s own draw), or plans from
    ``init_trajs`` (K, horizon, D) where given; ``tpu`` sets ``TPU.<key>``
    of every planner's config (``make_cfg``)."""
    import torch

    from .driving.plan import DiffusionPlanner

    if cv_steps is None:
        cv_steps = 30 if quick else 400
    guided = use_cond != "NO_GUIDANCE"

    def eval_point(cfg, checkpoint):
        planner = DiffusionPlanner(cfg, checkpoint=checkpoint, seed=seed, device=device)
        if init_trajs is not None:
            planner.init_trajs = torch.as_tensor(np.asarray(init_trajs, np.float32)).to(planner.device)
        rms, _, _ = heldout_l2_m(planner, heldout, hw, guided)
        comp, dev = closed_loop_completion(planner, hw, steps=cl_steps, use_target=guided)
        cvc, cvd = closed_loop_curved(planner, hw, max_steps=cv_steps, use_target=guided)
        return {
            "heldout_rms_m": round(rms, 4),
            "completion": round(comp, 3),
            "mean_abs_lat_m": round(dev, 3),
            "curved_completion": round(cvc, 3),
            "curved_mean_dev_m": round(cvd, 3),
        }

    def teacher_cfg(k):
        cfg = make_cfg(use_cond, hw, quick, **tpu)
        cfg.EVAL.SAMPLE_STEPS = k
        return cfg

    students, teacher_at = {}, {}
    teacher_at[str(start)] = eval_point(teacher_cfg(start), ckpt)
    print(f"[learnability] distill teacher @{start}: {teacher_at[str(start)]}", flush=True)
    for stage in manifest["stages"]:
        k = stage["num_steps"]
        if k not in eval_ks:
            continue
        students[str(k)] = eval_point(student_cfg(stage, use_cond, hw, quick, **tpu), stage["checkpoint"])
        teacher_at[str(k)] = eval_point(teacher_cfg(k), ckpt)
        print(f"[learnability] distill @{k}-step: student {students[str(k)]} "
              f"vs teacher-leading {teacher_at[str(k)]}", flush=True)
    measured = [k for k in map(str, eval_ks) if k in students]
    return {"teacher": teacher_at, "students": students,
            "gates": distill_gates(teacher_at, students, measured, start)}


def distill_draws(workdir, out, *, use_cond="FREE_GUIDANCE", seeds=range(5), jax_init_trajs=None,
                  float32_draws=(), quick=False, device=None, cl_steps=120, cv_steps=None) -> dict:
    """``evaluate_distilled`` of the teacher and students a ``--distill``
    run left in ``workdir``, once per init-noise draw: the planners' own
    draw from each seed of ``seeds`` (``seed N``), and the JAX planner's,
    injected from the ``.npy`` at ``jax_init_trajs`` (``jax``). The draws
    named in ``float32_draws`` are evaluated again with every planner in
    float32 (``<draw> float32``). Writes ``out``: per draw the five metrics
    per point and the four gates, with the card's name and power limit."""
    from .driving.plan import DiffusionPlanner
    from .utils.device import resolve_device

    device = resolve_device(device)
    hw = (64, 96) if quick else (256, 900)
    with open(osp.join(workdir, "distill", "distill.json")) as f:
        manifest = json.load(f)
    ckpt = osp.join(workdir, "run", "checkpoints", "final.pt" if quick else "final.pth")
    heldout = heldout_samples(3 if quick else 8)
    draws = {f"seed {s}": dict(seed=int(s)) for s in seeds}
    if jax_init_trajs is not None:
        draws["jax"] = dict(init_trajs=np.load(jax_init_trajs))
    runs = [(name, kw, {}) for name, kw in draws.items()]
    runs += [(f"{name} float32", draws[name], {"COMPUTE_DTYPE": "float32"}) for name in float32_draws]
    result = {"workdir": workdir, "manifest": manifest, "teacher_checkpoint": ckpt,
              "jax_init_trajs": jax_init_trajs, "draws": {}}
    t0 = time.time()
    for name, kw, tpu in runs:
        ev = evaluate_distilled(manifest, ckpt, heldout, hw, use_cond=use_cond, quick=quick, device=device,
                                start=manifest["start_steps"], cl_steps=cl_steps, cv_steps=cv_steps, **kw, **tpu)
        result["draws"][name] = {**ev, "pass": all(ev["gates"].values())}
        print(f"[learnability] draw {name}: gates {ev['gates']}", flush=True)
    # the CFG student's key: the plan's CUDA graph against its eager body
    result["graph_vs_eager_max_abs_m"] = {
        str(st["num_steps"]): graph_vs_eager_m(
            DiffusionPlanner(student_cfg(st, use_cond, hw, quick), checkpoint=st["checkpoint"], device=device),
            heldout, hw, use_cond != "NO_GUIDANCE")
        for st in manifest["stages"] if st["num_steps"] in (4, 2, 1)}
    print(f"[learnability] students' graph vs eager plans, max abs m: {result['graph_vs_eager_max_abs_m']}",
          flush=True)
    result["seconds"] = round(time.time() - t0, 1)
    result["device"] = card_name(device)
    with open(out, "w") as f:
        json.dump(result, f, indent=2)
        f.write("\n")
    return result


def distill(ckpt, data_root, heldout, hw, *, use_cond="NO_GUIDANCE", quick=False, device=None, batch=64,
            start=50, iters=800, stages=6, workdir, cl_steps=120, cv_steps=None, eval_ks=(4, 2, 1),
            seed=0) -> dict:
    """Progressively distill ``ckpt`` through the port's distill CLI (in
    this process; the DDIM grid halved ``stages`` times from ``start``),
    then benchmark the few-step students against the teacher run at the
    same step counts (held-out RMS and both closed loops) and gate them."""
    from . import distill as distill_cli

    dworkdir = osp.join(workdir, "distill")
    dopts = [
        "TRAIN.ROOT", data_root,
        "TRAIN.BATCH_SIZE", str(batch),
        "TRAIN.IMAGE_HEIGHT", str(hw[0]),
        "TRAIN.IMAGE_WIDTH", str(hw[1]),
        "TRAIN.USE_COND", use_cond,
        "TPU.COMPUTE_DTYPE", "bfloat16",
    ]
    if use_cond == "FREE_GUIDANCE":
        dopts += ["GUIDANCE.FREE_SCALE", "7.5"]
    if quick:
        dopts += ["MODEL.DIM", "8", "MODEL.PERCEPTION", "tiny"]
    argv = ["--checkpoint", ckpt, "--workdir", dworkdir, "--start-steps", str(start), "--stages", str(stages),
            "--iters", str(iters), "--seed", str(seed)]
    if device is not None:
        argv += ["--device", str(device)]
    argv += ["--opts", *dopts]
    print(f"[learnability] distilling: python -m autonomous_driving_with_diffusion_model_tpu_torch.distill "
          f"{' '.join(argv)}", flush=True)
    t0d = time.time()
    dmanifest = distill_cli.main(distill_cli.parse_args(argv))

    ev = evaluate_distilled(dmanifest, ckpt, heldout, hw, use_cond=use_cond, quick=quick, device=device,
                            start=start, eval_ks=eval_ks, cl_steps=cl_steps, cv_steps=cv_steps)
    teacher_at, students, gates = ev["teacher"], ev["students"], ev["gates"]
    measured = [k for k in map(str, eval_ks) if k in students]
    return {
        "start_steps": start,
        "iters_per_stage": iters,
        "stage_steps": [s["num_steps"] for s in dmanifest["stages"]],
        "grids": {str(s["num_steps"]): s["timesteps"] for s in dmanifest["stages"]},
        "teacher": teacher_at,
        "students": students,
        "seconds": round(time.time() - t0d, 1),
        "seed": seed,
        "gates": gates,
        "pass": bool(quick) or bool(measured and all(gates.values())),
    }


def gates_pass(result: dict, quick: bool) -> bool:
    """The JAX script's gates on the result keys."""
    return bool(
        result["heldout_waypoint_rms_m_trained"] < 1.5
        and result["heldout_waypoint_rms_m_trained"] < 0.5 * result["heldout_waypoint_rms_m_untrained"]
        and result["class_separation_ok"]
        and result["closedloop_completion_trained"] > result["closedloop_completion_untrained"] + 0.1
        and (quick or result["curved_completion_trained"] > result["curved_completion_untrained"] + 0.5)
        and result["controllability"].get("pass", True)
    )


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true", help="tiny CPU smoke")
    ap.add_argument("--workdir", default=osp.join(tempfile.gettempdir(), "adm_learnability_torch"))
    ap.add_argument("--skip-train", action="store_true", help="reuse an existing checkpoint in workdir")
    ap.add_argument("--out", default="LEARNABILITY_torch.json")
    ap.add_argument("--device", default=None, help="torch device (default: the card; cpu for a CPU run)")
    ap.add_argument(
        "--use-cond", default="NO_GUIDANCE",
        choices=["NO_GUIDANCE", "FREE_GUIDANCE", "CLASSIFIER_GUIDANCE"],
        help="FREE_GUIDANCE trains/evaluates the CFG path and also runs the K=8 hypothesis-scorer "
        "closed-loop comparison (guidance_loss vs jerk); CLASSIFIER_GUIDANCE trains the state-head "
        "variant and runs the controllability sweep (DDIM-2, scale 15)",
    )
    ap.add_argument(
        "--learned-scorer", action="store_true",
        help="with FREE_GUIDANCE: collect a counterfactual outcome dataset on the fake env, train "
        "models/scorer.py on it, and benchmark the learned scorer closed loop against the analytic ones",
    )
    ap.add_argument(
        "--distill", action="store_true",
        help="after the standard eval, progressively distill the trained checkpoint and benchmark the "
        "few-step students against the teacher run at the same step counts; writes --distill-out",
    )
    ap.add_argument("--distill-start", type=int, default=50, help="teacher grid size the halving chain starts from")
    ap.add_argument("--distill-iters", type=int, default=800, help="distillation iterations per stage")
    ap.add_argument("--distill-out", default="DISTILL_torch.json")
    ap.add_argument("--distill-seed", type=int, default=0,
                    help="the distill CLI's --seed: its batches' order and its draws (with --skip-train, "
                    "another distillation of the same teacher)")
    ap.add_argument(
        "--bn-mode", default="frozen", choices=["train", "frozen"],
        help="TPU.BN_MODE for the training run: 'frozen' keeps the encoder's BatchNorm in eval mode, "
        "'train' reproduces the reference's batch statistics",
    )
    args = ap.parse_args(argv)
    if args.learned_scorer and (args.use_cond != "FREE_GUIDANCE" or args.quick):
        ap.error("--learned-scorer requires --use-cond FREE_GUIDANCE without "
                 "--quick (it would otherwise be silently skipped)")
    if args.distill and args.use_cond == "CLASSIFIER_GUIDANCE":
        ap.error("--distill rejects CLASSIFIER_GUIDANCE (in-loop gradient "
                 "guidance has no distillation target; its flagship config "
                 "already plans in 2 steps)")
    return args


def main(argv=None) -> dict:
    from .utils.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)  # no card and no --device cpu: raises
    quick = args.quick
    hw = (64, 96) if quick else (256, 900)
    n_train_per_class = 8 if quick else 40
    n_heldout_per_class = 3 if quick else 8
    # past the EMA activation (update_after_step=5000) so the EMA-overwrite
    # eval path is the real thing, except in quick mode
    max_iter = 60 if quick else 6500
    batch = 8 if quick else 64
    card = card_name(device)

    t0 = time.time()
    data_root = osp.join(args.workdir, "data")
    run_dir = osp.join(args.workdir, "run")
    if not args.skip_train:
        shutil.rmtree(args.workdir, ignore_errors=True)
    train_samples = write_dataset(data_root, n_train_per_class, seed=0, hw=hw)
    heldout = heldout_samples(n_heldout_per_class)
    trained = None
    if not args.skip_train:
        trained = train(data_root, run_dir, hw=hw, max_iter=max_iter, batch=batch, use_cond=args.use_cond,
                        bn_mode=args.bn_mode, quick=quick, device=device)
        ckpt = trained["checkpoint"]
    else:
        ckpt = osp.join(run_dir, "checkpoints", "final.pth" if not quick else "final.pt")
    train_s = time.time() - t0

    evaluated = evaluate(ckpt, heldout, hw, use_cond=args.use_cond, quick=quick, device=device,
                         learned_scorer=args.learned_scorer, workdir=args.workdir)

    distill_info = {}
    if args.distill:
        distill_info = distill(ckpt, data_root, heldout, hw, use_cond=args.use_cond, quick=quick, device=device,
                               batch=batch, start=8 if quick else args.distill_start,
                               iters=6 if quick else args.distill_iters, workdir=args.workdir,
                               seed=args.distill_seed)
        distill_info["device"] = card
        with open(args.distill_out, "w") as f:
            json.dump(distill_info, f, indent=2)
            f.write("\n")
        print(f"[learnability] distill: {json.dumps(distill_info)}", flush=True)

    result = {
        "quick": quick,
        "use_cond": args.use_cond,
        "bn_mode": args.bn_mode,
        "model_dim": 8 if quick else 64,
        "perception": "tiny" if quick else "resnet34",
        "image_hw": list(hw),
        "train_iters": max_iter,
        "train_seconds": None if args.skip_train else round(train_s, 1),
        "n_train": len(train_samples),
        "n_heldout": len(heldout),
        **evaluated,
        "distill": distill_info,
    }
    result["pass"] = gates_pass(result, quick)
    result.update({
        "device": card,
        "train_batch": batch,
        "train_step_ms_p50": None if trained is None else round(trained["step_s_p50"] * 1e3, 2),
        "train_samples_per_s": None if trained is None else round(trained["samples_per_s"], 2),
        "untrained_baseline": "a torch-seeded random net (DiffusionPlanner seed 3): the JAX script's kind "
                              "of baseline, with other values",
        "train_samples_per_s_from": "the train CLI's iteration meter (train.log 'time:', seconds per "
                                    "iteration over each TRAIN.LOG_INTERVAL, the first interval left out), "
                                    "TRAIN.BATCH_SIZE over its median",
    })
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
        f.write("\n")
    print(f"[learnability] {json.dumps(result)}", flush=True)
    return result


if __name__ == "__main__":
    main()
