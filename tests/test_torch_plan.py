"""The port's DiffusionPlanner on the CPU against the JAX DiffusionPlanner:
the same weights (a reference-format .pth both load), the JAX planner's
init noise (and step noise, for DDPM), the same frame and target -> the same
K trajectories and the same best index, under every scheduler and scorer."""

import numpy as np
import pytest
import torch

import jax

from autonomous_driving_with_diffusion_model_tpu.driving.plan import DiffusionPlanner as JaxPlanner
from autonomous_driving_with_diffusion_model_tpu.models.scorer import init_scorer as jax_init_scorer
from autonomous_driving_with_diffusion_model_tpu.models.scorer import save_scorer as jax_save_scorer
from port_jax_cfg import jax_cfg_of
from autonomous_driving_with_diffusion_model_tpu_torch.driving import DiffusionPlanner
from autonomous_driving_with_diffusion_model_tpu_torch.utils.config import create_cfg

# meters: float32 on both sides, x 23.3 m, CFG amplifying by up to 2 * 7.5
TOL = dict(atol=5e-3, rtol=1e-4)
TARGET = np.array([0.3, 0.1], np.float32)


def _cfg(mode, k=4, scorer="auto", scheduler="ddim"):
    cfg = create_cfg()
    cfg.EVAL.SCHEDULER = scheduler
    cfg.MODEL.DIM = 64 if mode == "CLASSIFIER_GUIDANCE" else 8
    cfg.MODEL.DIM_MULTS = (1, 2)
    cfg.TRAIN.USE_COND = mode
    cfg.GUIDANCE.USE_COND = mode
    cfg.EVAL.SAMPLE_STEPS = 2
    cfg.TRAIN.IMAGE_HEIGHT = 32
    cfg.TRAIN.IMAGE_WIDTH = 48
    cfg.TPU.NUM_HYPOTHESES = k
    cfg.TPU.HYPOTHESIS_SCORER = scorer
    if mode == "FREE_GUIDANCE":
        cfg.GUIDANCE.FREE_SCALE = 7.5
    if mode == "CLASSIFIER_GUIDANCE":
        cfg.GUIDANCE.CLASSIFIER_SCALE = 15.0
        cfg.GUIDANCE.LOSS_LIST = [["TargetGuidance", []]]
    return cfg


@pytest.fixture
def frame(rng):
    return rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)


def _pair(cfg, tmp_path):
    """(port planner, JAX planner) on the same weights and init noise."""
    port = DiffusionPlanner(cfg, seed=0, device="cpu")
    path = tmp_path / "weights.pth"
    torch.save({"state_dict": port.model.state_dict()}, path)
    jcfg = jax_cfg_of(cfg)
    jax_planner = JaxPlanner(jcfg, checkpoint=str(path))
    port.init_trajs = torch.from_numpy(np.array(jax_planner.init_trajs))
    if port.step_noise is not None:
        # the JAX planner's fixed step noise (plan.py:111, sampler.py:158-164)
        shape = tuple(port.step_noise.shape)
        port.step_noise = torch.from_numpy(np.array(jax.random.normal(jax_planner._noise_key, shape)))
    return port, jax_planner


@pytest.mark.parametrize(
    "mode,k,scorer",
    [
        ("NO_GUIDANCE", 4, "auto"),
        ("FREE_GUIDANCE", 4, "auto"),
        ("FREE_GUIDANCE", 4, "jerk"),
        ("FREE_GUIDANCE", 4, "guidance_loss"),
        ("CLASSIFIER_GUIDANCE", 4, "auto"),
    ],
)
def test_plan_matches_jax_planner(tmp_path, frame, mode, k, scorer):
    _check_plan(tmp_path, frame, mode, k, scorer, "ddim")


@pytest.mark.parametrize(
    "mode,k,scheduler",
    [
        ("NO_GUIDANCE", 3, "ddpm"),
        ("FREE_GUIDANCE", 3, "ddpm"),
        ("FREE_GUIDANCE", 3, "dpm"),
        ("CLASSIFIER_GUIDANCE", 2, "dpm"),
    ],
)
def test_plan_with_other_schedulers_matches_jax_planner(tmp_path, frame, mode, k, scheduler):
    """DDPM with the JAX planner's step noise injected; DPM-Solver++ 2M."""
    _check_plan(tmp_path, frame, mode, k, "auto", scheduler)


def _check_plan(tmp_path, frame, mode, k, scorer, scheduler):
    port, jax_planner = _pair(_cfg(mode, k, scorer, scheduler), tmp_path)
    assert (port.step_noise is not None) == (scheduler == "ddpm")
    target = None if mode == "NO_GUIDANCE" else TARGET
    want, want_best = jax_planner.plan_hypotheses(frame, target)
    got, got_best = port.plan_hypotheses(frame, target)
    assert got.shape == (k, 16, 7)
    np.testing.assert_allclose(got, want, **TOL)
    assert got_best == want_best
    np.testing.assert_array_equal(port.plan(frame, target)[0], got[got_best])


def test_plan_begin_fetch_equals_plan(frame):
    planner = DiffusionPlanner(_cfg("FREE_GUIDANCE", 3), device="cpu")
    handle = planner.plan_begin(frame, TARGET)
    assert isinstance(handle[0], torch.Tensor)
    np.testing.assert_array_equal(planner.plan_fetch(handle), planner.plan(frame, TARGET))


def test_hoisting_off_gives_the_same_plan(frame):
    cfg = _cfg("NO_GUIDANCE", 2)
    hoisted = DiffusionPlanner(cfg, device="cpu").plan(frame)
    cfg.TPU.HOIST_PERCEPTION = False
    # meters: re-encoding runs the encoder at batch K instead of 1, and the
    # CPU convolutions then sum in another order (float32 ulps x 23.3 m)
    np.testing.assert_allclose(DiffusionPlanner(cfg, device="cpu").plan(frame), hoisted, atol=1e-3, rtol=1e-5)


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiffusionPlanner(_cfg("NO_GUIDANCE", 1))


@pytest.mark.parametrize("yaw", [0.3, -2.1, float("nan")])
def test_waypoint_helpers_match_jax(rng, yaw):
    """The port's own copies of the numpy helpers give the JAX module's values."""
    from autonomous_driving_with_diffusion_model_tpu.driving import plan as jplan
    from autonomous_driving_with_diffusion_model_tpu_torch.driving import plan as tplan

    nxt, cur = rng.normal(0, 20, 2), rng.normal(0, 20, 2)
    np.testing.assert_array_equal(tplan.process_next_waypoint(nxt, cur, yaw),
                                  jplan.process_next_waypoint(nxt, cur, yaw))
    traj = rng.normal(0, 5, (16, 2))
    np.testing.assert_array_equal(tplan.agent_to_world(traj, yaw, cur), jplan.agent_to_world(traj, yaw, cur))
    for w in (-0.7, 0.0, 0.45):
        assert tplan.way_point_to_pixel(w, 1.0) == jplan.way_point_to_pixel(w, 1.0)


@pytest.mark.parametrize("controls", [(0.5, 0.1, 0.02), (0.2, -0.3, 0.7), (0.1, 0.2, 0.3), (0.6, 0.4, 0.55)])
def test_post_process_control_matches_jax(controls):
    for name in ("post_process_control_interact", "post_process_control_leaderboard"):
        got = getattr(DiffusionPlanner, name)(*controls)
        want = getattr(JaxPlanner, name)(*controls)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=name)


@pytest.mark.parametrize("mode", ["NO_GUIDANCE", "FREE_GUIDANCE"])
def test_learned_scorer_picks_the_jax_planners_index(tmp_path, frame, mode):
    """A scorer .npz written by the JAX package drives both planners."""
    path = str(tmp_path / "scorer.npz")
    jax_save_scorer(path, jax_init_scorer(seed=1))
    cfg = _cfg(mode, 4, "learned")
    cfg.TPU.SCORER_CHECKPOINT = path
    port, jax_planner = _pair(cfg, tmp_path)
    target = None if mode == "NO_GUIDANCE" else TARGET
    want, want_best = jax_planner.plan_hypotheses(frame, target)
    got, got_best = port.plan_hypotheses(frame, target)
    np.testing.assert_allclose(got, want, **TOL)
    assert got_best == want_best


def test_learned_scorer_requires_checkpoint():
    with pytest.raises(ValueError, match="SCORER_CHECKPOINT"):
        DiffusionPlanner(_cfg("FREE_GUIDANCE", 2, "learned"), device="cpu")


def test_step_noise_follows_the_seed_and_the_fixed_noise_flag(frame):
    """Two planners of one seed draw the same init and step noise; with
    TPU.FIXED_INIT_NOISE every plan reuses them, without it every plan draws
    afresh (and the two planners still agree plan by plan)."""
    cfg = _cfg("NO_GUIDANCE", 2, scheduler="ddpm")
    a, b = DiffusionPlanner(cfg, seed=3, device="cpu"), DiffusionPlanner(cfg, seed=3, device="cpu")
    assert tuple(a.step_noise.shape) == (2, 2, 16, 7)  # (S, K, H, D)
    torch.testing.assert_close(a.step_noise, b.step_noise, atol=0, rtol=0)
    np.testing.assert_array_equal(a.plan(frame), a.plan(frame))
    cfg.TPU.FIXED_INIT_NOISE = False
    a, b = DiffusionPlanner(cfg, seed=3, device="cpu"), DiffusionPlanner(cfg, seed=3, device="cpu")
    first, second = a.plan_hypotheses(frame)[0], a.plan_hypotheses(frame)[0]
    assert not np.allclose(first, second)
    np.testing.assert_array_equal(b.plan_hypotheses(frame)[0], first)
    np.testing.assert_array_equal(b.plan_hypotheses(frame)[0], second)


def test_bf16_planner_plans_in_float32(frame):
    cfg = _cfg("FREE_GUIDANCE", 2, scheduler="dpm")
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    planner = DiffusionPlanner(cfg, device="cpu")
    assert all(p.dtype == torch.float32 for p in planner.model.parameters())
    trajs, best = planner.plan_hypotheses(frame, TARGET)
    assert trajs.dtype == np.float32 and np.isfinite(trajs).all() and 0 <= best < 2
