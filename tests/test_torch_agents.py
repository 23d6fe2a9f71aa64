"""The port's closed-loop layer on the CPU against the JAX package's: the
numpy helpers (PID, controller, route planner, GPS, fake env, watchdog) on
the same inputs, and the agents (``InteractAgent``, the leaderboard
``DiffusionAgent``, the interact CLI) over the same weights and the JAX
planner's init noise, tick by tick."""

import os

import numpy as np
import pytest
import torch

from autonomous_driving_with_diffusion_model_tpu.driving import fake_env as jfake
from autonomous_driving_with_diffusion_model_tpu.driving.controller import Controller as JController
from autonomous_driving_with_diffusion_model_tpu.driving.interact_agent import InteractAgent as JAgent
from autonomous_driving_with_diffusion_model_tpu.driving.pid import PIDController as JPID
from autonomous_driving_with_diffusion_model_tpu.driving.plan import DiffusionPlanner as JPlanner
from autonomous_driving_with_diffusion_model_tpu.driving.planner import RoutePlanner as JRoutePlanner
from autonomous_driving_with_diffusion_model_tpu.utils.config import create_cfg as jax_create_cfg
from autonomous_driving_with_diffusion_model_tpu_torch import driving as tdrv
from autonomous_driving_with_diffusion_model_tpu_torch.driving import fake_env as tfake
from autonomous_driving_with_diffusion_model_tpu_torch.driving import gps as tgps
from autonomous_driving_with_diffusion_model_tpu_torch.models.convert import from_jax_variables
from autonomous_driving_with_diffusion_model_tpu_torch.utils.config import create_cfg

# planned trajectories, meters: float32 on both sides, x 23.3 m, CFG
# amplifying by up to 2 * 7.5 (as tests/test_torch_plan.py)
TRAJ_TOL = dict(atol=5e-3, rtol=1e-4)
# the raw controls traj[0, 0, -3:], unscaled, and the controls made from them:
# float32 sums in another order, amplified by CFG
CONTROL_ATOL = 2e-4
# the interact post-processing's thresholds on the raw brake, and where the
# raw throttle meets it: closer than CONTROL_ATOL, the two packages may
# rightly take different branches
THRESHOLDS = (0.05, 0.5)
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "replay_town01.npz")


def _cfg(mode="NO_GUIDANCE", transition_dim=7, perception="resnet34"):
    cfg = create_cfg()
    cfg.MODEL.DIM = 64 if mode == "CLASSIFIER_GUIDANCE" else 8
    cfg.MODEL.DIM_MULTS = (1, 2)
    cfg.MODEL.PERCEPTION = perception
    cfg.MODEL.TRANSITION_DIM = transition_dim
    cfg.TRAIN.USE_COND = mode
    cfg.GUIDANCE.USE_COND = mode
    cfg.EVAL.SAMPLE_STEPS = 2
    cfg.TRAIN.IMAGE_HEIGHT = 32
    cfg.TRAIN.IMAGE_WIDTH = 48
    if mode == "FREE_GUIDANCE":
        cfg.GUIDANCE.FREE_SCALE = 7.5
    if mode == "CLASSIFIER_GUIDANCE":
        cfg.GUIDANCE.CLASSIFIER_SCALE = 15.0
        cfg.GUIDANCE.LOSS_LIST = [["TargetGuidance", []]]
    return cfg


def _jcfg(cfg):
    jcfg = jax_create_cfg()
    jcfg.merge_from_other_cfg(cfg)
    return jcfg


def _pair_pth(cfg, tmp_path):
    """(port planner, JAX planner): the port's seed weights through a
    reference-format .pth both load, and the JAX planner's init noise."""
    port = tdrv.DiffusionPlanner(cfg, seed=0, device="cpu")
    path = tmp_path / "weights.pth"
    torch.save({"state_dict": port.model.state_dict()}, path)
    jax_planner = JPlanner(_jcfg(cfg), checkpoint=str(path))
    port.init_trajs = torch.from_numpy(np.array(jax_planner.init_trajs))
    return port, jax_planner


def carry_jax_planner(port, jax_planner, cfg):
    """Give the port planner the JAX planner's weights and init noise."""
    port.model.load_state_dict(from_jax_variables(jax_planner.variables, cfg), strict=True)
    port.init_trajs = torch.from_numpy(np.array(jax_planner.init_trajs))


def _near_threshold(raw) -> bool:
    throttle, _, brake = (float(v) for v in raw)
    return (any(abs(brake - t) <= CONTROL_ATOL for t in THRESHOLDS)
            or abs(throttle - brake) <= CONTROL_ATOL)


# ------------------------------------------------------------ numpy helpers


def test_pid_matches_jax(rng):
    ours, ref = tdrv.PIDController(K_P=1.0, K_I=0.5, K_D=1.0, n=40), JPID(K_P=1.0, K_I=0.5, K_D=1.0, n=40)
    for e in rng.standard_normal(100) * 3:
        assert ours.step(float(e)) == pytest.approx(ref.step(float(e)), rel=1e-12, abs=0)


def test_controller_matches_jax(rng):
    ours, ref = tdrv.Controller(create_cfg()), JController(jax_create_cfg())
    for _ in range(40):
        wps = rng.standard_normal((4, 2)) * 5
        target = rng.standard_normal(2) * 5
        v = abs(rng.standard_normal()) * 5
        got, want = ours.control_pid(wps, v, target), ref.control_pid(wps, v, target)
        np.testing.assert_allclose(np.asarray(got, float), np.asarray(want, float), rtol=1e-12, atol=0)


def test_route_planner_matches_jax(rng):
    from autonomous_driving_with_diffusion_model_tpu_torch.sim.suites import TransformSpec

    pts = np.cumsum(rng.uniform(1.0, 6.0, (30, 2)), axis=0)
    # the harness's carla.Location-like nodes, Transform-like nodes and arrays
    route = [((TransformSpec(*p) if i % 3 else p), i % 6) for i, p in enumerate(pts)]
    ours, ref = tdrv.RoutePlanner(7.0, 50.0), JRoutePlanner(7.0, 50.0)
    ours.set_route(route)
    ref.set_route(route)
    for pos in np.linspace(pts[0], pts[-1], 40) + rng.normal(0, 1.0, (40, 2)):
        (p1, c1), (p2, c2) = ours.run_step(pos), ref.run_step(pos)
        np.testing.assert_allclose(p1, p2, rtol=1e-12, atol=0)
        assert c1 == c2 and len(ours.route) == len(ref.route)


def test_gps_matches_jax(rng):
    from autonomous_driving_with_diffusion_model_tpu.driving import gps as jgps

    for x, y, z in rng.normal(0, 300, (20, 3)):
        got, want = tgps.xyz2gps(x, y, z), jgps.xyz2gps(x, y, z)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
        np.testing.assert_allclose(tgps.gps2xyz(*got), jgps.gps2xyz(*want), rtol=1e-12, atol=1e-9)


def _assert_obs_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_fake_env_matches_jax(rng):
    route = np.stack([np.arange(0.0, 60.0, 2.0), np.sin(np.arange(30) / 5.0)], axis=-1)
    kw = dict(route=route, image_hw=(8, 12), bev_hw=(6, 6), seed=7)
    ours, ref = tfake.FakeDrivingEnv(**kw), jfake.FakeDrivingEnv(**kw)
    _assert_obs_equal(ours.reset(), ref.reset())
    for i in range(30):
        control = None if i % 4 == 3 else np.array([rng.uniform(0, 1), rng.uniform(-1, 1), rng.uniform(0, 0.3)])
        if i == 10:
            snaps = ours.snapshot(), ref.snapshot()
        got, want = ours.step({0: control}), ref.step({0: control})
        _assert_obs_equal(got[0], want[0])
        assert got[1:] == want[1:]
    ours.restore(snaps[0])
    ref.restore(snaps[1])
    _assert_obs_equal(ours.step({0: None})[0], ref.step({0: None})[0])

    obs = [ref.reset(), ref.step({0: None})[0]]
    r1, r2 = tfake.ReplayEnv(list(obs)), jfake.ReplayEnv(list(obs))
    assert r1.reset() is r2.reset()
    assert r1.step({0: 1})[1:] == r2.step({0: 1})[1:]


def test_watchdog_matches_jax():
    import time

    from autonomous_driving_with_diffusion_model_tpu.utils.watchdog import Watchdog as JWatchdog
    from autonomous_driving_with_diffusion_model_tpu_torch.utils.watchdog import Watchdog

    states = []
    for cls in (Watchdog, JWatchdog):
        fired = []
        w = cls(timeout=0.05, on_timeout=lambda f=fired: f.append(1))
        assert w._timeout == pytest.approx(1.05)  # the reference's 1 s of slack
        w._timeout = 0.1
        w.start()
        for _ in range(3):
            time.sleep(0.03)
            w.update()
        healthy = w.get_status()
        time.sleep(0.4)  # no updates: a hang
        w.stop()
        states.append((healthy, w.get_status(), fired))
    assert states[0] == states[1] == (True, False, [1])


# ------------------------------------------------------------------ agents


@pytest.mark.parametrize(
    "mode,transition_dim",
    [("NO_GUIDANCE", 7), ("FREE_GUIDANCE", 7), ("CLASSIFIER_GUIDANCE", 7), ("NO_GUIDANCE", 2)],
)
def test_interact_agent_episode_matches_jax(tmp_path, mode, transition_dim):
    """5 closed-loop ticks on the fake env, each package's agent driving its
    own copy of it: the same trajectories, raw controls and controls."""
    cfg = _cfg(mode, transition_dim)
    port, jax_planner = _pair_pth(cfg, tmp_path)
    frames = {"port": [], "jax": []}
    agents = {
        "port": tdrv.InteractAgent(cfg, None, planner=port,
                                   on_frame=lambda s, t, c: frames["port"].append((t, c))),
        "jax": JAgent(_jcfg(cfg), None, planner=jax_planner,
                      on_frame=lambda s, t, c: frames["jax"].append((t, c))),
    }
    envs = {k: m.FakeDrivingEnv(image_hw=(32, 48), bev_hw=(16, 16), seed=3)
            for k, m in (("port", tfake), ("jax", jfake))}
    obs = {k: e.reset() for k, e in envs.items()}
    for tick in range(5):
        for k in agents:
            control = agents[k].compute_control(obs[k])
            obs[k] = envs[k].step({0: control})[0]
        (t1, c1), (t2, c2) = frames["port"][tick], frames["jax"][tick]
        assert t1.shape == (1, 16, transition_dim)
        np.testing.assert_allclose(t1, t2, **TRAJ_TOL, err_msg=f"tick {tick}")
        if transition_dim == 7:
            raw1, raw2 = t1[0, 0, -3:], t2[0, 0, -3:]
            np.testing.assert_allclose(raw1, raw2, rtol=0, atol=CONTROL_ATOL, err_msg=f"tick {tick}")
            if not _near_threshold(raw2):
                np.testing.assert_allclose(c1, c2, rtol=0, atol=CONTROL_ATOL, err_msg=f"tick {tick}")
        else:  # the PID path: continuous in the waypoints but for its brake
            assert c1[2] == c2[2]
            np.testing.assert_allclose(c1, c2, rtol=0, atol=CONTROL_ATOL, err_msg=f"tick {tick}")
            assert 0.0 <= c1[0] <= cfg.CONTROL.MAX_THROTTLE


def _still_obs(n, seed=3):
    rng = np.random.default_rng(seed)
    return [
        {
            "camera": [rng.integers(0, 255, (32, 48, 3), np.uint8)],
            "bev": [np.zeros((64, 64, 3), np.uint8)],
            "compass": [[0.0]],
            "cur_waypoint": np.zeros((1, 2)),
            "next_waypoint": np.zeros((1, 2)),
            "next_command": [4],
            "state": [[0.0, 1.0, 0.5, 0.0, 0.0]],
            "at_red_light": [0],
        }
        for _ in range(n)
    ]


@pytest.mark.parametrize("mode", ["NO_GUIDANCE", "CLASSIFIER_GUIDANCE"])
def test_interact_agent_pipelined_one_frame_staleness(mode):
    """Pipelined: control at tick t comes from the frame-(t-1) plan, made on
    the worker thread (the first tick acts on its own plan). Classifier
    guidance takes its gradient on that thread."""
    cfg = _cfg(mode, perception="tiny")
    obs = _still_obs(4)
    planner = tdrv.DiffusionPlanner(cfg, device="cpu")
    seq, pipe = [], []
    tdrv.InteractAgent(cfg, tdrv.ReplayEnv(list(obs)), planner=planner,
                       on_frame=lambda s, t, c: seq.append(t)).run(max_steps=3)
    agent = tdrv.InteractAgent(cfg, tdrv.ReplayEnv(list(obs)), planner=planner, pipelined=True,
                               on_frame=lambda s, t, c: pipe.append(t))
    agent.run(max_steps=3)
    np.testing.assert_array_equal(pipe[0], seq[0])
    for t in range(1, 3):
        np.testing.assert_array_equal(pipe[t], seq[t - 1])
    agent.close()
    assert agent._executor is None and agent._pending_plan is None
    assert torch.is_grad_enabled()


def test_interact_agent_debug_outputs_match_jax(tmp_path, monkeypatch):
    """--plot-on-world draws the same world points, and the BEV dump writes
    the same images, as the JAX agent on the same plans."""
    import sys

    import cv2
    import mock_carla

    monkeypatch.setitem(sys.modules, "carla", mock_carla)
    cfg = _cfg("NO_GUIDANCE")
    port, jax_planner = _pair_pth(cfg, tmp_path)
    drawn = {}
    for name, cls, planner, mod in (("port", tdrv.InteractAgent, port, tfake),
                                    ("jax", JAgent, jax_planner, jfake)):
        env = mod.FakeDrivingEnv(image_hw=(32, 48), bev_hw=(512, 512), seed=1)
        env.world = mock_carla._World()
        agent = cls(cfg if name == "port" else _jcfg(cfg), env, planner=planner, plot_on_world=True,
                    bev_save_path=str(tmp_path / name))
        agent.run(max_steps=2)
        drawn[name] = np.array([[loc.x, loc.y, loc.z] for loc, _ in env.world.debug.strings])
    assert drawn["port"].shape == (2 * 16, 3)
    np.testing.assert_allclose(drawn["port"], drawn["jax"], **TRAJ_TOL)
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax")) == ["000000.jpg", "000001.jpg"]
    for f in files:
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port" / f)),
                                      cv2.imread(str(tmp_path / "jax" / f)))


def test_replay_goldens():
    """The JAX planner of tests/test_replay_env.py (PRNGKey(0) weights, tiny
    encoder, DDIM-2, 900x256 frames), carried into the port with
    ``from_jax_variables``: the port's InteractAgent over the same ReplayEnv
    reproduces the committed golden waypoints."""
    from test_replay_env import _observations

    cfg = create_cfg()
    cfg.MODEL.DIM = 8
    cfg.MODEL.PERCEPTION = "tiny"
    cfg.EVAL.SAMPLE_STEPS = 2
    port = tdrv.DiffusionPlanner(cfg, device="cpu")
    carry_jax_planner(port, JPlanner(_jcfg(cfg)), cfg)
    data = np.load(FIXTURE)
    env = tdrv.ReplayEnv(_observations(data))
    planned = []
    agent = tdrv.InteractAgent(cfg, env, planner=port, on_frame=lambda s, t, c: planned.append(t[0]))
    obs, done = env.reset(), False
    while not done:
        control = agent.compute_control(obs)
        assert np.all(np.isfinite(control))
        obs, _, done, _ = env.step({0: control})
    golden = data["golden_waypoints"]
    # meters: the goldens hold the JAX planner to 1e-4; the port's float32
    # convolutions and sums run in another order (7.4e-5 m off, at most)
    np.testing.assert_allclose(np.stack(planned[: len(golden)]), golden, atol=5e-4, rtol=1e-4)


# -------------------------------------------------------- leaderboard agent


def _leaderboard_cfg(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text(
        "MODEL:\n  DIM: 8\n  DIM_MULTS: [1, 2]\nEVAL:\n  SAMPLE_STEPS: 2\n"
        "TRAIN:\n  IMAGE_HEIGHT: 32\n  IMAGE_WIDTH: 48\n  USE_COND: FREE_GUIDANCE\n"
        "GUIDANCE:\n  USE_COND: FREE_GUIDANCE\n  FREE_SCALE: 7.5\n"
    )
    return str(path)


def sensor_input(rng, step, hw=(32, 48), bev=(64, 64)):
    """A harness sensor dict: BGRA camera frames, gps, speed, imu."""
    return {
        "rgb": (step, rng.integers(0, 255, hw + (4,), dtype=np.uint8)),
        "bev": (step, rng.integers(0, 255, bev + (4,), dtype=np.uint8)),
        "gps": (step, np.array([1.5 * step, 0.2 * step, 0.0])),
        "speed": (step, {"speed": 1.0 + 0.1 * step}),
        "imu": (step, np.array([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.1 * step])),
    }


def test_leaderboard_agent_matches_jax(tmp_path, rng):
    from autonomous_driving_with_diffusion_model_tpu.driving.leaderboard_agent import (
        DiffusionAgent as JLeaderboard,
    )

    path = _leaderboard_cfg(tmp_path)
    ref = JLeaderboard(path)
    ours = tdrv.DiffusionAgent(path, device="cpu")
    assert ours.sensors() == ref.sensors() and tdrv.get_entry_point() == "DiffusionAgent"
    carry_jax_planner(ours.planner, ref.planner, ours.cfg)
    raws = {}
    for name, agent in (("port", ours), ("jax", ref)):
        plan = agent.planner.plan
        raws[name] = []
        agent.planner.plan = lambda rgb, tp, plan=plan, out=raws[name]: out.append(plan(rgb, tp)) or out[-1]
        agent.set_global_plan(None, [((float(i * 5), 0.0), 4) for i in range(20)])
    for step in range(4):
        inputs = sensor_input(rng, step)
        c1, c2 = ours.run_step(inputs, 0.05 * step), ref.run_step(inputs, 0.05 * step)
        got, want = np.array([c1.throttle, c1.steer, c1.brake]), np.array([c2.throttle, c2.steer, c2.brake])
        if step < ours.cfg.ENV.AGENT_WARMUP:
            np.testing.assert_array_equal(got, want)
            continue
        np.testing.assert_allclose(raws["port"][-1], raws["jax"][-1], **TRAJ_TOL)
        if not _near_threshold(raws["jax"][-1][0, 0, -3:]):
            np.testing.assert_allclose(got, want, rtol=0, atol=CONTROL_ATOL)
    assert len(raws["port"]) == 4 - ours.cfg.ENV.AGENT_WARMUP
    ours.destroy()
    assert ours.planner is None


def test_leaderboard_tick_converts_like_cv2(tmp_path, rng):
    """The port's tick turns BGRA into RGB in numpy: the bytes cv2 gives."""
    import cv2

    from autonomous_driving_with_diffusion_model_tpu_torch.driving.leaderboard_agent import _bgr_to_rgb

    for shape in ((32, 48, 4), (256, 900, 4), (5, 7, 3)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        got = _bgr_to_rgb(img)
        assert got.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(got, cv2.cvtColor(img[:, :, :3], cv2.COLOR_BGR2RGB))


# ---------------------------------------------------------------- entry points


def _tiny_opts():
    return ["MODEL.DIM", "8", "MODEL.PERCEPTION", "tiny", "EVAL.SAMPLE_STEPS", "2",
            "TRAIN.IMAGE_HEIGHT", "32", "TRAIN.IMAGE_WIDTH", "48"]


def test_interact_cli_flag_plumbing(monkeypatch, tmp_path):
    """The port's interact CLI hands --pipelined / --save-bev-path to the
    agent and --device / --seed to the planner; it has no CARLA env, so it
    refuses the reference's CARLA-only flags."""
    from autonomous_driving_with_diffusion_model_tpu_torch import interact

    captured = {}

    class _Agent:
        def __init__(self, cfg, env, planner=None, bev_save_path=None, plot_on_world=False,
                     pipelined=False):
            captured.update(planner=planner, bev_save_path=bev_save_path,
                            plot_on_world=plot_on_world, pipelined=pipelined)

        def run(self, max_steps=None):
            captured["max_steps"] = max_steps
            return max_steps

        def close(self):
            captured["closed"] = True

    monkeypatch.setattr(tdrv, "InteractAgent", _Agent)
    monkeypatch.setattr(tdrv, "DiffusionPlanner", lambda cfg, seed=0, device=None: (seed, device))
    bev = str(tmp_path / "bev")
    assert interact.main(["--fake-env", "--pipelined", "--save-bev-path", bev,
                          "--max-steps", "1", "--seed", "4", "--device", "cpu",
                          "--opts", *_tiny_opts()]) == 1
    assert captured == {"planner": (4, "cpu"), "bev_save_path": bev, "plot_on_world": False,
                        "pipelined": True, "max_steps": 1, "closed": True}
    for flag in (["--plot-on-world"], ["--env-factory", "carla_native"], ["--town", "Town01"]):
        with pytest.raises(SystemExit):
            interact.parse_args(["--fake-env", *flag])


@pytest.mark.parametrize("pipelined", [False, True])
def test_interact_cli_runs_on_cpu(pipelined, capsys):
    from autonomous_driving_with_diffusion_model_tpu_torch import interact

    argv = ["--fake-env", "--device", "cpu", "--max-steps", "3"] + (["--pipelined"] if pipelined else [])
    assert interact.main(argv + ["--opts", *_tiny_opts()]) == 3
    assert "Closed loop finished after 3 steps" in capsys.readouterr().out


def _entry_points(tmp_path):
    from autonomous_driving_with_diffusion_model_tpu_torch import interact
    from autonomous_driving_with_diffusion_model_tpu_torch.driving import evaluate_cli

    ckpt = str(tmp_path / "ckpt.json")
    return {
        "InteractAgent": lambda: tdrv.InteractAgent(_cfg(perception="tiny"), None),
        "DiffusionAgent": lambda: tdrv.DiffusionAgent(_leaderboard_cfg(tmp_path)),
        "evaluate_cli": lambda: evaluate_cli.main(["--fake-env", "--checkpoint-json", ckpt,
                                                   "--max-steps", "2", "--opts", *_tiny_opts()]),
        "interact": lambda: interact.main(["--fake-env", "--max-steps", "1", "--opts", *_tiny_opts()]),
    }


@pytest.mark.parametrize("entry", ["InteractAgent", "DiffusionAgent", "evaluate_cli", "interact"])
def test_entry_point_needs_a_card_by_default(monkeypatch, tmp_path, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points(tmp_path)[entry]()


@pytest.mark.parametrize("cli", ["evaluate_cli", "interact"])
def test_cli_without_fake_env_names_the_missing_carla_env(tmp_path, cli):
    from autonomous_driving_with_diffusion_model_tpu_torch import interact
    from autonomous_driving_with_diffusion_model_tpu_torch.driving import evaluate_cli

    run = {
        "evaluate_cli": lambda: evaluate_cli.main(["--device", "cpu", "--checkpoint-json",
                                                   str(tmp_path / "c.json")]),
        "interact": lambda: interact.main(["--device", "cpu"]),
    }[cli]
    with pytest.raises(NotImplementedError, match="CARLA env layer"):
        run()
