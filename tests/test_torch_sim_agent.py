"""The port's closed loop on its CARLA env, on the CPU against the JAX
package's: ``InteractAgent`` of each package (a tiny model, the port's
weights from ``from_jax_variables``, the JAX planner's init noise) drives
its own package's ``CarlaDrivingEnv`` over ``tests/mock_carla.py`` through
the integration task (a red light, 3 walkers, a scenario vehicle). Both
envs step with the port's control, so their observations stay equal
(checked exactly every tick), and each tick's plan, raw controls and
controls are held to ``test_torch_agents``' tolerances. Then the
evaluation CLI without ``--fake-env`` in both packages on the mock."""

import json
import sys
import unittest.mock as um

import numpy as np
import pytest

from autonomous_driving_with_diffusion_model_tpu.driving.interact_agent import InteractAgent as JAgent
from autonomous_driving_with_diffusion_model_tpu.driving.plan import DiffusionPlanner as JPlanner
from autonomous_driving_with_diffusion_model_tpu_torch import driving as tdrv
from test_torch_agents import CONTROL_ATOL, TRAJ_TOL, _cfg, _jcfg, _near_threshold, carry_jax_planner
from test_torch_sim_env import JAX, PORT, canon, integration_task, mock, sim  # noqa: F401  (mock: a fixture)

TICKS = 5


def _env(pkg, mock_carla):
    mock_carla._Vehicle._next_id = 1  # both worlds number their actors alike
    env = sim(pkg, "carla_env").CarlaDrivingEnv(seed=0, tasks=[integration_task(pkg)])
    env.world.actors.append(mock_carla.TrafficLight(x=57.0, state="Red"))
    return env, env.reset()


@pytest.mark.parametrize("mode", ["NO_GUIDANCE", "FREE_GUIDANCE", "CLASSIFIER_GUIDANCE"])
def test_interact_agent_on_the_carla_env_matches_jax(mock, mode):
    cfg = _cfg(mode, perception="tiny")
    port = tdrv.DiffusionPlanner(cfg, seed=0, device="cpu")
    jax_planner = JPlanner(_jcfg(cfg))
    carry_jax_planner(port, jax_planner, cfg)
    frames = {PORT: [], JAX: []}
    agents = {
        PORT: tdrv.InteractAgent(cfg, None, planner=port, on_frame=lambda s, t, c: frames[PORT].append((t, c))),
        JAX: JAgent(_jcfg(cfg), None, planner=jax_planner, on_frame=lambda s, t, c: frames[JAX].append((t, c))),
    }
    envs, obs = {}, {}
    for pkg in (JAX, PORT):
        envs[pkg], obs[pkg] = _env(pkg, mock)
    for tick in range(TICKS):
        assert canon(obs[PORT]) == canon(obs[JAX]), f"tick {tick}: the envs' observations differ"
        assert obs[PORT]["camera"].shape == (1, 256, 900, 3)
        for pkg in agents:
            agents[pkg].compute_control(obs[pkg])
        (t1, c1), (t2, c2) = frames[PORT][tick], frames[JAX][tick]
        np.testing.assert_allclose(t1, t2, **TRAJ_TOL, err_msg=f"tick {tick}")
        raw1, raw2 = t1[0, 0, -3:], t2[0, 0, -3:]
        np.testing.assert_allclose(raw1, raw2, rtol=0, atol=CONTROL_ATOL, err_msg=f"tick {tick}")
        if not _near_threshold(raw2):
            np.testing.assert_allclose(c1, c2, rtol=0, atol=CONTROL_ATOL, err_msg=f"tick {tick}")
        for pkg in envs:
            obs[pkg], reward, done, info = envs[pkg].step({0: c1})
        assert canon(envs[PORT].counters) == canon(envs[JAX].counters)
    for env in envs.values():
        env.close()


TINY = ["MODEL.DIM", "8", "MODEL.PERCEPTION", "tiny", "EVAL.SAMPLE_STEPS", "2"]


def test_evaluate_cli_on_the_carla_env_matches_jax(mock, monkeypatch, tmp_path):
    """Both CLIs over the mock's Endless route (two weathers share one env
    through its task rotation): the same records within the fake-env test's
    score tolerance, the env kind "carla", and the traced route length."""
    from autonomous_driving_with_diffusion_model_tpu.driving import evaluate_cli as jcli
    from autonomous_driving_with_diffusion_model_tpu.driving.plan import DiffusionPlanner as JP
    from autonomous_driving_with_diffusion_model_tpu_torch.driving import evaluate_cli as tcli
    from autonomous_driving_with_diffusion_model_tpu_torch.driving import plan as tplan
    from test_torch_evaluate import SCORE_TOL

    class Carried(tplan.DiffusionPlanner):
        def __init__(self, cfg, *args, **kwargs):
            super().__init__(cfg, *args, **kwargs)
            carry_jax_planner(self, JP(_jcfg(cfg)), cfg)

    monkeypatch.setattr(tplan, "DiffusionPlanner", Carried)
    args = ["--env-id", "Endless-v0", "--weather-group", "train_eval", "--max-steps", "12"]
    mock._Vehicle._next_id = 1
    want = jcli.main(args + ["--checkpoint-json", str(tmp_path / "j.json"), "--opts", *TINY])
    mock._Vehicle._next_id = 1
    got = tcli.main(args + ["--device", "cpu", "--checkpoint-json", str(tmp_path / "t.json"), "--opts", *TINY])
    records = got["_checkpoint"]["records"]
    assert len(records) == 2
    for a, b in zip(records, want["_checkpoint"]["records"]):
        assert a["meta"]["env_kind"] == b["meta"]["env_kind"] == "carla"
        assert a["status"] == b["status"] == "Completed"
        assert a["num_steps"] == b["num_steps"] == 12
        assert (a["route_id"], a["infractions"]) == (b["route_id"], b["infractions"])
        for k in a["scores"]:
            np.testing.assert_allclose(a["scores"][k], b["scores"][k], **SCORE_TOL, err_msg=k)
        np.testing.assert_allclose(a["meta"]["route_length"], b["meta"]["route_length"], **SCORE_TOL)
        assert a["meta"]["route_length"] > 0
    assert json.loads((tmp_path / "t.json").read_text())["entry_status"] == want["entry_status"]


def test_evaluate_cli_on_the_carla_env_resumes_aligned(mock, tmp_path):
    """A resumed run skips the finished route and points the shared env's
    task rotation at the next one (JAX ``driving/evaluate_cli.py:132-134``)."""
    from autonomous_driving_with_diffusion_model_tpu_torch.driving import evaluate_cli as tcli
    from autonomous_driving_with_diffusion_model_tpu_torch.sim import carla_env

    seen = []

    class Recorder(carla_env.CarlaDrivingEnv):
        def reset(self):
            out = super().reset()
            seen.append(self._task_idx)
            return out

    ckpt = tmp_path / "ckpt.json"
    args = ["--env-id", "Endless-v0", "--weather-group", "train_eval", "--device", "cpu",
            "--checkpoint-json", str(ckpt), "--max-steps", "3", "--opts", *TINY]
    with um.patch.object(carla_env, "CarlaDrivingEnv", Recorder):
        tcli.main(args)
        data = json.loads(ckpt.read_text())
        data["_checkpoint"]["records"] = data["_checkpoint"]["records"][:1]  # as if cut after route 0
        data["_checkpoint"]["progress"] = [1, 2]
        ckpt.write_text(json.dumps(data))
        first = list(seen)
        seen.clear()
        after = tcli.main(args)
    assert first == [0, 1]
    assert seen == [1]  # only route 1 ran, on task 1
    assert [r["index"] for r in after["_checkpoint"]["records"]] == [0, 1]
    assert sys.modules["carla"] is mock
