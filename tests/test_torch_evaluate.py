"""The port's evaluation layer on the CPU against the JAX package's: scoring,
statistics (and its CLI), the leaderboard global record, route parsing,
the suites, the route evaluator on the same agents and envs, and the
evaluation CLI on the fake env with the same weights and init noise."""

import json

import numpy as np
import pytest

from autonomous_driving_with_diffusion_model_tpu.driving import evaluate_cli as jcli
from autonomous_driving_with_diffusion_model_tpu.driving import leaderboard_stats as jls
from autonomous_driving_with_diffusion_model_tpu.driving import routes as jroutes
from autonomous_driving_with_diffusion_model_tpu.driving import scoring as jscoring
from autonomous_driving_with_diffusion_model_tpu.driving import statistics as jstats
from autonomous_driving_with_diffusion_model_tpu.driving.evaluator import RouteEvaluator as JEvaluator
from autonomous_driving_with_diffusion_model_tpu.driving.fake_env import FakeDrivingEnv as JFakeEnv
from autonomous_driving_with_diffusion_model_tpu.sim import suites as jsuites
from autonomous_driving_with_diffusion_model_tpu_torch.driving import evaluate_cli as tcli
from autonomous_driving_with_diffusion_model_tpu_torch.driving import leaderboard_stats as tls
from autonomous_driving_with_diffusion_model_tpu_torch.driving import plan as tplan
from autonomous_driving_with_diffusion_model_tpu_torch.driving import routes as troutes
from autonomous_driving_with_diffusion_model_tpu_torch.driving import scoring as tscoring
from autonomous_driving_with_diffusion_model_tpu_torch.driving import statistics as tstats
from autonomous_driving_with_diffusion_model_tpu_torch.driving.evaluator import RouteEvaluator
from autonomous_driving_with_diffusion_model_tpu_torch.driving.fake_env import FakeDrivingEnv
from autonomous_driving_with_diffusion_model_tpu_torch.sim import suites as tsuites

TINY = ["MODEL.DIM", "8", "MODEL.PERCEPTION", "tiny", "EVAL.SAMPLE_STEPS", "2"]
# scores of one fake-env route, percent: the two packages' plans differ by
# float32 ulps, and the odometry sums them over the route's steps
SCORE_TOL = dict(rtol=1e-5, atol=1e-4)


def _counters(rng, cls):
    ints = {k: int(rng.integers(0, 3)) for k in (
        "collisions_layout", "collisions_vehicle", "collisions_pedestrian", "collisions_others",
        "red_light", "encounter_light", "stop_infraction", "encounter_stop", "route_dev",
        "vehicle_blocked")}
    return cls(**ints, outside_lane_m=float(rng.uniform(0, 30)), wrong_lane_m=float(rng.uniform(0, 20)))


@pytest.mark.parametrize("endless,timeout,completed", [(False, False, False), (False, True, False),
                                                       (False, False, True), (True, False, False)])
def test_episode_stats_match_jax(rng, endless, timeout, completed):
    assert tscoring.PENALTIES == jscoring.PENALTIES
    for _ in range(10):
        seed = int(rng.integers(1 << 30))
        kw = dict(route_length_m=float(rng.uniform(0, 2000)), route_completed_m=float(rng.uniform(0, 2000)),
                  is_route_completed=completed, endless=endless, timeout=timeout,
                  episode_length=int(rng.integers(0, 500)), total_reward=float(rng.normal()))
        got = tscoring.episode_stats(_counters(np.random.default_rng(seed), tscoring.EpisodeCounters), **kw)
        want = jscoring.episode_stats(_counters(np.random.default_rng(seed), jscoring.EpisodeCounters), **kw)
        assert got == want


def _records(rng, n):
    statuses = ["Completed", "Failed", "Failed - Agent crashed", "Failed - Agent timed out"]
    return [
        {
            "route_id": f"r{i}", "index": i, "status": statuses[int(rng.integers(0, 4))],
            "scores": {"score_composed": float(rng.uniform(0, 100)), "score_penalty": float(rng.uniform(0, 1)),
                       "score_route": float(rng.uniform(0, 100))},
            "meta": {"route_length": float(rng.uniform(10, 3000))},
            "infractions": {k: ["event"] * int(rng.integers(0, 3)) for k in jls.GLOBAL_INFRACTION_KEYS},
        }
        for i in range(n)
    ]


@pytest.mark.parametrize("n", [3, 15, 20])
def test_aggregate_and_cal_std_match_jax(rng, n):
    data = {"_checkpoint": {"records": _records(rng, n)}}
    assert tstats.INFRACTION_KEYS == jstats.INFRACTION_KEYS
    assert tstats.aggregate(data) == jstats.aggregate(data)
    scores = list(rng.uniform(0, 100, 3 * n))
    assert tstats.cal_std(scores) == jstats.cal_std(scores)


def test_statistics_cli_matches_jax(tmp_path, rng, capsys):
    path = tmp_path / "ckpt.json"
    path.write_text(json.dumps({"_checkpoint": {"records": _records(rng, 15)}}))
    tstats.main(["--json-file", str(path)])
    got = capsys.readouterr().out
    jstats.main(["--json-file", str(path)])
    assert got == capsys.readouterr().out and "score_composed =" in got


@pytest.mark.parametrize("n,total,progress", [(0, 0, [0, 0]), (4, 4, [4, 4]), (3, 5, [3, 5]), (6, 6, None)])
def test_finalize_checkpoint_matches_jax(rng, n, total, progress):
    records = _records(rng, n)
    make = lambda: {"_checkpoint": {"records": json.loads(json.dumps(records)),
                                    **({"progress": list(progress)} if progress else {})}}
    assert tls.GLOBAL_LABELS == jls.GLOBAL_LABELS
    assert tls.finalize_checkpoint(make(), total) == jls.finalize_checkpoint(make(), total)


def test_routes_parsing_matches_jax(tmp_path, rng):
    xml = ['<routes>']
    for r in range(3):
        xml.append(f'<route id="{r}" town="Town0{r + 1}">')
        for x, y, z, yaw in rng.uniform(-200, 200, (5 + r, 4)):
            xml.append(f'<waypoint x="{x}" y="{y}" z="{z}" yaw="{yaw}"/>')
        xml.append("</route>")
    (tmp_path / "r.xml").write_text("\n".join(xml + ["</routes>"]))
    got, want = troutes.parse_routes_xml(str(tmp_path / "r.xml")), jroutes.parse_routes_xml(str(tmp_path / "r.xml"))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    scen = {"available_scenarios": [{"Town01": [{"scenario_type": "Scenario1", "n": 1}]},
                                    {"Town02": [{"scenario_type": "Scenario3", "n": 2}]}]}
    (tmp_path / "s.json").write_text(json.dumps(scen))
    for town in (None, "Town02"):
        assert (troutes.parse_scenarios_json(str(tmp_path / "s.json"), town)
                == jroutes.parse_scenarios_json(str(tmp_path / "s.json"), town))
    assert troutes.route_length_m(np.zeros((1, 3))) == jroutes.route_length_m(np.zeros((1, 3))) == 0.0


@pytest.mark.parametrize("weather_group", ["simple", "train_eval", "all", "HardRainNoon"])
def test_build_suite_tasks_match_jax(weather_group):
    got = tsuites.build_suite_tasks("Endless-v0", weather_group=weather_group, num_zombie_vehicles=3)
    want = jsuites.build_suite_tasks("Endless-v0", weather_group=weather_group, num_zombie_vehicles=3)
    assert got == want
    assert tcli.build_routes("Endless-v0", got) == jcli.build_routes("Endless-v0", want)
    assert sorted(tsuites.SUITES) == sorted(jsuites.SUITES)
    assert tsuites.WEATHER_GROUPS == jsuites.WEATHER_GROUPS
    with pytest.raises(KeyError, match="unknown env id"):
        tsuites.build_suite_tasks("Nope-v0")


def test_build_routes_with_ego_route_matches_jax():
    spec = [tsuites.TransformSpec(float(i), float(i * i)) for i in range(6)]
    tasks = [{"route_id": 4, "weather": "WetNoon", "ego_route": spec, "endless": False},
             {"route_id": 0, "weather": "ClearNoon", "ego_route": []}]
    assert tcli.build_routes("NoCrash-v0", tasks) == jcli.build_routes("NoCrash-v0", tasks)


# ---------------------------------------------------------------- evaluator


class _CruiseAgent:
    def compute_control(self, state):
        return np.array([0.5, 0.02, 0.0])


class _CrashingAgent:
    def compute_control(self, state):
        raise RuntimeError("boom")


def _blocked_env(scoring):
    class BlockedEnv:
        """Ends 'blocked' at step 3, 20% through a 100 m route."""

        counters = scoring.EpisodeCounters(vehicle_blocked=1)

        def reset(self):
            self._i = 0
            return {"cur_waypoint": np.zeros((1, 2))}

        def step(self, control_dict):
            self._i += 1
            done = self._i >= 3
            info = {"episode_stat": scoring.episode_stats(
                self.counters, route_length_m=100.0, route_completed_m=20.0, is_route_completed=False,
            )} if done else {}
            return {"cur_waypoint": np.asarray([[self._i * 5.0, 0.0]])}, 0.0, done, info

    return BlockedEnv()


@pytest.mark.parametrize("case", ["cruise", "short_route", "crash", "blocked", "watchdogs"])
def test_route_evaluator_matches_jax(tmp_path, case):
    routes = [{"id": "r0", "length_m": 50.0}, {"id": "r1"}, {"id": "r2", "endless": True}]

    def setup(evaluator, fake_env, scoring, agent):
        route = np.stack([np.arange(0.0, 8.0, 2.0), np.zeros(4)], axis=-1) if case == "short_route" else None
        env_factory = ((lambda r: _blocked_env(scoring)) if case == "blocked" else
                       (lambda r: fake_env(route=route, image_hw=(8, 8), bev_hw=(8, 8), seed=r.get("index", 0))))
        return evaluator(lambda: agent(), env_factory, routes, str(tmp_path / f"{evaluator.__module__}.json"),
                         max_steps_per_route=12,
                         counters_fn=(lambda e: e.counters) if case == "blocked" else None,
                         step_timeout=5.0 if case == "watchdogs" else None, env_kind="fake")

    agent = _CrashingAgent if case == "crash" else _CruiseAgent
    got = setup(RouteEvaluator, FakeDrivingEnv, tscoring, agent).run()
    want = setup(JEvaluator, JFakeEnv, jscoring, agent).run()
    for a, b in zip(got["_checkpoint"]["records"], want["_checkpoint"]["records"]):
        # the traceback names each package's own files
        assert ("boom" in a.pop("crash_message")) == ("boom" in b.pop("crash_message")) == (case == "crash")
    assert got == want


# ---------------------------------------------------------------------- CLI


@pytest.fixture
def jax_weights_in_port(monkeypatch):
    """The port's evaluation CLI plans with the weights and init noise of
    the planner the JAX CLI builds (seed 0), carried over."""
    from autonomous_driving_with_diffusion_model_tpu.driving.plan import DiffusionPlanner as JPlanner
    from test_torch_agents import _jcfg, carry_jax_planner

    class Carried(tplan.DiffusionPlanner):
        def __init__(self, cfg, *args, **kwargs):
            super().__init__(cfg, *args, **kwargs)
            carry_jax_planner(self, JPlanner(_jcfg(cfg)), cfg)

    monkeypatch.setattr(tplan, "DiffusionPlanner", Carried)


def test_evaluate_cli_fake_env_matches_jax(tmp_path, jax_weights_in_port):
    args = ["--env-id", "Endless-v0", "--weather-group", "train_eval", "--fake-env", "--max-steps", "15"]
    got = tcli.main(args + ["--device", "cpu", "--checkpoint-json", str(tmp_path / "t.json"), "--opts", *TINY])
    want = jcli.main(args + ["--checkpoint-json", str(tmp_path / "j.json"), "--opts", *TINY])
    records = got["_checkpoint"]["records"]
    assert len(records) == 2  # train_eval: two weathers, one Endless task each
    for a, b in zip(records, want["_checkpoint"]["records"]):
        assert a["status"] == b["status"] == "Completed"
        assert a["num_steps"] == b["num_steps"] == 15
        assert (a["route_id"], a["infractions"]) == (b["route_id"], b["infractions"])
        for k in a["scores"]:
            np.testing.assert_allclose(a["scores"][k], b["scores"][k], **SCORE_TOL, err_msg=k)
        np.testing.assert_allclose(a["meta"]["route_length"], b["meta"]["route_length"], **SCORE_TOL)
    assert json.loads((tmp_path / "t.json").read_text())["entry_status"] == want["entry_status"]


def test_evaluate_cli_resume_skips_finished_routes(tmp_path):
    """With --step-timeout the evaluator warms the agent up before it arms
    its watchdogs; a second run skips the finished routes."""
    ckpt = tmp_path / "ckpt.json"
    args = ["--env-id", "Endless-v0", "--weather-group", "train_eval", "--fake-env", "--device", "cpu",
            "--checkpoint-json", str(ckpt), "--max-steps", "4", "--step-timeout", "60", "--opts", *TINY]
    data = tcli.main(args)
    assert [r["status"] for r in data["_checkpoint"]["records"]] == ["Completed"] * 2
    before = json.loads(ckpt.read_text())
    after = tcli.main(args)  # resume: nothing is run again
    assert after["_checkpoint"]["records"] == before["_checkpoint"]["records"]
    assert after["_checkpoint"]["progress"] == [2, 2]


def test_evaluate_cli_console_main_returns_zero(tmp_path):
    assert tcli.console_main(["--fake-env", "--device", "cpu", "--checkpoint-json",
                              str(tmp_path / "c.json"), "--max-steps", "2", "--opts", *TINY]) == 0


@pytest.mark.parametrize("flag", ["--scenarios-json", "--host", "--port"])
def test_evaluate_cli_refuses_carla_only_flags(monkeypatch, tmp_path, flag):
    """The CARLA-only flags reach what reads them: --host and --port the
    ``CarlaDrivingEnv`` the CLI builds (``eval_mode``, the suite's tasks),
    --scenarios-json ``build_suite_tasks`` and through it every task; the
    run drives that env over ``tests/mock_carla.py``. (The port refused
    these flags while it had no CARLA env.)"""
    import sys

    import mock_carla

    from autonomous_driving_with_diffusion_model_tpu_torch.sim import carla_env

    monkeypatch.setitem(sys.modules, "carla", mock_carla)
    value = {"--scenarios-json": str(tmp_path / "s.json"), "--host": "carla-host", "--port": "2012"}[flag]
    (tmp_path / "s.json").write_text("{}")
    built, suites = [], []
    real_tasks = tsuites.build_suite_tasks
    monkeypatch.setattr(tsuites, "build_suite_tasks", lambda env_id, **kw: suites.append(kw) or real_tasks(env_id, **kw))

    class Recorded(carla_env.CarlaDrivingEnv):
        def __init__(self, **kwargs):
            built.append(kwargs)
            super().__init__(**kwargs)

    monkeypatch.setattr(carla_env, "CarlaDrivingEnv", Recorded)
    data = tcli.main(["--env-id", "Endless-v0", "--device", "cpu", "--checkpoint-json", str(tmp_path / "c.json"),
                      "--max-steps", "2", flag, value, "--opts", *TINY])
    (kwargs,) = built
    assert kwargs["eval_mode"] is True and kwargs["town"] == "Town01"
    assert [t["weather"] for t in kwargs["tasks"]] == [t["weather"] for t in real_tasks("Endless-v0")]
    assert kwargs["host"] == (value if flag == "--host" else "localhost")
    assert kwargs["port"] == (int(value) if flag == "--port" else 2000)
    assert suites[0]["scenarios_json"] == (value if flag == "--scenarios-json" else None)
    assert data["_checkpoint"]["records"][0]["meta"]["env_kind"] == "carla"
