"""The port's CARLA env layer on the CPU against the JAX package's: each
scenario runs once through each package's ``sim/carla_env.py:CarlaDrivingEnv``
over ``tests/mock_carla.py`` (a ``carla`` client API over a one-road town
with one junction at x in [62, 75]), from the same actor ids, and every
step's observation, reward, done and info, the counters and the
``episode_stat`` must be equal, exactly: the port's ``sim/`` is the JAX
package's numpy code, so nothing may differ by even one ulp.

The helpers here (``canon``, ``assert_same``, ``record_episode``) serve the
other ``test_torch_sim*`` files too."""

import dataclasses
import enum
import hashlib
import importlib
import json
import sys

import numpy as np
import pytest

JAX = "autonomous_driving_with_diffusion_model_tpu"
PORT = "autonomous_driving_with_diffusion_model_tpu_torch"
PKGS = (JAX, PORT)


@pytest.fixture
def mock(monkeypatch):
    import mock_carla

    monkeypatch.setitem(sys.modules, "carla", mock_carla)
    return mock_carla


def sim(pkg, name):
    return importlib.import_module(f"{pkg}.sim.{name}")


def canon(x, depth=0):
    """A comparable, hashable form of ``x``: arrays by dtype, shape and a
    digest of their bytes; floats by their hex form (so NaN == NaN and -0.0
    != 0.0); objects of the two packages' classes by class name and fields."""
    if depth > 12:
        raise RecursionError("canon: structure too deep")
    if isinstance(x, np.ndarray):
        data = np.ascontiguousarray(x)
        if data.dtype == object:
            return ("objarray", x.shape, tuple(canon(v, depth + 1) for v in x.ravel()))
        return ("ndarray", data.dtype.str, data.shape, hashlib.sha1(data.tobytes()).hexdigest())
    if x is None or isinstance(x, str):
        return x
    if isinstance(x, (bool, np.bool_)):
        return (type(x).__name__, bool(x))
    if isinstance(x, (int, np.integer)):
        return (type(x).__name__, int(x))
    if isinstance(x, (float, np.floating)):
        return (type(x).__name__, float(x).hex())
    if isinstance(x, np.random.Generator):
        return ("generator", canon(x.bit_generator.state, depth + 1))
    if isinstance(x, enum.Enum):
        return ("enum", type(x).__name__, x.name, canon(x.value, depth + 1))
    if isinstance(x, dict):
        return ("dict", tuple((canon(k, depth + 1), canon(v, depth + 1)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(canon(v, depth + 1) for v in x))
    if dataclasses.is_dataclass(x):
        return ("dataclass", type(x).__name__,
                tuple((f.name, canon(getattr(x, f.name), depth + 1)) for f in dataclasses.fields(x)))
    if hasattr(x, "x") and hasattr(x, "y") and hasattr(x, "z"):  # a carla vector / location
        return ("xyz", type(x).__name__, canon((x.x, x.y, x.z), depth + 1))
    if hasattr(x, "__dict__"):
        return ("object", type(x).__name__, canon(vars(x), depth + 1))
    raise TypeError(f"canon: {type(x)}")


def assert_same(got, want, where="value"):
    """``got`` (the port's) equals ``want`` (JAX's) exactly; a dict or a
    sequence is compared item by item so that a failure names its place."""
    if isinstance(want, dict) and isinstance(got, dict):
        assert list(got) == list(want), f"{where}: keys {list(got)} != {list(want)}"
        for k in want:
            assert_same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)) and isinstance(got, (list, tuple)):
        assert type(got) is type(want), f"{where}: {type(got)} != {type(want)}"
        assert len(got) == len(want), f"{where}: length {len(got)} != {len(want)}"
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"{where}[{i}]")
    elif isinstance(want, np.ndarray) and isinstance(got, np.ndarray):
        assert (got.dtype, got.shape) == (want.dtype, want.shape), f"{where}: {got.dtype}{got.shape} != {want.dtype}{want.shape}"
        assert np.array_equal(got, want, equal_nan=got.dtype.kind in "fc"), f"{where}: arrays differ"
    else:
        assert canon(got) == canon(want), f"{where}: {got!r} != {want!r}"


def record_episode(pkg, mock, monkeypatch, build, control, steps, on_step=None, keep=None):
    """Run one episode of ``pkg``'s env: ``build(pkg)`` makes and resets it
    (-> env, first obs), ``control(env, i)`` gives step i's action (None:
    the expert), ``on_step(env, i, out)`` runs after each step. Returns the
    canonical form of every step's output, the counters and the last info;
    ``keep(env)`` adds what else the scenario checks. Actor ids start at 1,
    so both packages' episodes see the same ids."""
    monkeypatch.setattr(mock._Vehicle, "_next_id", 1)
    env, obs = build(pkg)
    rows = [canon(obs)]
    out = (obs, None, False, {})
    for i in range(steps):
        out = env.step({0: control(env, i)})
        rows.append(canon(out))
        if on_step is not None:
            on_step(env, i, out)
        if out[2]:
            break
    extra = keep(env) if keep is not None else None
    result = dict(rows=rows, counters=canon(env.counters), n=len(rows), done=bool(out[2]),
                  info=out[3], extra=extra)
    env.close()
    return result


def assert_same_episode(got, want):
    assert got["n"] == want["n"], f"episode lengths {got['n']} != {want['n']}"
    for i, (a, b) in enumerate(zip(got["rows"], want["rows"])):
        if a != b:  # locate the first difference
            names = ("obs", "reward", "done", "info") if i else ("obs",)
            parts = zip(names, a[1] if i else (a,), b[1] if i else (b,))
            bad = [n for n, x, y in parts if x != y]
            raise AssertionError(f"step {i}: {bad} differ")
    assert got["counters"] == want["counters"]
    assert_same(got["extra"], want["extra"], "extra")


def both(mock, monkeypatch, *args, **kwargs):
    """(port's episode, JAX's episode) of one scenario."""
    want = record_episode(JAX, mock, monkeypatch, *args, **kwargs)
    got = record_episode(PORT, mock, monkeypatch, *args, **kwargs)
    return got, want


# ------------------------------------------------------------- scenarios


def integration_task(pkg):
    """tests/test_integration_episode.py's task: a fixed route through a red
    light at x = 57, 3 walkers and a scenario vehicle ahead on its own route."""
    spec = sim(pkg, "suites").TransformSpec
    return {
        "weather": "ClearNoon",
        "route_id": 0,
        "num_zombie_vehicles": 0,
        "num_zombie_walkers": 3,
        "ego_route": [spec(x=5.0, y=0.0), spec(x=100.0, y=0.0)],
        "endless": False,
        "target_speed": 6.0,
        "scenario_actors": {"adv": [spec(x=110.0, y=0.0), spec(x=140.0, y=0.0)]},
        "scenario_actor_configs": {
            "adv": {
                "model": "vehicle.*",
                "agent_entry_point": "basic_agent:BasicAgent",
                "agent_kwargs": {"target_speed": 4.0},
            }
        },
    }


def turn_green_when_held(light):
    """The integration test's rule: the light turns green once the expert
    has held before it (below 0.1 m/s between x = 40 and 62) past step 40."""
    def on_step(env, i, out):
        x = env.ego.get_location().x
        if light.state == "Red" and 40.0 < x < 62.0 and env.ego.speed < 0.1 and i > 40:
            light.state = "Green"
    return on_step


def scripted_route(env, start_x):
    """tests/test_traffic_lights.py's straight route through the junction."""
    env.ego.transform.location.x = start_x
    env.ego.transform.location.y = 0.0
    env.ego.transform.rotation.yaw = 0.0
    env.ego.speed = 0.0
    env.tracker = None
    env.route = [((float(x), 0.0), 4) for x in range(int(start_x), int(start_x) + 200)]
    env._route_idx = 0
    env._prev_loc_xy = np.array([start_x, 0.0])
    env.completed_m = 0.0


def test_expert_episode_matches_jax(mock, monkeypatch):
    """The expert episode of tests/test_integration_episode.py, step by step:
    it holds at the red light, goes on green and completes the route."""
    lights = {}

    def build(pkg):
        env = sim(pkg, "carla_env").CarlaDrivingEnv(seed=0, tasks=[integration_task(pkg)])
        lights[pkg] = mock.TrafficLight(x=57.0, state="Red")
        env.world.actors.append(lights[pkg])
        return env, env.reset()

    runs = {}
    for pkg in PKGS:
        runs[pkg] = record_episode(
            pkg, mock, monkeypatch, lambda p, pkg=pkg: build(pkg), lambda env, i: None, 600,
            on_step=lambda env, i, out, pkg=pkg: turn_green_when_held(lights[pkg])(env, i, out),
            keep=lambda env: dict(adv_x=env.scenario_handler.actors["adv"].vehicle.get_location().x))
    got, want = runs[PORT], runs[JAX]
    assert_same_episode(got, want)
    assert want["done"] and want["n"] > 100
    stat = got["info"]["episode_stat"]
    assert_same(stat, want["info"]["episode_stat"], "episode_stat")
    assert stat["is_route_completed"] == 1.0 and stat["score_composed"] == pytest.approx(1.0, abs=1e-6)
    assert got["extra"]["adv_x"] > 112.0


SCRIPTED = {
    # tests/test_traffic_lights.py's scenarios: (actors, control, steps)
    "red_light_run": (lambda m: [m.TrafficLight(x=57.0, state="Red")], lambda env, i: np.array([1.0, 0.0, 0.0]), 200),
    "green_light": (lambda m: [m.TrafficLight(x=57.0, state="Green")], lambda env, i: np.array([1.0, 0.0, 0.0]), 90),
    "stop_sign_run": (lambda m: [m.StopSign(x=40.0)], lambda env, i: np.array([1.0, 0.0, 0.0]), 90),
    "stop_sign_respected": (
        lambda m: [m.StopSign(x=40.0)],
        lambda env, i: (np.array([0.0, 0.0, 1.0])
                        if 38.0 <= env.ego.get_location().x <= 42.0 and env.ego.speed > 0.05
                        else np.array([0.6, 0.0, 0.0])),
        150),
    "expert_at_red_light": (lambda m: [m.TrafficLight(x=57.0, state="Red")], lambda env, i: None, 250),
}


@pytest.mark.parametrize("scenario", sorted(SCRIPTED))
def test_scripted_route_episodes_match_jax(mock, monkeypatch, scenario):
    """Red lights, stop signs and the expert on a scripted route: the
    traffic-light and stop-sign registries, the criteria, the reward and the
    terminal through both envs."""
    actors, control, steps = SCRIPTED[scenario]

    def build(pkg):
        env = sim(pkg, "carla_env").CarlaDrivingEnv(seed=0)
        for a in actors(mock):
            env.world.actors.append(a)
        first = env.reset()
        scripted_route(env, start_x=30.0)
        return env, first

    got, want = both(mock, monkeypatch, build, control, steps,
                     keep=lambda env: dict(x=env.ego.get_location().x, steps=env.steps))
    assert_same_episode(got, want)
    if scenario == "red_light_run":
        assert want["done"] and got["info"]["run_red_light"] is not None
        assert_same(got["info"]["episode_stat"], want["info"]["episode_stat"], "episode_stat")


def test_collision_episode_matches_jax(mock, monkeypatch):
    """An injected collision through the sensor callback ends both episodes
    with the same terminal reward and counters (tests/test_carla_env.py)."""
    def control(env, i):
        if i == 1:
            loc = env.ego.get_location()
            env.collision.on_collision((loc.x, loc.y, loc.z), 999, "vehicle.other.car", (100, 0, 0),
                                       env.steps, env.sim_time)
        return np.array([0.7 if i == 0 else 0.0, 0.0, 0.0])

    def build(pkg):
        env = sim(pkg, "carla_env").CarlaDrivingEnv(seed=0)
        return env, env.reset()

    got, want = both(mock, monkeypatch, build, control, 5)
    assert_same_episode(got, want)
    assert want["done"] and want["n"] == 3
    assert got["info"]["counters"].collisions_vehicle == 1


def test_endless_episode_with_zombies_matches_jax(mock, monkeypatch):
    """No tasks: an Endless route from the route planner, extended at random
    by the tracker, with zombie vehicles and walkers under their autopilots."""
    def build(pkg):
        env = sim(pkg, "carla_env").CarlaDrivingEnv(seed=3, num_zombie_vehicles=3, num_zombie_walkers=2)
        return env, env.reset()

    got, want = both(mock, monkeypatch, build, lambda env, i: None, 120,
                     keep=lambda env: dict(n_vehicles=len(env.world.get_actors().filter("*vehicle*")),
                                           route_m=env._route_length_m()))
    assert_same_episode(got, want)
    assert want["extra"]["n_vehicles"] >= 3


def test_eval_mode_task_rotation_matches_jax(mock, monkeypatch):
    """eval_mode with two suite tasks: the env rotates to the second on its
    second reset, as the evaluator's shared env does."""
    def build(pkg):
        spec = sim(pkg, "suites").TransformSpec
        tasks = [dict(integration_task(pkg), num_zombie_walkers=0, scenario_actors={},
                      scenario_actor_configs={}),
                 dict(integration_task(pkg), ego_route=[spec(x=20.0, y=0.0), spec(x=60.0, y=0.0)],
                      num_zombie_walkers=1, scenario_actors={}, scenario_actor_configs={})]
        env = sim(pkg, "carla_env").CarlaDrivingEnv(seed=1, eval_mode=True, tasks=tasks)
        env.reset()
        for _ in range(3):
            env.step({0: None})
        return env, env.reset()

    got, want = both(mock, monkeypatch, build, lambda env, i: None, 80,
                     keep=lambda env: dict(task=env._task_idx, route_m=env._route_length_m()))
    assert_same_episode(got, want)
    assert want["extra"]["task"] == 1


def _scenarios_json(tmp_path):
    path = tmp_path / "scenarios.json"
    path.write_text(json.dumps({"available_scenarios": [{"Town01": [
        {"scenario_type": "Scenario3", "available_event_configurations": [
            {"transform": {"x": "40.0", "y": "0.0", "z": "0.0", "yaw": "0"}}]},
        {"scenario_type": "Scenario1", "available_event_configurations": [
            {"transform": {"x": "90.0", "y": "0.0", "z": "0.0", "yaw": "0"}}]},
    ]}]}))
    return str(path)


def test_injected_scenarios_episode_matches_jax(mock, monkeypatch, tmp_path):
    """A LeaderBoard-style task whose scenarios JSON injects a crossing
    walker and a control-loss event (tests/test_scenario_injection.py): the
    same injection, the same pedestrian collision, the same stats."""
    scenarios = _scenarios_json(tmp_path)

    def build(pkg):
        spec = sim(pkg, "suites").TransformSpec
        task = {
            "weather": "ClearNoon", "route_id": 0, "town": "Town01", "scenarios_json": scenarios,
            "num_zombie_vehicles": 0, "num_zombie_walkers": 0,
            "ego_route": [spec(x=5.0, y=0.0), spec(x=100.0, y=0.0)], "endless": False,
            "target_speed": 6.0, "scenario_actors": {}, "scenario_actor_configs": {},
            "walker_speed": 1.8, "walker_trigger_dist": 18.0,
        }
        env = sim(pkg, "carla_env").CarlaDrivingEnv(seed=0, tasks=[task])
        return env, env.reset()

    got, want = both(mock, monkeypatch, build, lambda env, i: [1.0, 0.0, 0.0], 400,
                     keep=lambda env: dict(events=len(env._control_loss_events),
                                           walkers=[w.state for w in env.scenario_handler.walkers.values()]))
    assert_same_episode(got, want)
    assert want["extra"]["events"] == 1


def test_scenario_vehicle_yields_to_blocker_matches_jax(mock, monkeypatch):
    """A BasicAgent scenario vehicle behind a parked blocker
    (tests/test_scenario_actors.py) while the expert drives."""
    def build(pkg):
        spec = sim(pkg, "suites").TransformSpec
        task = {
            "weather": "ClearNoon", "route_id": 0, "num_zombie_vehicles": 0, "num_zombie_walkers": 0,
            "ego_route": [spec(x=5.0, y=0.0), spec(x=60.0, y=0.0)], "endless": False,
            "target_speed": 6.0,
            "scenario_actors": {"adv": [spec(x=90.0, y=0.0), spec(x=140.0, y=0.0)],
                                "lead": [spec(x=100.0, y=0.0), spec(x=101.0, y=0.0)]},
            "scenario_actor_configs": {
                "adv": {"model": "vehicle.*", "agent_entry_point": "basic_agent:BasicAgent",
                        "agent_kwargs": {"target_speed": 5.0}},
                "lead": {"model": "vehicle.*", "agent_entry_point": "constant_speed_agent:ConstantSpeedAgent",
                         "agent_kwargs": {"target_speed": 0.0}},
            },
        }
        env = sim(pkg, "carla_env").CarlaDrivingEnv(seed=0, tasks=[task])
        return env, env.reset()

    got, want = both(mock, monkeypatch, build, lambda env, i: None, 100,
                     keep=lambda env: {k: (a.vehicle.get_location().x, a.vehicle.get_location().y)
                                       for k, a in env.scenario_handler.actors.items()})
    assert_same_episode(got, want)
    assert set(want["extra"]) == {"adv", "lead"}


def test_birdview_obs_matches_jax(mock, monkeypatch, tmp_path):
    """With ``birdview_h5`` each package's env renders the chauffeurnet
    birdview from the town's masks (written by each package's map_raster
    CLI, which must write the same masks): the same frames, near the light."""
    import h5py

    for pkg in PKGS:
        sim(pkg, "map_raster").main(["--towns", "MockTown", "--save-dir", str(tmp_path / pkg)])
    with h5py.File(tmp_path / JAX / "MockTown.h5") as a, h5py.File(tmp_path / PORT / "MockTown.h5") as b:
        assert sorted(a.keys()) == sorted(b.keys())
        for k in a.keys():
            np.testing.assert_array_equal(b[k][()], a[k][()], err_msg=k)
        assert {k: canon(v) for k, v in a.attrs.items()} == {k: canon(v) for k, v in b.attrs.items()}

    def build(pkg):
        env = sim(pkg, "carla_env").CarlaDrivingEnv(seed=11, birdview_h5=str(tmp_path / pkg / "MockTown.h5"))
        env.world.actors.append(mock.TrafficLight(x=57.0, state="Red"))
        first = env.reset()
        env.ego.transform.location.x = 55.0
        env.tracker = None
        env.route = [((float(x), 0.0), 4) for x in range(55, 120)]
        env._route_idx = 0
        return env, first

    got, want = both(mock, monkeypatch, build, lambda env, i: np.array([0.3, 0.0, 0.0]), 6)
    assert_same_episode(got, want)


def test_obs_handler_on_the_env_matches_jax(mock, monkeypatch):
    """``ObsHandler`` composing the reference camera config's modules, the
    plan/finder modules and the route module on each package's env."""
    configs = {
        "camera": {"module": "camera.rgb"},
        "speed": {"module": "actor_state.speed"},
        "control": {"module": "actor_state.control"},
        "velocity": {"module": "actor_state.velocity"},
        "route": {"module": "actor_state.route"},
        "route_plan": {"module": "navigation.waypoint_plan", "steps": 20},
        "vehicles": {"module": "object_finder.vehicle", "distance_threshold": 30.0},
        "walkers": {"module": "object_finder.pedestrian", "max_detection_number": 5},
        "traffic_light": {"module": "object_finder.traffic_light_new"},
        "stop": {"module": "object_finder.stop_sign"},
    }
    out = {}
    for pkg in PKGS:
        monkeypatch.setattr(mock._Vehicle, "_next_id", 1)
        env = sim(pkg, "carla_env").CarlaDrivingEnv(seed=11, num_zombie_vehicles=2, num_zombie_walkers=2)
        env.world.actors.append(mock.TrafficLight(x=57.0, state="Red"))
        env.world.actors.append(mock.StopSign(x=40.0))
        env.reset()
        handler = sim(pkg, "obs_handler").ObsHandler(configs)
        rows = []
        for i in range(5):
            env.step({0: None})
            rows.append(handler.get_observation(env))
        out[pkg] = rows
        env.close()
    assert list(out[JAX][0]) == list(configs)
    assert_same(out[PORT], out[JAX], "obs")


def test_camera_frames_match_jax(mock, monkeypatch):
    """The mock's cameras send a uniform grey frame; here they send a BGRA
    pattern that changes with the frame number and the pixel, so the env's
    BGRA -> RGB conversion of the camera and the BEV is held to the JAX
    env's and to the pattern itself."""
    emit = mock._Sensor._emit

    def pattern(h, w, frame):
        yy, xx = np.mgrid[0:h, 0:w]
        return np.stack([(xx + frame) % 256, (yy * 3) % 256, (xx ^ yy) % 256, np.full_like(xx, 255)],
                        axis=-1).astype(np.uint8)

    def patterned(self, frame):
        if self.callback is None or self.bp.id != "sensor.camera.rgb":
            return emit(self, frame)
        h, w = int(self.bp.attrs.get("image_size_y", 64)), int(self.bp.attrs.get("image_size_x", 64))
        self.callback(mock.Image(frame=frame, height=h, width=w, raw_data=pattern(h, w, frame).tobytes()))

    monkeypatch.setattr(mock._Sensor, "_emit", patterned)

    def build(pkg):
        env = sim(pkg, "carla_env").CarlaDrivingEnv(seed=0, tasks=[integration_task(pkg)])
        return env, env.reset()

    frames = {}
    got, want = both(mock, monkeypatch, build, lambda env, i: None, 12,
                     keep=lambda env: frames.setdefault(env.__module__, (env.world.frame, env.last_obs)) and None)
    assert_same_episode(got, want)
    frame, obs = frames[f"{PORT}.sim.carla_env"]
    np.testing.assert_array_equal(obs["camera"][0], pattern(256, 900, frame)[..., 2::-1])
    np.testing.assert_array_equal(obs["bev"], pattern(512, 512, frame)[..., 2::-1])
