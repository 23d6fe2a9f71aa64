"""The port's ``sim/`` modules one by one on the CPU against the JAX
package's: the same calls, with inputs drawn from a numpy seed (or the
mock town of ``tests/mock_carla.py``), through both packages' code, and the
outputs equal exactly (``test_torch_sim_env.assert_same``: arrays bit for
bit, floats by their hex form). Each case is a function of (the package's
name, a numpy generator) that returns everything it observed."""

import importlib
import os

import numpy as np
import pytest

from test_torch_sim_env import JAX, PORT, assert_same, mock, sim  # noqa: F401  (mock: a fixture)


def both(fn, seed=0, **kwargs):
    """(port's result, JAX's result) of ``fn`` from the same seed."""
    return tuple(fn(pkg, np.random.default_rng(seed), **kwargs) for pkg in (PORT, JAX))


# ---------------------------------------------------------------- criteria


def _blocked(pkg, rng):
    c = sim(pkg, "criteria").Blocked()
    out = []
    for step, t in enumerate(np.arange(0.0, 130.0, 0.5)):
        speed = float(rng.uniform(0, 2)) if t < 5 else float(rng.uniform(0, 0.09))
        out.append(c.tick(speed, float(t), step, ev_loc=tuple(rng.uniform(-5, 5, 3))))
    return out


def _route_deviation(pkg, rng):
    c = sim(pkg, "criteria").RouteDeviation()
    out = []
    for step in range(80):
        ev = tuple(rng.uniform(-40, 40, 3))
        out.append(c.tick(ev, tuple(rng.uniform(-5, 5, 2)), float(rng.uniform(0, 2)), 100.0,
                          float(step), step))
    return out


def _collision(pkg, rng):
    c = sim(pkg, "criteria").CollisionTracker()
    kinds = ["vehicle.audi.tt", "walker.pedestrian.0001", "static.prop.wall", "traffic.sign"]
    out = []
    for step in range(120):
        t = 0.1 * step
        loc = tuple(rng.uniform(-20, 20, 3))
        if rng.random() < 0.4:
            c.on_collision(loc, int(rng.integers(1, 5)), kinds[int(rng.integers(0, 4))],
                           tuple(rng.uniform(-800, 800, 3)), frame=step, timestamp=t)
        out.append(c.tick(loc, t))
    return out + [c.classify(k) for k in kinds]


def _encounter_light(pkg, rng):
    c = sim(pkg, "criteria").EncounterLight()
    return [c.tick(int(rng.integers(0, 4)) if rng.random() < 0.7 else None, tuple(rng.uniform(-9, 9, 2)),
                   0.1 * i, i) for i in range(60)]


def _run_red_light(pkg, rng):
    crit = sim(pkg, "criteria")
    c = crit.RunRedLight()
    out = []
    for i in range(80):
        stop = crit.StopLine(wp_forward=tuple(rng.uniform(-1, 1, 2)), road_id=int(rng.integers(1, 3)),
                             lane_id=int(rng.integers(-2, 3)), left=tuple(rng.uniform(0, 10, 2)),
                             right=tuple(rng.uniform(0, 10, 2)))
        light = crit.LightObservation(id=int(rng.integers(0, 6)), is_red=bool(rng.random() < 0.7),
                                      trigger_loc=tuple(rng.uniform(0, 10, 2)), stop_lines=[stop])
        a, b = rng.uniform(0, 10, 2), rng.uniform(0, 10, 2)
        out.append(c.tick(tuple(rng.uniform(0, 10, 3)), tuple(rng.uniform(-1, 1, 2)), tuple(a), tuple(b),
                          stop.road_id if rng.random() < 0.8 else 9, stop.lane_id, [light], 0.1 * i, i))
    return out


def _run_stop_sign(pkg, rng):
    c = sim(pkg, "criteria").RunStopSign()
    out = []
    for i in range(150):
        sid = int(rng.integers(0, 3)) if rng.random() < 0.8 else None
        out.append(c.tick(tuple(rng.uniform(0, 30, 2)), float(rng.uniform(0, 1)), sid,
                          bool(rng.random() < 0.5), bool(rng.random() < 0.7),
                          stop_loc=tuple(rng.uniform(0, 30, 2)), sim_time=0.1 * i, step=i))
        out.append((c.target_stop_id, c.stop_completed))
    return out


def _outside_lane(pkg, rng):
    c = sim(pkg, "criteria").OutsideRouteLaneTracker()
    out = []
    for i in range(100):
        out.append(c.tick(tuple(rng.uniform(0, 50, 2)), float(rng.uniform(-180, 180)),
                          float(rng.uniform(0, 4)), 3.5, int(rng.integers(1, 3)), int(rng.choice([-1, 1])),
                          float(rng.uniform(-180, 180)), bool(rng.random() < 0.2),
                          float(rng.uniform(0, 2)), 0.1 * i, i))
    return out


def _geometry(pkg, rng):
    crit = sim(pkg, "criteria")
    out = []
    for _ in range(200):
        s1, s2 = rng.integers(-3, 4, (2, 2, 2)).tolist()
        out.append(crit.segments_intersect(s1, s2))
        out.append(crit.point_inside_boundingbox(tuple(rng.uniform(-3, 3, 2)), tuple(rng.uniform(-1, 1, 2)),
                                                 tuple(rng.uniform(0.5, 2, 2))))
        out.append(crit.cast_angle(float(rng.uniform(-720, 720))))
    return out


CRITERIA = {"blocked": _blocked, "route_deviation": _route_deviation, "collision": _collision,
            "encounter_light": _encounter_light, "run_red_light": _run_red_light,
            "run_stop_sign": _run_stop_sign, "outside_lane": _outside_lane, "geometry": _geometry}


@pytest.mark.parametrize("case", sorted(CRITERIA))
def test_criteria_match_jax(case):
    got, want = both(CRITERIA[case])
    assert_same(got, want, case)
    if case != "geometry":
        assert any(v is not None for v in want if not isinstance(v, (tuple, int))), "no criterion fired"


# --------------------------------------------------------------------- obs


def _actor_states(mod, rng, n):
    return [mod.ActorState(actor_id=i + 1, location=tuple(rng.uniform(-20, 20, 3)),
                           rotation=tuple(rng.uniform(-180, 180, 3)), velocity=tuple(rng.uniform(-5, 5, 3)),
                           extent=tuple(rng.uniform(0.3, 2.5, 3)), road_id=int(rng.integers(0, 3)),
                           lane_id=int(rng.integers(-2, 3)), on_sidewalk=bool(rng.random() < 0.3))
            for i in range(n)]


def _obs_functions(pkg, rng):
    obs = sim(pkg, "obs")
    out = []
    for _ in range(20):
        yaw = float(rng.uniform(-180, 180))
        speed = obs.speed_obs(tuple(rng.uniform(-8, 8, 3)), tuple(rng.uniform(-1, 1, 3)), yaw)
        control = obs.control_obs(*rng.uniform(0, 1, 3).tolist(), int(rng.integers(0, 6)), float(rng.uniform(0, 30)))
        velocity = obs.velocity_obs(tuple(rng.uniform(-8, 8, 3)), tuple(rng.uniform(-2, 2, 3)),
                                    float(rng.uniform(-1, 1)), yaw)
        finder = obs.object_finder_obs(tuple(rng.uniform(-5, 5, 3)), yaw, _actor_states(obs, rng, 8),
                                       distance_threshold=15.0, max_detection_number=5, frame=3)
        raw = {"speed": speed, "control": control, "velocity": velocity,
               "camera": {"data": rng.integers(0, 256, (4, 6, 3), np.uint8),
                          "bev_data": rng.integers(0, 256, (4, 4, 3), np.uint8), "compass": [[0.1]]},
               "traffic_light": {"at_red_light": [int(rng.integers(0, 2))]},
               "cur_waypoint": rng.uniform(-9, 9, (1, 2)), "target_waypoint": rng.uniform(-9, 9, 2),
               "next_waypoint": rng.uniform(-9, 9, 2), "next_command": 4}
        states = ["yaw", "speed_norm", "speed", "speed_limit", "control", "acc_xy", "vel_xy", "vel_ang_z"]
        keep = [s for s in states if rng.random() < 0.7] or ["yaw"]
        out += [speed, control, velocity, finder, obs.process_obs(raw, keep, train=bool(rng.random() < 0.5))]
        out.append(obs.stop_sign_obs(tuple(rng.uniform(0, 6, 2)), tuple(rng.uniform(0, 6, 2)),
                                     bool(rng.random() < 0.3)))
    return out


def _plan_obs(pkg, rng, mock):
    obs = sim(pkg, "obs")
    route = [(mock.Waypoint(float(x)), 4 if x % 7 else 1) for x in range(5, 130, 2)]
    out = []
    for _ in range(10):
        loc, yaw = tuple(rng.uniform(0, 60, 2)), float(rng.uniform(-30, 30))
        start = int(rng.integers(0, len(route) - 3))
        out.append(obs.waypoint_plan_obs(loc, yaw, route[start:], int(rng.integers(3, 12))))
        out.append(obs.route_obs(loc, yaw, route[start:], float(rng.uniform(0, 900))))
    return out


def _gnss_tracker(pkg, rng):
    obs = sim(pkg, "obs")
    gps = importlib.import_module(f"{pkg}.driving.gps")
    plan = [(gps.xyz2gps(float(x), 0.0, 0.0, lat_ref=0.0, lon_ref=0.0), 4 if x != 60 else 5)
            for x in range(0, 200, 20)]
    tracker = obs.GnssPlanTracker([((lat, lon, z), cmd) for (lat, lon, z), cmd in plan])
    out = []
    for x in np.arange(0.0, 180.0, 3.0):
        lat, lon, z = gps.xyz2gps(float(x), float(rng.uniform(-0.5, 0.5)), 0.0, lat_ref=0.0, lon_ref=0.0)
        imu = np.zeros(7)
        imu[-1] = np.pi / 2 + float(rng.uniform(-0.05, 0.05))
        out.append(tracker.tick((lat, lon, z), imu))
    return out


@pytest.mark.parametrize("case", ["functions", "plan", "gnss_tracker"])
def test_obs_match_jax(case, mock):
    if case == "functions":
        got, want = both(_obs_functions)
    elif case == "plan":
        got, want = both(_plan_obs, mock=mock)
    else:
        got, want = both(_gnss_tracker)
    assert_same(got, want, case)


# ------------------------------------------------------ reward and terminal


def _reward(pkg, rng):
    rew = sim(pkg, "reward")
    r = rew.ValeoActionReward()
    out = []
    for _ in range(60):
        n = 6
        finder = {"binary_mask": rng.integers(0, 2, n), "rotation": rng.uniform(-180, 180, (n, 3)),
                  "location": rng.uniform(-12, 12, (n, 3)), "on_sidewalk": rng.integers(0, 2, n)}
        hv, hw = rew.lbc_hazard_vehicle(finder), rew.lbc_hazard_walker(finder)
        desired = rew.desired_speed_from_hazards(
            hazard_vehicle_loc=hv, hazard_ped_loc=hw,
            red_light_loc=tuple(rng.uniform(0, 30, 2)) if rng.random() < 0.3 else None)
        out += [hv, hw, desired, rew.is_within_distance_ahead(tuple(rng.uniform(-10, 10, 2)), 9.5)]
        out.append(r.get(float(rng.uniform(0, 8)), tuple(rng.uniform(-3, 3, 2)), float(rng.uniform(-180, 180)),
                         float(rng.uniform(-1, 1)), tuple(rng.uniform(-3, 3, 2)), float(rng.uniform(-180, 180)),
                         desired, terminal_reward=float(rng.choice([0.0, -1.0]))))
    return out


def _maybe(rng, p=0.15):
    return {"step": int(rng.integers(0, 99)), "id": int(rng.integers(0, 9))} if rng.random() < p else None


def _terminal(pkg, rng, variant):
    term = sim(pkg, "terminal")
    out = []
    if variant in ("valeo", "valeo_eval"):
        t = term.ValeoTerminal(eval_mode=variant == "valeo_eval")
        for i in range(60):
            out.append(t.get(float(i * 25.0), tuple(rng.uniform(-5, 5, 2)), float(rng.uniform(0, 6)),
                             tuple(rng.uniform(-5, 5, 2)), float(rng.uniform(-180, 180)),
                             tuple(rng.uniform(-9, 9, 2)), _maybe(rng, 0.05), _maybe(rng, 0.05),
                             _maybe(rng, 0.05), _maybe(rng, 0.05), collision_px=bool(rng.random() < 0.05)))
    elif variant == "valeo_stuck":
        t = term.ValeoStuckTerminal(stuck_steps=5)
        for i in range(80):
            out.append(t.get(sim_time=float(i), ev_loc=tuple(rng.uniform(-2, 2, 2)),
                             ev_speed=float(rng.choice([0.0, 0.0, 3.0])), wp_loc=(0.0, 0.0), wp_yaw=0.0,
                             is_free_road=bool(rng.random() < 0.8), info_blocked=_maybe(rng, 0.03),
                             info_run_red_light=_maybe(rng, 0.03), info_collision=_maybe(rng, 0.03),
                             info_run_stop_sign=_maybe(rng, 0.03)))
    elif variant == "leaderboard":
        t = term.LeaderboardTerminal(max_time=100.0)
        for i in range(40):
            out.append(t.get(float(i * 3.0), bool(rng.random() < 0.1), _maybe(rng), _maybe(rng)))
    else:
        for no_collision in (True, False):
            t = term.LeaderboardDaggerTerminal(no_collision=no_collision)
            for i in range(40):
                stop = {"event": str(rng.choice(["encounter", "run"]))} if rng.random() < 0.2 else None
                out.append(t.get(float(i), _maybe(rng), _maybe(rng), _maybe(rng), _maybe(rng), stop))
    return out


def test_reward_matches_jax():
    got, want = both(_reward)
    assert_same(got, want, "reward")


@pytest.mark.parametrize("variant", ["valeo", "valeo_eval", "valeo_stuck", "leaderboard", "leaderboard_dagger"])
def test_terminal_variants_match_jax(variant):
    got, want = both(_terminal, variant=variant)
    assert_same(got, want, variant)
    assert any(row[0] for row in want), "no variant ever ended the episode"


# ------------------------------------------------- noiser, weather, expert


@pytest.mark.parametrize("noise_type", ["Spike", "Throttle", "None"])
def test_noiser_matches_jax(noise_type):
    def run(pkg, rng):
        noiser = sim(pkg, "noiser").ExpertNoiser(noise_type, frequency=60.0, intensity=10.0,
                                                  rng=np.random.default_rng(7))
        return [noiser.compute_noise(rng.uniform(0, 1, 3), float(rng.uniform(0, 8)), 0.1 * i)
                for i in range(300)]

    got, want = both(run)
    assert_same(got, want, noise_type)


@pytest.mark.parametrize("name", ["dynamic_1.0", "dynamic_2.0", "ClearNoon"])
def test_weather_matches_jax(name):
    def run(pkg, rng):
        w = sim(pkg, "weather")
        dyn = w.DynamicWeather.from_config_name(name, precipitation=float(rng.uniform(0, 50)),
                                                rng=np.random.default_rng(3))
        storm, sun = w.Storm(float(rng.uniform(0, 50))), w.Sun(10.0, 40.0, np.random.default_rng(4))
        out = []
        for _ in range(500):
            dt = float(rng.uniform(0.05, 0.2))
            storm.tick(dt)
            sun.tick(dt)
            out.append((dyn.tick(dt), vars(storm).copy(), vars(sun).copy()))
        return out + [w.clamp(float(rng.uniform(-50, 150)))]

    got, want = both(run)
    assert_same(got, want, name)


def test_expert_matches_jax():
    def run(pkg, rng):
        ex = sim(pkg, "expert")
        pid = ex.ExpertPID([0.5, 0.025, 0.1])
        out = [pid.step(float(e)) for e in rng.standard_normal(60)]
        for strict in (True, False):
            lp = ex.LocalPlanner(target_speed=6.0, strict_reference=strict)
            for _ in range(40):
                x0 = float(rng.uniform(0, 20))
                route = [((x0 + 2.0 * i, float(rng.uniform(-1, 1))), int(rng.choice([1, 2, 3, 4, 5])))
                         for i in range(25)]
                out.append(ex.expert_control(lp, route, (x0 + float(rng.uniform(-2, 2)), 0.0),
                                             float(rng.uniform(-20, 20)), float(rng.uniform(0, 7)),
                                             hazard=bool(rng.random() < 0.2)))
        return out + [list(ex.RoadOption)]

    got, want = both(run)
    assert_same(got, want, "expert")


# ------------------------------------------------------------ route planner


def _route(pkg, rng, mock, case):
    rp = sim(pkg, "route_planner")
    planner = rp.GlobalRoutePlanner(mock._Map(), resolution=1.0)
    if case == "trace":
        out = []
        for _ in range(6):
            a, b = sorted(rng.uniform(0, 140, 2))
            trace = planner.trace_route(mock.Location(x=float(a)), mock.Location(x=float(b)))
            out.append([((wp.transform.location.x, wp.transform.location.y, wp.road_id, wp.lane_id), opt)
                        for wp, opt in trace])
            out.append(planner.abstract_route_plan(mock.Location(x=float(a)), mock.Location(x=float(b))))
            gps = rp.location_route_to_gps(trace)
            out += [gps, rp.downsample_route(trace, 50), rp.downsample_route(trace, 1),
                    rp.location_to_gps(mock.Location(x=float(a), y=1.5, z=0.5))]
        return out
    tracker = rp.RouteTracker(planner, mock._Map())
    if case == "tracker":
        tracker.trace_to_targets(mock.Location(x=5.0), [mock.Location(x=60.0), mock.Location(x=120.0)])
        out = [tracker.route_length, tracker.plan_gps, [(loc.x, loc.y, opt) for loc, opt in tracker.plan_world]]
        for x in np.arange(6.0, 125.0, float(rng.uniform(1.5, 2.5))):
            out.append(tracker.truncate((float(x), float(rng.uniform(-0.3, 0.3)))))
            out.append(tracker.route_transform())
            out.append(tracker.is_completed(mock.Location(x=float(x)), mock.Location(x=120.0)))
        return out + [tracker.as_xy()]
    spawn = [(mock.Waypoint(t.location.x).road_id, t) for t in mock._Map().get_spawn_points()]
    tracker.extend_random(mock.Location(x=5.0), spawn, np.random.default_rng(0), min_length=70.0)
    return [tracker.route_length, tracker.as_xy(), tracker.plan_gps]


@pytest.mark.parametrize("case", ["trace", "tracker", "endless"])
def test_route_planner_matches_jax(mock, case):
    got, want = both(_route, mock=mock, case=case)
    assert_same(got, want, case)


# ---------------------------------------------------------- traffic lights


def test_traffic_lights_match_jax(mock):
    def run(pkg, rng):
        tl = sim(pkg, "traffic_lights")
        mock._Vehicle._next_id = 1
        world = mock.Client("localhost", 2000).get_world()
        world.actors += [mock.TrafficLight(x=57.0, state="Red"), mock.StopSign(x=40.0)]
        lights = tl.TrafficLightRegistry(world, world.get_map())
        stops = tl.StopSignRegistry(world, world.get_map())
        out = [len(lights)]
        for x in np.arange(0.0, 120.0, 2.5):
            tf = mock.Transform(mock.Location(x=float(x), y=float(rng.uniform(-1, 1))),
                                mock.Rotation(yaw=float(rng.uniform(-10, 10))))
            xy = (tf.location.x, tf.location.y)
            out += [lights.light_observations(xy), lights.get_light_state(tf), lights.at_red_light(tf),
                    [lights.get_stopline_vtx(xy, c) for c in (0, 1, 2)], stops.scan(tf),
                    tl.lane_observation(world.get_map(), tf.location)]
            for sign in world.get_actors().filter("*stop*"):
                out += [stops.trigger_center(sign), stops.inside_trigger(tf.location, sign),
                        stops.is_affected(tf.location, sign)]
        for _ in range(20):
            r = rng.uniform(-180, 180, 3)
            tf = mock.Transform(mock.Location(*rng.uniform(-9, 9, 3).tolist()),
                                mock.Rotation(pitch=float(r[1]), yaw=float(r[2]), roll=float(r[0])))
            out += [tl.rotation_matrix(*r.tolist()), tl.transform_point(tf, rng.uniform(-3, 3, 3))]
        return out

    got, want = both(run)
    assert_same(got, want, "traffic_lights")


# ------------------------------------------------------- scenario injection


def _straight(mock, n=120):
    return [(mock.Transform(mock.Location(x=float(i), y=0.0), mock.Rotation(yaw=0.0)), 4) for i in range(n)]


def _annotations(triggers):
    by_name = {}
    for name, x, y, yaw, *other in triggers:
        event = {"transform": {"x": str(x), "y": str(y), "z": "0.0", "yaw": str(yaw)}}
        if other:
            event["other_actors"] = other[0]
        by_name.setdefault(name, []).append(event)
    return {"Town01": [{"scenario_type": n, "available_event_configurations": e} for n, e in by_name.items()]}


def _write_leaderboard_suite(root):
    """A LeaderBoard description tree of one Town01 route along the mock
    road, in the published layout (actors.json + routes.xml)."""
    folder = os.path.join(root, "LeaderBoard", "Town01")
    os.makedirs(folder)
    with open(os.path.join(folder, "actors.json"), "w") as f:
        f.write('{"ego_vehicles": {"hero": {"model": "vehicle.lincoln.mkz2017"}}}')
    with open(os.path.join(folder, "routes.xml"), "w") as f:
        f.write('<routes><route id="0"><ego_vehicle id="hero">'
                '<waypoint x="5.0" y="0.0" z="0.0" yaw="0"/><waypoint x="100.0" y="0.0" z="0.0" yaw="0"/>'
                '</ego_vehicle></route></routes>')


@pytest.mark.parametrize("case", ["scan_and_sample", "build_injection", "control_loss", "suite_tasks"])
def test_scenario_injection_matches_jax(mock, tmp_path, case):
    triggers = [("Scenario1", 30.0, 0.0, 0.0), ("Scenario3", 30.0, 0.0, 0.0),
                ("Scenario1", 60.0, 0.0, 0.0, {"front": [{"x": "30.0", "y": "0.0", "z": "0.0", "yaw": "0"}]}),
                ("Scenario4", 75.0, 0.0, 0.0), ("Scenario2", 90.0, 0.0, 0.0), ("Scenario7", 100.0, 0.0, 0.0)]
    if case == "suite_tasks":
        import json

        _write_leaderboard_suite(str(tmp_path))
        path = tmp_path / "scenarios.json"
        path.write_text(json.dumps({"available_scenarios": [_annotations(triggers)]}))

    def run(pkg, rng):
        si = sim(pkg, "scenario_injection")
        if case == "scan_and_sample":
            potential = si.scan_route_for_scenarios("Town01", _straight(mock), _annotations(triggers))
            return [potential, si.sample_scenarios(potential, seed=0), si.sample_scenarios(potential, seed=5)]
        if case == "build_injection":
            names = ["Scenario1", "Scenario2", "Scenario3", "Scenario4", "Scenario5", "Scenario6",
                     "Scenario7", "Scenario8", "Scenario9", "Scenario10"]
            defs = [{"name": n, "other_actors": None, "scenario_type": str(rng.choice(["valid", "S4left"])),
                     "trigger_position": {"x": float(rng.uniform(0, 100)), "y": float(rng.uniform(-2, 2)),
                                          "z": 0.0, "yaw": float(rng.uniform(-180, 180))}} for n in names]
            return [si.build_injection(defs, seed=s, walker_speed=ws) for s, ws in ((0, None), (3, 1.8))]
        if case == "control_loss":
            ev = si.ControlLossEvent((50.0, 0.0), radius=5.0, duration=2.0, seed=3)
            return [ev.steer_offset((float(x), 0.0), 5.0, 0.1 * i) for i, x in enumerate(np.arange(30, 60, 0.3))]
        tasks = sim(pkg, "suites").build_suite_tasks("LeaderBoard-v0", description_root=str(tmp_path),
                                                      scenarios_json=str(path), weather_group="simple")
        annotations = si.load_annotations(tasks[0]["scenarios_json"])
        route = [(mock.Transform(mock.Location(x=float(x)), mock.Rotation()), 4)
                 for x in np.arange(tasks[0]["ego_route"][0].x, tasks[0]["ego_route"][-1].x, 1.0)]
        potential = si.scan_route_for_scenarios(tasks[0]["town"], route, annotations)
        return [tasks, annotations, potential, si.build_injection(si.sample_scenarios(potential))]

    got, want = both(run)
    assert_same(got, want, case)


# ---------------------------------------------------------- scenario actors


def test_scenario_actor_handler_matches_jax(mock):
    """The handler's vehicles (constant speed and basic agent) and crossing
    walker ticked on a bare mock world."""
    def run(pkg, rng):
        mock._Vehicle._next_id = 1
        spec = sim(pkg, "suites").TransformSpec
        world = mock.Client("localhost", 2000).get_world()
        world.get_settings().fixed_delta_seconds = 0.1
        carla_map = world.get_map()
        planner = sim(pkg, "route_planner").GlobalRoutePlanner(carla_map, resolution=1.0)
        handler = sim(pkg, "scenario_actors").ScenarioActorHandler(world, carla_map, route_planner=planner,
                                                                   rng=np.random.default_rng(2))
        walkers = sim(pkg, "scenario_injection").build_injection([
            {"name": "Scenario3", "other_actors": None, "scenario_type": "valid",
             "trigger_position": {"x": 40.0, "y": 0.0, "z": 0.0, "yaw": 0.0}}], walker_speed=1.5)
        handler.reset(
            {"slow": [spec(x=20.0, y=0.0), spec(x=80.0, y=0.0)], "adv": [spec(x=5.0, y=0.0), spec(x=90.0, y=0.0)]},
            {"slow": {"model": "vehicle.*", "agent_entry_point": "constant_speed_agent:ConstantSpeedAgent",
                      "agent_kwargs": {"target_speed": 2.0}},
             "adv": {"model": "vehicle.*", "agent_entry_point": "basic_agent:BasicAgent",
                     "agent_kwargs": {"target_speed": 5.0}}},
            walker_specs=walkers["walker_specs"])
        out = []
        for i in range(60):
            handler.tick(ego_location=mock.Location(x=10.0 + i))
            world.tick()
            out.append({k: (a.vehicle.get_location().x, a.vehicle.get_location().y, a.vehicle.speed)
                        for k, a in handler.actors.items()})
            out.append([(w.state, w.walker.get_location().x, w.walker.get_location().y)
                        for w in handler.walkers.values()])
        handler.clean()
        return out

    got, want = both(run)
    assert_same(got, want, "scenario_actors")
    assert want[-2]["adv"][0] > 10.0


# --------------------------------------------------- birdview and map raster


def _strips(mod, rng):
    n = 100
    straight = mod.LaneStrip(centerline=np.stack([np.linspace(0, 200, n), rng.uniform(-0.2, 0.2, n)], -1),
                             width=np.full(n, 3.5), left_marking="broken", right_marking="solid")
    t = np.linspace(0, np.pi / 2, n)
    curve = mod.LaneStrip(centerline=np.stack([200 + 30 * np.sin(t), 30 - 30 * np.cos(t)], -1),
                          width=np.full(n, 3.5), left_marking="none")
    return [straight, curve]


@pytest.mark.parametrize("case", ["rasterize", "from_carla_map"])
def test_map_raster_matches_jax(mock, tmp_path, case):
    import h5py

    def run(pkg, rng):
        mr = sim(pkg, "map_raster")
        strips = _strips(mr, rng) if case == "rasterize" else mr.strips_from_carla_map(mock._Map())
        masks = mr.rasterize_map(strips, pixels_per_meter=float(rng.choice([4.0, 5.0])))
        path = str(tmp_path / f"{pkg}.h5")
        mr.save_h5(path, masks)
        with h5py.File(path) as f:
            saved = {k: f[k][()] for k in sorted(f.keys())}
            attrs = {k: f.attrs[k] for k in sorted(f.attrs.keys())}
        return [strips, masks, saved, attrs]

    got, want = both(run)
    assert_same(got, want, case)


def test_birdview_renderer_matches_jax():
    """Ten frames of a moving ego among vehicles, walkers, lights and stops
    over rasterized masks: frames, masks (with the history) and the
    collision flag; and ``tint``."""
    def run(pkg, rng):
        bv = sim(pkg, "birdview")
        masks = sim(pkg, "map_raster").rasterize_map(_strips(sim(pkg, "map_raster"), np.random.default_rng(1)))
        renderer = bv.BirdviewRenderer(masks["road"], masks["lane_marking_all"],
                                       masks["lane_marking_white_broken"], masks["world_offset_in_meters"],
                                       pixels_per_meter=masks["pixels_per_meter"], scale_mask_col=1.0)
        out = [bv.tint((255, 0, 0), 0.5), bv.tint((10, 20, 30), 0.2)]

        def actors(n, x):
            return [(tuple(x + rng.uniform(-15, 15, 2)), float(rng.uniform(-180, 180)),
                     tuple(rng.uniform(0.3, 2.4, 2))) for _ in range(n)]

        for i in range(10):
            x = 80.0 + 2.0 * i
            stop_line = [(tuple(rng.uniform(x, x + 20, 2)), tuple(rng.uniform(x, x + 20, 2)))]
            frame = renderer.tick(ev_loc_xy=(x, 0.0), ev_yaw_deg=float(rng.uniform(-5, 5)),
                                  ev_extent_xy=(2.4, 1.1), vehicles=actors(3, x), walkers=actors(2, x),
                                  tl_green=stop_line if i % 3 == 0 else (), tl_yellow=(),
                                  tl_red=stop_line if i % 3 else (), stops=actors(1, x),
                                  route_xy=np.stack([np.linspace(x, x + 40, 40), np.zeros(40)], -1))
            out.append(frame)
        return out

    got, want = both(run)
    assert_same(got, want, "birdview")
    assert want[-1]["masks"][0].sum() > 0


# -------------------------------------------------- server and env factories


def test_server_manager_matches_jax(monkeypatch, tmp_path):
    """The commands CarlaServerManager and kill_carla would run (no process
    starts: Popen and sleep are recorded), with and without a VERSION file."""
    import subprocess
    import time

    calls = []

    class Popen:
        def __init__(self, cmd, shell=False, preexec_fn=None):
            calls.append((cmd, shell, preexec_fn is not None))

        def wait(self):
            return 0

    monkeypatch.setattr(subprocess, "Popen", Popen)
    monkeypatch.setattr(time, "sleep", lambda s: calls.append(("sleep", s)))
    sh = tmp_path / "CarlaUE4.sh"
    sh.write_text("")

    def run(pkg, rng):
        su = sim(pkg, "server_utils")
        calls.clear()
        out = [su._version_at_least(v) for v in ("0.9.10", "0.9.12", "0.9.13-dirty", "1.0", "x")]
        for version in (None, "0.9.13"):
            if version:
                (tmp_path / "VERSION").write_text(version)
            for off_screen in (False, True):
                manager = su.CarlaServerManager(str(sh), port=2000 + int(rng.integers(0, 9)) * 10, t_sleep=1)
                manager.start(off_screen=off_screen)
                manager.stop()
                out.append((manager.larger_than_0_9_12, manager.env_config))
        (tmp_path / "VERSION").unlink()
        return out + [list(calls)]

    got, want = both(run)
    assert_same(got, want, "server_utils")


def test_env_factories_match_jax(mock, monkeypatch):
    """The registered factories, the fake and native envs they build and
    create_server's contract, in both packages."""
    def run(pkg, rng):
        mock._Vehicle._next_id = 1
        ca = sim(pkg, "create_agent")
        out = [sorted(ca.ENV_FACTORIES)]
        fake = ca.create_env({"factory": "fake"}, seed=5)
        out.append(fake.reset())
        native = ca.create_env({"factory": "carla_native", "target_speed": 5.0}, seed=2)
        obs = native.reset()
        out += [obs, native.step({0: None}), native.target_speed]
        native.close()
        with pytest.raises(KeyError, match="Unknown env factory"):
            ca.create_env({"factory": "nope"})
        monkeypatch.delenv("CARLA_SH_PATH", raising=False)
        with pytest.raises(ValueError, match="CARLA_SH_PATH"):
            ca.create_server({})
        started = []

        class Manager:
            def __init__(self, sh, port=2000):
                started.append((sh, port))

            def start(self, off_screen=False):
                started.append(off_screen)

        monkeypatch.setattr(ca, "CarlaServerManager", Manager)
        monkeypatch.setenv("CARLA_SH_PATH", "CarlaUE4.sh")
        ca.create_server({"port": 2010}, off_screen=True)
        return out + [started]

    got, want = both(run)
    assert_same(got, want, "create_agent")
    assert set(got[0]) >= {"fake", "carla_native", "carla_roach", "Endless-v0", "NoCrash-v0", "LeaderBoard-v0"}


def test_package_exports_match_jax():
    port, jax_sim = (importlib.import_module(f"{p}.sim") for p in (PORT, JAX))
    assert set(jax_sim.__all__) <= set(port.__all__)
    assert set(port.__all__) - set(jax_sim.__all__) == {"WEATHER_GROUPS"}
    for name in jax_sim.__all__:
        obj = getattr(port, name)
        assert getattr(obj, "__module__", PORT).startswith(PORT), name
