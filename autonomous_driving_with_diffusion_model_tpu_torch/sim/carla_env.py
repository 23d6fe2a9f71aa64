"""Native CARLA driving environment adapter.

The port's own copy of the JAX package's ``sim/carla_env.py``, which it may not import.

A slim, first-party replacement for the vendored carla-roach gym stack
(reference: carla_gym/carla_multi_agent_env.py + obs managers + handlers):
connects straight to the CARLA RPC client, runs synchronous 10 fps ticks
(carla_multi_agent_env.py:269-276), spawns the agent sensor suite
(diffusion_agent.py:126-177 geometry), and composes the framework's *tested*
pure-logic modules — ``sim.obs`` for observations, ``sim.criteria`` for
infractions, ``sim.expert`` for the autopilot, ``sim.reward``/``sim.terminal``
for RL signals, ``sim.weather`` for dynamic weather — into the standard
obs-dict env contract (see ``driving.fake_env`` for the schema).

Requires the ``carla`` client wheel; everything here is an adapter over the
simulator's actor/map objects — the decision logic lives in the unit-tested
modules above. The tests drive it over ``tests/mock_carla.py``, a ``carla``
client API over a one-road town; a deployment connects to a CARLA server.
"""

from __future__ import annotations

import logging
import queue
import weakref
from typing import Dict, Optional

import numpy as np

from ..driving.scoring import EpisodeCounters, episode_stats
from .criteria import (
    Blocked,
    CollisionTracker,
    EncounterLight,
    OutsideRouteLaneTracker,
    RouteDeviation,
    RunRedLight,
    RunStopSign,
)
from .expert import LocalPlanner, _loc_global_to_ref
from .obs import ActorState, control_obs, object_finder_obs, process_obs, speed_obs, velocity_obs
from .reward import ValeoActionReward, desired_speed_from_hazards, lbc_hazard_vehicle, lbc_hazard_walker
from .terminal import ValeoTerminal
from .traffic_lights import StopSignRegistry, TrafficLightRegistry, lane_observation
from .weather import DynamicWeather

log = logging.getLogger(__name__)

__all__ = ["CarlaDrivingEnv"]

SENSOR_SPECS = dict(
    camera=dict(x=-1.5, y=0.0, z=2.0, pitch=0.0, width=900, height=256, fov=100),
    bev=dict(x=0.0, y=0.0, z=50.0, pitch=-90.0, width=512, height=512, fov=50),
)


class _SensorQueue:
    """Frame-synced sensor buffer (reference: obs_manager/camera/rgb.py:135-156)."""

    def __init__(self, sensor):
        self.sensor = sensor
        self.queue: "queue.Queue" = queue.Queue()
        sensor.listen(self.queue.put)

    def get(self, frame: int, timeout: float = 10.0):
        while True:
            data = self.queue.get(timeout=timeout)
            if data.frame >= frame:
                return data

    def destroy(self):
        try:
            self.sensor.stop()
            self.sensor.destroy()
        except RuntimeError:  # already gone with the world
            pass


def _loc_tuple(loc) -> tuple:
    return (loc.x, loc.y, loc.z)


def _image_to_rgb(image) -> np.ndarray:
    arr = np.frombuffer(image.raw_data, dtype=np.uint8).reshape(
        (image.height, image.width, 4)
    )
    return arr[:, :, :3][:, :, ::-1].copy()  # BGRA -> RGB


class CarlaDrivingEnv:
    """Endless-route single-ego env with the RlCameraWrapper obs contract."""

    def __init__(
        self,
        host: str = "localhost",
        port: int = 2000,
        town: Optional[str] = None,
        target_speed: float = 10.0,
        fixed_delta: float = 0.1,
        weather: str = "ClearNoon",
        num_zombie_vehicles: int = 0,
        num_zombie_walkers: int = 0,
        seed: int = 0,
        eval_mode: bool = False,
        route_min_length: float = 1000.0,
        tasks: Optional[list] = None,
        birdview_h5: Optional[str] = None,
    ):
        """``tasks``: optional benchmark task dicts (sim.suites); the env
        cycles through them across resets like the reference's task rotation
        (carla_multi_agent_env.py task_idx). Without tasks it runs Endless.
        ``birdview_h5``: path to a town's global-mask .h5 (sim.map_raster CLI
        or the reference's maps/); enables the chauffeurnet birdview obs
        (reference: obs_manager/birdview/chauffeurnet.py)."""
        import carla

        self._carla = carla
        self.rng = np.random.default_rng(seed)
        self.target_speed = target_speed
        self.fixed_delta = fixed_delta
        self.weather_name = weather
        self.num_zombie_vehicles = num_zombie_vehicles
        self.num_zombie_walkers = num_zombie_walkers
        self.eval_mode = eval_mode
        self.route_min_length = route_min_length
        self.tasks = tasks
        self._task_idx = -1
        self._endless = True
        self._final_target = None
        self._control_loss_events = []

        # connect with retries (reference: carla_multi_agent_env.py:251-261)
        last_exc = None
        for attempt in range(3):
            try:
                self.client = carla.Client(host, port)
                self.client.set_timeout(30.0)
                if town is not None:
                    self.world = self.client.load_world(town)
                else:
                    self.world = self.client.get_world()
                break
            except RuntimeError as exc:
                last_exc = exc
                log.warning("carla connect attempt %d failed: %s", attempt + 1, exc)
        else:
            raise RuntimeError(f"Could not connect to CARLA at {host}:{port}") from last_exc
        self.map = self.world.get_map()

        settings = self.world.get_settings()
        settings.synchronous_mode = True
        settings.fixed_delta_seconds = fixed_delta
        self.world.apply_settings(settings)

        self._route_planner = self._make_route_planner()
        self._birdview = None
        if birdview_h5 is not None:
            from .birdview import BirdviewRenderer

            # scale_mask_col=1.0: the deployed collection config
            # (reference configs/agent/obs_configs/birdview.yaml) overrides
            # the chauffeurnet code default 1.1
            self._birdview = BirdviewRenderer.from_h5(
                birdview_h5, scale_mask_col=1.0
            )
        self._actors = []
        self._sensors: Dict[str, _SensorQueue] = {}
        self.ego = None
        self._dynamic_weather: Optional[DynamicWeather] = None

    # ------------------------------------------------------------- internals

    def _make_route_planner(self):
        """First-party topology-graph planner (sim.route_planner); maps whose
        API lacks ``get_topology`` degrade to straight-line routes."""
        if not hasattr(self.map, "get_topology"):
            log.warning("map has no get_topology; straight-line routes only")
            return None
        try:
            from .route_planner import GlobalRoutePlanner

            return GlobalRoutePlanner(self.map, resolution=1.0)
        except Exception as exc:  # malformed topology: degrade, don't die
            log.warning("route planner build failed (%s); straight-line routes", exc)
            return None

    def _get_spawn_transforms(self):
        """[(road_id, transform)] spawn candidates, walked out of junctions
        (reference ego_vehicle_handler.py:344-375, sans the Town03 weighting)."""
        out = []
        for trans in self.map.get_spawn_points():
            wp = self.map.get_waypoint(trans.location)
            if wp is None:
                continue
            guard = 0
            while wp.is_junction and guard < 100:
                prev = wp.previous(1.0)
                if not prev:
                    break
                wp = prev[0]
                guard += 1
            out.append((wp.road_id, trans))
        return out

    def _trace_route(self, start_loc, end_loc):
        """Straight-line fallback route (no topology available)."""
        n = 200
        pts = np.linspace([start_loc.x, start_loc.y], [end_loc.x, end_loc.y], n)
        return [((float(x), float(y)), 4) for x, y in pts]

    def _spawn_ego(self, spawn_transform=None, model: str = "vehicle.lincoln.mkz2017"):
        carla = self._carla
        bp = self.world.get_blueprint_library().find(model)
        bp.set_attribute("role_name", "hero")
        if spawn_transform is None:
            spawn_points = self.map.get_spawn_points()
            spawn_transform = spawn_points[int(self.rng.integers(len(spawn_points)))]
        self.ego = self.world.spawn_actor(bp, spawn_transform)
        self._actors.append(self.ego)

        def cam(spec_name):
            spec = SENSOR_SPECS[spec_name]
            cam_bp = self.world.get_blueprint_library().find("sensor.camera.rgb")
            cam_bp.set_attribute("image_size_x", str(spec["width"]))
            cam_bp.set_attribute("image_size_y", str(spec["height"]))
            cam_bp.set_attribute("fov", str(spec["fov"]))
            tf = carla.Transform(
                carla.Location(x=spec["x"], y=spec["y"], z=spec["z"]),
                carla.Rotation(pitch=spec["pitch"]),
            )
            sensor = self.world.spawn_actor(cam_bp, tf, attach_to=self.ego)
            self._actors.append(sensor)
            return _SensorQueue(sensor)

        self._sensors["camera"] = cam("camera")
        self._sensors["bev"] = cam("bev")

        imu_bp = self.world.get_blueprint_library().find("sensor.other.imu")
        imu = self.world.spawn_actor(imu_bp, carla.Transform(), attach_to=self.ego)
        self._actors.append(imu)
        self._sensors["imu"] = _SensorQueue(imu)

        col_bp = self.world.get_blueprint_library().find("sensor.other.collision")
        col = self.world.spawn_actor(col_bp, carla.Transform(), attach_to=self.ego)
        self._actors.append(col)
        weak = weakref.ref(self)
        col.listen(lambda event: _on_collision(weak, event))
        self._collision_sensor = col

    def _spawn_zombies(self, n: int):
        """Background traffic on TM autopilot, spawned away from the ego
        (reference: zombie_vehicle_handler.py:18-50)."""
        if n <= 0:
            return
        lib = self.world.get_blueprint_library()
        bps = list(lib.filter("vehicle.*")) if hasattr(lib, "filter") else [
            lib.find("vehicle.lincoln.mkz2017")
        ]
        ego_loc = self.ego.get_location()
        points = [
            sp
            for sp in self.map.get_spawn_points()
            if sp.location.distance(ego_loc) >= 10.0
        ]
        self.rng.shuffle(points)
        spawned = 0
        for sp in points:
            if spawned >= n:
                break
            bp = bps[int(self.rng.integers(len(bps)))]
            try:
                zombie = self.world.spawn_actor(bp, sp)
            except RuntimeError:  # spawn collision
                continue
            self._actors.append(zombie)
            try:
                zombie.set_autopilot(True)
            except (AttributeError, RuntimeError):
                pass  # no traffic manager available
            spawned += 1

    def _spawn_walkers(self, n: int):
        """Navmesh-spawned pedestrians on AI controllers, 1+U(0,1) m/s
        (reference: zombie_walker_handler.py:15-104)."""
        if n <= 0:
            return
        carla = self._carla
        lib = self.world.get_blueprint_library()
        if not hasattr(lib, "filter") or not hasattr(
            self.world, "get_random_location_from_navigation"
        ):
            log.warning("world lacks walker navmesh API; skipping walkers")
            return
        walker_bps = list(lib.filter("walker.pedestrian.*"))
        if not walker_bps:
            return
        try:
            ctrl_bp = lib.find("controller.ai.walker")
        except (RuntimeError, IndexError):
            ctrl_bp = None
        ego_loc = self.ego.get_location()
        spawned, trials = 0, 0
        while spawned < n and trials < 10 * n + 10:
            trials += 1
            loc = self.world.get_random_location_from_navigation()
            if loc is None or loc.distance(ego_loc) < 10.0:
                continue
            bp = walker_bps[int(self.rng.integers(len(walker_bps)))]
            if hasattr(bp, "has_attribute") and bp.has_attribute("is_invincible"):
                bp.set_attribute("is_invincible", "false")
            try:
                walker = self.world.spawn_actor(bp, carla.Transform(loc))
            except RuntimeError:
                continue
            self._actors.append(walker)
            if ctrl_bp is not None:
                try:
                    ctrl = self.world.spawn_actor(
                        ctrl_bp, carla.Transform(), attach_to=walker
                    )
                    self._actors.append(ctrl)
                    ctrl.start()
                    ctrl.go_to_location(
                        self.world.get_random_location_from_navigation()
                    )
                    ctrl.set_max_speed(1.0 + float(self.rng.random()))
                except (RuntimeError, AttributeError):
                    pass  # walker stays static without an AI controller
            spawned += 1

    def _new_route(self):
        if self.tracker is not None:
            # endless extension: chain random spawn targets until the
            # remaining route is long enough (task_vehicle.py:58-102)
            self.tracker.extend_random(
                self.ego.get_location(),
                self._spawn_transforms,
                self.rng,
                min_length=self.tracker.route_completed + self.route_min_length,
            )
            self.route = self.tracker.as_xy()
        else:
            spawn_points = self.map.get_spawn_points()
            dest = spawn_points[int(self.rng.integers(len(spawn_points)))].location
            self.route = self._trace_route(self.ego.get_location(), dest)
        self._route_idx = 0

    def _set_weather(self):
        carla = self._carla
        if "dynamic" in self.weather_name:
            self._dynamic_weather = DynamicWeather.from_config_name(
                self.weather_name, rng=self.rng
            )
        elif hasattr(carla.WeatherParameters, self.weather_name):
            self.world.set_weather(getattr(carla.WeatherParameters, self.weather_name))

    def _tick_weather(self):
        if self._dynamic_weather is None:
            return
        params = self._dynamic_weather.tick(self.fixed_delta)
        w = self.world.get_weather()
        for k, v in params.items():
            setattr(w, k, v)
        self.world.set_weather(w)

    # ------------------------------------------------------------ public api

    def reset(self) -> Dict:
        self.close_actors()
        ego_route = []
        if self.tasks:
            # rotate through the suite's tasks across episodes
            self._task_idx = (self._task_idx + 1) % len(self.tasks)
            task = self.tasks[self._task_idx]
            self.weather_name = task.get("weather", self.weather_name)
            self.num_zombie_vehicles = task.get(
                "num_zombie_vehicles", self.num_zombie_vehicles
            )
            self.num_zombie_walkers = task.get(
                "num_zombie_walkers", self.num_zombie_walkers
            )
            self.target_speed = task.get("target_speed", self.target_speed)
            self._endless = bool(task.get("endless", not task.get("ego_route")))
            ego_route = list(task.get("ego_route", ()))
            self._task = task
        else:
            self._task = None
        spawn_tf = ego_route[0].as_carla() if ego_route else None
        ego_model = (self._task or {}).get("ego_model", "vehicle.lincoln.mkz2017")
        self._spawn_ego(spawn_transform=spawn_tf, model=ego_model)
        self._spawn_zombies(self.num_zombie_vehicles)
        self._spawn_walkers(self.num_zombie_walkers)
        self._set_weather()
        self.world.tick()
        self.tracker = None
        self._final_target = None
        if self._route_planner is not None:
            from .route_planner import RouteTracker

            self.tracker = RouteTracker(self._route_planner, self.map)
            self._spawn_transforms = self._get_spawn_transforms()
        self._step_traveled = 0.0
        if self.tracker is not None and len(ego_route) > 1:
            # fixed benchmark route: trace through the task's target transforms
            carla = self._carla
            targets = [carla.Location(t.x, t.y, t.z) for t in ego_route[1:]]
            self.tracker.trace_to_targets(self.ego.get_location(), targets)
            self.route = self.tracker.as_xy()
            self._route_idx = 0
            self._final_target = targets[-1]
        else:
            self._new_route()
        if self.tracker is not None:
            # the reward/terminal lateral anchor starts at the spawn point,
            # z-lift included (task_vehicle.py:73)
            spawn_loc = self.ego.get_location()
            self.tracker.last_route_location = (
                spawn_loc.x, spawn_loc.y, spawn_loc.z,
            )
        self._last_truncate_frame = None

        self.expert = LocalPlanner(target_speed=self.target_speed)
        # registries built once per episode (reference: TrafficLightHandler.reset
        # in carla_multi_agent_env reset, RunStopSign.__init__ world scan)
        self.tl_registry = TrafficLightRegistry(self.world, self.map)
        self.stop_registry = StopSignRegistry(self.world, self.map)
        # the full 7-criterion suite (reference ego_vehicle_handler wiring)
        self.collision = CollisionTracker()
        self.blocked = Blocked()
        self.route_dev = RouteDeviation()
        self.encounter_light = EncounterLight()
        self.run_red_light = RunRedLight()
        self.run_stop_sign = RunStopSign()
        self.outside_lane = OutsideRouteLaneTracker()
        self.reward_fn = ValeoActionReward()
        self.terminal = ValeoTerminal(eval_mode=self.eval_mode)
        self.counters = EpisodeCounters()
        # scripted adversaries from the task (scenario_actor_handler.py:15-51)
        # + leaderboard scenario injection along the traced route
        # (scenario_injection.py; reference route_scenario.py:337-496)
        self.scenario_handler = None
        self._control_loss_events = []
        scenario_routes = dict((self._task or {}).get("scenario_actors") or {})
        scenario_configs = dict((self._task or {}).get("scenario_actor_configs") or {})
        walker_specs = []
        if self._task and self._task.get("scenarios_json") and self.tracker is not None:
            from .scenario_injection import (
                build_injection,
                load_annotations,
                sample_scenarios,
                scan_route_for_scenarios,
            )

            annotations = load_annotations(self._task["scenarios_json"])
            town = self._task.get("town", "")
            scan_route = [
                (wp.transform, int(getattr(cmd, "value", cmd)))
                for wp, cmd in self.tracker.route
            ]
            potential = scan_route_for_scenarios(town, scan_route, annotations)
            sampled = sample_scenarios(potential, seed=self._task.get("route_id", 0))
            injection = build_injection(
                sampled,
                seed=self._task.get("route_id", 0),
                walker_speed=self._task.get("walker_speed"),
                walker_trigger_dist=self._task.get("walker_trigger_dist"),
            )
            scenario_routes.update(injection["vehicle_routes"])
            scenario_configs.update(injection["vehicle_configs"])
            walker_specs = injection["walker_specs"]
            self._control_loss_events = injection["control_loss"]
        if scenario_routes or walker_specs:
            from .scenario_actors import ScenarioActorHandler

            self.scenario_handler = ScenarioActorHandler(
                self.world, self.map, self._route_planner, self.tl_registry,
                rng=self.rng,
            )
            self.scenario_handler.reset(
                scenario_routes, scenario_configs, walker_specs=walker_specs
            )
        self.sim_time = 0.0
        self.steps = 0
        self.episode_reward = 0.0
        self.completed_m = 0.0
        loc = self.ego.get_location()
        self._prev_loc_xy = np.array([loc.x, loc.y])
        self._last_control = np.zeros(3)
        return self._observe()

    def _route_length_m(self) -> float:
        if self.tracker is not None:
            return max(self.tracker.route_length, 1.0)
        pts = np.asarray([p for p, _ in self.route], np.float64)
        return float(np.sum(np.linalg.norm(np.diff(pts, axis=0), axis=1))) if len(pts) > 1 else 1.0

    def _route_progress(self):
        """Pop passed waypoints; return (cur_wp, next_wp, next_command)."""
        pos = self.ego.get_location()
        pos_xy = np.array([pos.x, pos.y])
        if self.tracker is not None:
            # cumulative-distance truncation (task_vehicle.py:149-185), ONCE
            # per world tick like the reference's task_vehicle.tick — both
            # _observe and step call _route_progress within one frame, and a
            # second same-position truncate could pop one extra waypoint on
            # self-overlapping geometry; traveled accumulates until step()
            # consumes it for the criteria
            frame = self.world.get_snapshot().frame
            if frame != self._last_truncate_frame:
                self._last_truncate_frame = frame
                self._step_traveled += self.tracker.truncate(pos_xy)
            remaining = self.tracker.route_length - self.tracker.route_completed
            if remaining < 100.0 and self._endless:  # extend before running dry
                self._new_route()
            else:
                self.route = self.tracker.as_xy()
                self._route_idx = 0
        else:
            while (
                self._route_idx + 2 < len(self.route)
                and np.linalg.norm(np.asarray(self.route[self._route_idx][0]) - pos_xy) < 5.0
            ):
                self._route_idx += 1
            if self._route_idx + 10 > len(self.route):  # endless: extend the route
                self._new_route()
        cur = self.route[self._route_idx]
        nxt = self.route[min(self._route_idx + 1, len(self.route) - 1)]
        return cur, nxt

    def _surrounding(self, kind: str):
        # full type prefixes so "walker" never matches controller.ai.walker
        pattern = {"vehicle": "vehicle.*", "walker": "walker.pedestrian.*"}.get(
            kind, f"*{kind}*"
        )
        actors = []
        for actor in self.world.get_actors().filter(pattern):
            if self.ego is not None and actor.id == self.ego.id:
                continue
            loc = actor.get_location()
            rot = actor.get_transform().rotation
            vel = actor.get_velocity()
            actors.append(
                ActorState(
                    actor_id=actor.id,
                    location=(loc.x, loc.y, loc.z),
                    rotation=(rot.roll, rot.pitch, rot.yaw),
                    velocity=(vel.x, vel.y, vel.z),
                )
            )
        return actors

    def _at_red_light(self) -> bool:
        """Red OR yellow affecting light via the first-party registry
        (reference traffic_light_new.py:29-43 semantics)."""
        return self.tl_registry.at_red_light(self.ego.get_transform())

    def _observe(self) -> Dict:
        frame = self.world.get_snapshot().frame
        camera = _image_to_rgb(self._sensors["camera"].get(frame))
        bev = _image_to_rgb(self._sensors["bev"].get(frame))
        imu = self._sensors["imu"].get(frame)
        compass = float(imu.compass)

        tf = self.ego.get_transform()
        vel = self.ego.get_velocity()
        control = self.ego.get_control()
        fwd = tf.get_forward_vector()
        acc = self.ego.get_acceleration()
        ang = self.ego.get_angular_velocity()

        cur, nxt = self._route_progress()
        raw = {
            "speed": speed_obs((vel.x, vel.y, vel.z), (fwd.x, fwd.y, fwd.z), tf.rotation.yaw),
            "control": control_obs(
                control.throttle, control.steer, control.brake, control.gear,
                speed_limit=float(getattr(self.ego, "get_speed_limit", lambda: 0.0)())
                / 3.6 * 0.8,  # km/h -> m/s * 0.8 (reference control.py:32)
            ),
            "velocity": velocity_obs(
                (vel.x, vel.y, vel.z), (acc.x, acc.y, acc.z), ang.z, tf.rotation.yaw
            ),
            "camera": {"data": camera, "bev_data": bev, "compass": [[compass]]},
            "traffic_light": {"at_red_light": [int(self._at_red_light())]},
            "cur_waypoint": np.asarray([[tf.location.x, tf.location.y]]),
            "target_waypoint": np.asarray(nxt[0]),
            "next_waypoint": np.asarray([nxt[0]]),
            "next_command": nxt[1],
        }
        obs = process_obs(raw, ["yaw", "speed_norm", "control", "vel_xy"], train=False)
        if self._birdview is not None:
            obs["birdview"] = self._birdview_obs()
        self.last_obs = obs  # sensor queues are consumed once per tick;
        return obs           # obs-handler modules read this cached frame

    def _birdview_level_boxes(self, label):
        """[(center_xy, yaw_deg, extent_xy)] of the level bounding boxes the
        reference birdview records (chauffeurnet.py:127-152): world-space
        ``get_level_bbs`` (includes parked scenery actors, centers composed
        with the bbox offset), gated at record time by the per-axis canvas
        threshold, the 8 m height window, and the 1 m ego-proximity exclusion
        (level boxes carry no actor ids)."""
        ev = self.ego.get_transform().location
        thresh = self._birdview.distance_threshold
        out = []
        for bb in self.world.get_level_bbs(label):
            dx = abs(ev.x - bb.location.x)
            dy = abs(ev.y - bb.location.y)
            if not (dx < thresh and dy < thresh and abs(ev.z - bb.location.z) < 8.0):
                continue
            if dx < 1.0 and dy < 1.0:
                continue  # the ego's own level box
            out.append(
                (
                    (bb.location.x, bb.location.y),
                    bb.rotation.yaw,
                    (bb.extent.x, bb.extent.y),
                )
            )
        return out

    def _birdview_stops(self):
        """The targeted, not-yet-completed stop sign as a square oriented box
        for the birdview (reference chauffeurnet.py:107-118 _get_stops:
        trigger-volume offset composed through the sign's transform, extent
        squared to max(x, y))."""
        target_id = self.run_stop_sign.target_stop_id
        if target_id is None or self.run_stop_sign.stop_completed:
            return []
        sign = self.stop_registry.get(target_id)
        if sign is None:
            return []
        center, (ex, ey) = self.stop_registry._trigger_center_extent(sign)
        m = max(float(ex), float(ey))
        return [(tuple(center), sign.get_transform().rotation.yaw, (m, m))]

    def _birdview_obs(self):
        """Chauffeurnet masks around the ego (reference chauffeurnet.py
        get_observation: actors + per-color stop lines + the targeted stop
        sign + route polyline)."""
        tf = self.ego.get_transform()
        pos = (tf.location.x, tf.location.y)
        route_xy = np.asarray(
            [p for p, _ in self.route[self._route_idx: self._route_idx + 80]]
        )
        bb = self.ego.bounding_box.extent
        return self._birdview.tick(
            ev_loc_xy=pos,
            ev_yaw_deg=tf.rotation.yaw,
            ev_extent_xy=(bb.x, bb.y),
            vehicles=self._birdview_level_boxes(
                self._carla.CityObjectLabel.Vehicles
            ),
            walkers=self._birdview_level_boxes(
                self._carla.CityObjectLabel.Pedestrians
            ),
            tl_green=self.tl_registry.get_stopline_vtx(pos, 0),
            tl_yellow=self.tl_registry.get_stopline_vtx(pos, 1),
            tl_red=self.tl_registry.get_stopline_vtx(pos, 2),
            stops=self._birdview_stops(),
            route_xy=route_xy if len(route_xy) else None,
        )

    def _expert_control(self) -> np.ndarray:
        tf = self.ego.get_transform()
        vel = self.ego.get_velocity()
        speed = float(np.hypot(vel.x, vel.y))
        ego_loc = (tf.location.x, tf.location.y, tf.location.z)

        vehicles = object_finder_obs(ego_loc, tf.rotation.yaw, self._surrounding("vehicle"))
        walkers = object_finder_obs(ego_loc, tf.rotation.yaw, self._surrounding("walker"))
        hazard = (
            lbc_hazard_vehicle(vehicles) is not None
            or lbc_hazard_walker(walkers) is not None
            or self._at_red_light()
        )
        if hazard:
            return np.array([0.0, 0.0, 1.0])
        route_ahead = self.route[self._route_idx :]
        throttle, steer, brake = self.expert.run_step(
            route_ahead, (tf.location.x, tf.location.y), tf.rotation.yaw, speed
        )
        return np.array([throttle, steer, brake])

    def step(self, control_dict: Dict):
        carla = self._carla
        control = control_dict[0]
        if control is None:
            control = self._expert_control()
        control = np.asarray(control, np.float64)
        if self._control_loss_events:
            # injected Scenario1 (ControlLoss): steer-noise pulse at the trigger
            ego_tf = self.ego.get_transform()
            ego_vel = self.ego.get_velocity()
            ego_speed = float(np.hypot(ego_vel.x, ego_vel.y))
            offset = sum(
                ev.steer_offset(
                    (ego_tf.location.x, ego_tf.location.y), ego_speed, self.sim_time
                )
                for ev in self._control_loss_events
            )
            control = control.copy()
            control[1] += offset
        self.ego.apply_control(
            carla.VehicleControl(
                throttle=float(np.clip(control[0], 0, 1)),
                steer=float(np.clip(control[1], -1, 1)),
                brake=float(np.clip(control[2], 0, 1)),
            )
        )
        if self.scenario_handler is not None:
            # scripted adversaries act pre-tick
            self.scenario_handler.tick(self.ego.get_location())
        self.world.tick()
        self._tick_weather()
        self.sim_time += self.fixed_delta
        self.steps += 1

        obs = self._observe()

        # criteria + terminal over tested pure logic (full 7-criterion suite,
        # accumulation mirrors ego_vehicle_handler.py:186-324)
        carla = self._carla
        tf = self.ego.get_transform()
        vel = self.ego.get_velocity()
        speed = float(np.hypot(vel.x, vel.y))
        loc = tf.location
        ev_loc = (loc.x, loc.y, loc.z)
        pos_xy = np.array([loc.x, loc.y])
        if self.tracker is not None:
            # route-based distance traveled, as the reference feeds criteria
            # (task_vehicle.tick -> truncate; _observe truncated this tick)
            dist_step = self._step_traveled
            self._step_traveled = 0.0
        else:
            dist_step = float(np.linalg.norm(pos_xy - self._prev_loc_xy))
        self._prev_loc_xy = pos_xy
        self.completed_m += dist_step

        info_col = self.collision.tick(ev_loc, self.sim_time)
        if info_col is not None:
            kind = info_col["collision_type"]
            if kind == CollisionTracker.TYPE_VEHICLE:
                self.counters.collisions_vehicle += 1
            elif kind == CollisionTracker.TYPE_PEDESTRIAN:
                self.counters.collisions_pedestrian += 1
            elif kind == CollisionTracker.TYPE_STATIC:
                self.counters.collisions_layout += 1
            else:
                self.counters.collisions_others += 1
        info_blocked = self.blocked.tick(speed, self.sim_time, self.steps, ev_loc)
        if info_blocked is not None:
            self.counters.vehicle_blocked += 1

        cur, nxt = self._route_progress()
        # deviation anchors on the route head (task_vehicle.py:215-218); on
        # the tracker path cur[0] IS the head (_route_progress resets the
        # cursor to the freshly-truncated route every tick)
        wp_xy = np.asarray(cur[0])
        info_dev = self.route_dev.tick(
            ev_loc, wp_xy, dist_step, self._route_length_m(), self.sim_time, self.steps
        )
        if info_dev is not None:
            self.counters.route_dev += 1

        # traffic lights: encounter + red-light run via the registry
        light_state, light_loc_ev, light_id = self.tl_registry.get_light_state(
            tf, dist_threshold=7.5
        )
        info_light = self.encounter_light.tick(
            light_id, light_loc_ev, self.sim_time, self.steps
        )
        if info_light is not None:
            self.counters.encounter_light += 1

        fwd = tf.get_forward_vector()
        ev_extent = self.ego.bounding_box.extent.x
        tail_close = (loc.x - 0.8 * ev_extent * fwd.x, loc.y - 0.8 * ev_extent * fwd.y)
        tail_far = (loc.x - (ev_extent + 1.0) * fwd.x, loc.y - (ev_extent + 1.0) * fwd.y)
        tail_wp = self.map.get_waypoint(carla.Location(tail_far[0], tail_far[1], loc.z))
        info_red = self.run_red_light.tick(
            ev_loc,
            (fwd.x, fwd.y),
            tail_close,
            tail_far,
            tail_wp.road_id,
            tail_wp.lane_id,
            self.tl_registry.light_observations(pos_xy),
            self.sim_time,
            self.steps,
        )
        if info_red is not None:
            self.counters.red_light += 1

        # stop signs: registry scan feeding the state machine
        target_id = self.run_stop_sign.target_stop_id
        if target_id is None:
            sign = self.stop_registry.scan(tf)
            info_stop = self.run_stop_sign.tick(
                ev_loc, speed,
                sign.id if sign is not None else None,
                inside_trigger=False, still_affected=True,
                stop_loc=None if sign is None else _loc_tuple(sign.get_location()),
                sim_time=self.sim_time, step=self.steps,
            )
        else:
            sign = self.stop_registry.get(target_id)
            info_stop = self.run_stop_sign.tick(
                ev_loc, speed, None,
                inside_trigger=self.stop_registry.inside_trigger(loc, sign),
                still_affected=self.stop_registry.is_affected(loc, sign),
                stop_loc=_loc_tuple(sign.get_location()),
                sim_time=self.sim_time, step=self.steps,
            )
        # reward hazard: the criterion's CURRENT (post-tick) uncompleted target
        # sign's trigger-volume center in the ego frame (valeo_action.py:75-88)
        stop_loc_ev = None
        target_id = self.run_stop_sign.target_stop_id
        if target_id is not None and not self.run_stop_sign.stop_completed:
            sign = self.stop_registry.get(target_id)
            if sign is not None:
                center = self.stop_registry.trigger_center(sign)
                stop_loc_ev = _loc_global_to_ref(
                    (center[0], center[1]), (loc.x, loc.y), tf.rotation.yaw
                )
        if info_stop is not None:
            if info_stop["event"] == "encounter":
                self.counters.encounter_stop += 1
            else:
                self.counters.stop_infraction += 1

        # outside/wrong lane distance accounting
        lane = lane_observation(self.map, loc)
        info_out = None
        if lane is not None:
            info_out = self.outside_lane.tick(
                ev_loc, tf.rotation.yaw, lane.distance, lane.lane_width,
                lane.road_id, lane.lane_id, lane.wp_yaw, lane.is_junction,
                dist_step, self.sim_time, self.steps,
            )
        if info_out is not None:
            if info_out["outside_lane"]:
                self.counters.outside_lane_m += dist_step
            if info_out["wrong_lane"]:
                self.counters.wrong_lane_m += dist_step

        if self.tracker is not None and self.tracker.route:
            # reward/terminal lateral anchor: the reference's
            # get_route_transform — last passed route location, heading
            # toward the head (task_vehicle.py:373-383)
            (rt_x, rt_y), wp_yaw = self.tracker.route_transform()
            wp_xy = np.asarray([rt_x, rt_y])
        else:
            # route waypoint heading from the polyline (route carries no yaw)
            wp_delta = np.asarray(nxt[0], np.float64) - wp_xy
            wp_yaw = (
                float(np.degrees(np.arctan2(wp_delta[1], wp_delta[0])))
                if np.linalg.norm(wp_delta) > 1e-6
                else tf.rotation.yaw
            )
        done, timeout, terminal_reward, _ = self.terminal.get(
            self.sim_time, ev_loc, speed, wp_xy, wp_yaw, np.asarray(nxt[0]),
            info_blocked, info_red, info_col, info_stop,
        )
        route_completed = False
        if self._final_target is not None and self.tracker is not None:
            route_completed = self.tracker.is_completed(loc, self._final_target)
            done = done or route_completed

        # hazard-derived desired speed (valeo_action.py:44-96)
        ego_loc3 = (loc.x, loc.y, loc.z)
        vehicles = object_finder_obs(ego_loc3, tf.rotation.yaw, self._surrounding("vehicle"))
        walkers = object_finder_obs(ego_loc3, tf.rotation.yaw, self._surrounding("walker"))
        rl_state, rl_loc, _ = self.tl_registry.get_light_state(
            tf, offset=-0.8 * ev_extent, dist_threshold=18.0
        )
        desired = desired_speed_from_hazards(
            hazard_vehicle_loc=lbc_hazard_vehicle(vehicles),
            hazard_ped_loc=lbc_hazard_walker(walkers),
            red_light_loc=rl_loc if rl_state in ("Red", "Yellow") else None,
            stop_sign_loc=stop_loc_ev,
        )
        reward, _ = self.reward_fn.get(
            speed, ev_loc, tf.rotation.yaw, float(control[1]), wp_xy, wp_yaw,
            desired, terminal_reward,
        )
        self.episode_reward += reward
        info = {
            "counters": self.counters,
            "timeout": timeout,
            "collision": info_col,
            "run_red_light": info_red,
            "encounter_light": info_light,
            "run_stop_sign": info_stop,
            "route_deviation": info_dev,
            "blocked": info_blocked,
            "outside_route_lane": info_out,
        }
        if done:
            info["episode_stat"] = episode_stats(
                self.counters,
                route_length_m=self._route_length_m(),
                route_completed_m=self.completed_m,
                is_route_completed=route_completed,  # endless routes never "complete"
                endless=self._endless,
                timeout=timeout,
                episode_length=self.steps,
                total_reward=self.episode_reward,
            )
        return obs, reward, done, info

    def close_actors(self):
        if getattr(self, "scenario_handler", None) is not None:
            self.scenario_handler.clean()
            self.scenario_handler = None
        for s in self._sensors.values():
            s.destroy()
        self._sensors.clear()
        if getattr(self, "_collision_sensor", None) is not None:
            try:
                self._collision_sensor.stop()
                self._collision_sensor.destroy()
            except RuntimeError:
                pass
            self._collision_sensor = None
        for a in self._actors:
            try:
                a.destroy()
            except RuntimeError:
                pass
        self._actors.clear()
        self.ego = None

    def close(self):
        self.close_actors()
        settings = self.world.get_settings()
        settings.synchronous_mode = False
        settings.fixed_delta_seconds = None
        self.world.apply_settings(settings)


def _on_collision(weak_env, event):
    env = weak_env()
    if env is None:
        return
    loc = event.actor.get_transform().location
    impulse = event.normal_impulse
    env.collision.on_collision(
        (loc.x, loc.y, loc.z),
        event.other_actor.id,
        event.other_actor.type_id,
        (impulse.x, impulse.y, impulse.z),
        event.frame,
        event.timestamp,
    )
