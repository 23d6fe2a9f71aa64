"""Scripted scenario actors (adversarial vehicles on fixed routes).

The port's own copy of the JAX package's ``sim/scenario_actors.py``, which it may not import.

First-party equivalent of the reference's scenario-actor stack (reference:
carla_gym/core/task_actor/scenario_actor/scenario_actor_handler.py:1-58 +
agents/basic_agent.py:1-112 + agents/constant_speed_agent.py:1-41): vehicles
spawned from a task's ``scenario_actors`` route/actor configs, each driven by
a scripted agent every tick — ``ConstantSpeedAgent`` follows its route at a
fixed speed and brakes at the destination; ``BasicAgent`` additionally yields
to vehicle/walker hazards (the same LBC cones as the reward stack) and red
lights.

Route following reuses the framework's tested pieces: ``sim.route_planner``
traces the actor's fixed route; ``sim.expert.LocalPlanner`` is the
window-PID controller; ``sim.reward`` provides the hazard cones.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence

import numpy as np

from .expert import LocalPlanner
from .obs import ActorState, object_finder_obs
from .reward import lbc_hazard_vehicle, lbc_hazard_walker

log = logging.getLogger(__name__)

__all__ = [
    "ScenarioVehicle",
    "ConstantSpeedAgent",
    "BasicAgent",
    "CrossingWalker",
    "ScenarioActorHandler",
]


class ScenarioVehicle:
    """A spawned scenario vehicle + its fixed traced route
    (the navigation half of the reference's TaskVehicle for scenario actors)."""

    def __init__(self, vehicle, route_xy, dest_xy):
        self.vehicle = vehicle
        self.route_xy = list(route_xy)  # [((x, y), command)]
        self.dest_xy = np.asarray(dest_xy, np.float64)

    def tick(self):
        """Pop passed waypoints (keep a short tail for the PID window)."""
        loc = self.vehicle.get_location()
        pos = np.array([loc.x, loc.y])
        while (
            len(self.route_xy) > 2
            and np.linalg.norm(np.asarray(self.route_xy[0][0]) - pos) < 5.0
        ):
            self.route_xy.pop(0)

    def apply_control(self, action):
        import carla

        throttle, steer, brake = (float(v) for v in action)
        self.vehicle.apply_control(
            carla.VehicleControl(
                throttle=max(0.0, min(1.0, throttle)),
                steer=max(-1.0, min(1.0, steer)),
                brake=max(0.0, min(1.0, brake)),
            )
        )

    def clean(self):
        try:
            self.vehicle.destroy()
        except RuntimeError:
            pass


class ConstantSpeedAgent:
    """Route follower at a fixed target speed; full brake within
    ``success_dist`` of the destination (constant_speed_agent.py:5-41).

    ``stop_after_m``: optional srunner-FollowLeadingVehicle-style phase —
    drive that many meters from spawn, then hold a full stop (the injected
    Scenario2 lead forces the ego to brake behind it)."""

    def __init__(self, scenario_vehicle: ScenarioVehicle, target_speed: float = 0.0,
                 success_dist: float = 5.0, stop_after_m: Optional[float] = None, **_):
        self.sv = scenario_vehicle
        self._success_dist = success_dist
        self._planner = LocalPlanner(target_speed=target_speed)
        self._stop_after_m = stop_after_m
        self._traveled = 0.0
        loc = scenario_vehicle.vehicle.get_location()
        self._last_xy = np.array([loc.x, loc.y])

    def _drive(self) -> np.ndarray:
        tf = self.sv.vehicle.get_transform()
        vel = self.sv.vehicle.get_velocity()
        fwd = tf.get_forward_vector()
        forward_speed = float(vel.x * fwd.x + vel.y * fwd.y + vel.z * fwd.z)
        throttle, steer, brake = self._planner.run_step(
            self.sv.route_xy, (tf.location.x, tf.location.y), tf.rotation.yaw,
            forward_speed,
        )
        return np.array([throttle, steer, brake], np.float64)

    def _at_destination(self) -> bool:
        loc = self.sv.vehicle.get_location()
        return (
            float(np.hypot(loc.x - self.sv.dest_xy[0], loc.y - self.sv.dest_xy[1]))
            < self._success_dist
        )

    def _stopped_phase(self) -> bool:
        if self._stop_after_m is None:
            return False
        loc = self.sv.vehicle.get_location()
        xy = np.array([loc.x, loc.y])
        self._traveled += float(np.linalg.norm(xy - self._last_xy))
        self._last_xy = xy
        return self._traveled >= self._stop_after_m

    def get_action(self) -> np.ndarray:
        if self._at_destination() or self._stopped_phase():
            return np.array([0.0, 0.0, 1.0])
        return self._drive()


class BasicAgent(ConstantSpeedAgent):
    """ConstantSpeed + hazard yielding (basic_agent.py:27-112): brakes for
    vehicles ahead (yaw diff <= 150, 45-degree cone), walkers on the road
    (distance-modulated cone), and an affecting red light."""

    def __init__(self, scenario_vehicle, world, tl_registry=None,
                 target_speed: float = 0.0, success_dist: float = 5.0,
                 proximity_threshold: float = 9.5, **_):
        super().__init__(scenario_vehicle, target_speed, success_dist)
        self._world = world
        self._tl_registry = tl_registry
        self._proximity = proximity_threshold

    def _surrounding(self, pattern: str) -> Sequence[ActorState]:
        me = self.sv.vehicle.id
        out = []
        for actor in self._world.get_actors().filter(pattern):
            if actor.id == me:
                continue
            loc = actor.get_location()
            rot = actor.get_transform().rotation
            vel = actor.get_velocity()
            out.append(
                ActorState(
                    actor_id=actor.id,
                    location=(loc.x, loc.y, loc.z),
                    rotation=(rot.roll, rot.pitch, rot.yaw),
                    velocity=(vel.x, vel.y, vel.z),
                )
            )
        return out

    def get_action(self) -> np.ndarray:
        tf = self.sv.vehicle.get_transform()
        loc3 = (tf.location.x, tf.location.y, tf.location.z)
        vehicles = object_finder_obs(loc3, tf.rotation.yaw, self._surrounding("vehicle.*"))
        walkers = object_finder_obs(
            loc3, tf.rotation.yaw, self._surrounding("walker.pedestrian.*")
        )
        hazard = (
            lbc_hazard_vehicle(vehicles, self._proximity) is not None
            or lbc_hazard_walker(walkers, self._proximity) is not None
            or (
                self._tl_registry is not None
                and self._tl_registry.at_red_light(tf)
            )
            or self._at_destination()
        )
        if hazard:
            return np.array([0.0, 0.0, 1.0])
        return self._drive()


class CrossingWalker:
    """A scenario walker that waits on the shoulder and crosses the road when
    the ego nears its trigger point (the native DynamicObjectCrossing /
    VehicleTurningRoute behavior — reference srunner
    dynamic_object_crossing.py via scenario_injection.build_injection).

    States: waiting -> crossing (fixed direction, fixed distance) -> done
    (stops in place; the episode's criteria do the rest)."""

    def __init__(self, walker, spec: Dict):
        self.walker = walker
        self.trigger_xy = np.asarray(spec["trigger_xy"], np.float64)
        self.trigger_dist = float(spec.get("trigger_dist", 18.0))
        d = np.asarray(spec["cross_dir"], np.float64)
        self.cross_dir = d / max(np.linalg.norm(d), 1e-9)
        self.speed = float(spec.get("speed", 1.8))
        self.cross_m = float(spec.get("cross_m", 9.0))
        loc = walker.get_location()
        self._start_xy = np.array([loc.x, loc.y])
        self.state = "waiting"

    def tick(self, ego_location) -> None:
        import carla

        if self.state == "done":
            return
        if self.state == "waiting":
            ego_xy = np.array([ego_location.x, ego_location.y])
            if np.linalg.norm(ego_xy - self.trigger_xy) > self.trigger_dist:
                return
            self.state = "crossing"
        loc = self.walker.get_location()
        walked = np.linalg.norm(np.array([loc.x, loc.y]) - self._start_xy)
        if walked >= self.cross_m:
            self.state = "done"
            speed = 0.0
        else:
            speed = self.speed
        self.walker.apply_control(
            carla.WalkerControl(
                direction=carla.Vector3D(
                    float(self.cross_dir[0]), float(self.cross_dir[1]), 0.0
                ),
                speed=speed,
            )
        )

    def clean(self):
        try:
            self.walker.destroy()
        except RuntimeError:
            pass


AGENT_ENTRY_POINTS = {
    "constant_speed_agent:ConstantSpeedAgent": ConstantSpeedAgent,
    "basic_agent:BasicAgent": BasicAgent,
}


class ScenarioActorHandler:
    """Spawn + drive a task's scenario actors (scenario_actor_handler.py:6-58)."""

    def __init__(self, world, carla_map, route_planner=None, tl_registry=None,
                 rng: Optional[np.random.Generator] = None):
        self._world = world
        self._map = carla_map
        self._route_planner = route_planner
        self._tl_registry = tl_registry
        self.rng = rng or np.random.default_rng(0)
        self.actors: Dict[str, ScenarioVehicle] = {}
        self.agents: Dict[str, object] = {}
        self.walkers: Dict[str, CrossingWalker] = {}

    def reset(self, scenario_routes: Dict, scenario_configs: Dict,
              walker_specs: Optional[Sequence[Dict]] = None):
        """scenario_routes: {id: [TransformSpec, ...]} (first = spawn);
        scenario_configs: {id: {"model", "agent_entry_point", "agent_kwargs"}};
        walker_specs: crossing-walker dicts from
        scenario_injection.build_injection."""
        import carla

        self.clean()
        for i, spec in enumerate(walker_specs or ()):
            lib = self._world.get_blueprint_library()
            bps = list(lib.filter("walker.pedestrian.*")) or [
                lib.find("walker.pedestrian.0001")
            ]
            bp = bps[int(self.rng.integers(len(bps)))]
            if hasattr(bp, "has_attribute") and bp.has_attribute("is_invincible"):
                bp.set_attribute("is_invincible", "false")
            x, y = spec["spawn_xy"]
            tf = carla.Transform(carla.Location(float(x), float(y), 0.5))
            try:
                walker = self._world.spawn_actor(bp, tf)
            except RuntimeError as exc:
                log.warning("crossing walker %d spawn failed: %s", i, exc)
                continue
            self.walkers[f"crossing_walker_{i}"] = CrossingWalker(walker, spec)
        for sa_id, config in scenario_configs.items():
            route = scenario_routes.get(sa_id, [])
            if not route:
                log.warning("scenario actor %s has no route; skipped", sa_id)
                continue
            lib = self._world.get_blueprint_library()
            bps = list(lib.filter(config.get("model", "vehicle.*"))) or [
                lib.find("vehicle.lincoln.mkz2017")
            ]
            bp = bps[int(self.rng.integers(len(bps)))]
            bp.set_attribute("role_name", sa_id)
            spawn = route[0].as_carla() if hasattr(route[0], "as_carla") else route[0]
            try:
                vehicle = self._world.spawn_actor(bp, spawn)
            except RuntimeError as exc:
                log.warning("scenario actor %s spawn failed: %s", sa_id, exc)
                continue

            # trace the actor's fixed route (straight-line without a planner)
            dest = route[-1]
            if self._route_planner is not None and len(route) > 1:
                route_xy = []
                cur = spawn.location
                for target in route[1:]:
                    loc = carla.Location(target.x, target.y, getattr(target, "z", 0.0))
                    try:
                        trace = self._route_planner.trace_route(cur, loc)
                    except ValueError:
                        continue
                    route_xy += [
                        ((wp.transform.location.x, wp.transform.location.y),
                         int(opt.value))
                        for wp, opt in trace
                    ]
                    cur = loc
            else:
                pts = np.linspace(
                    [spawn.location.x, spawn.location.y], [dest.x, dest.y], 100
                )
                route_xy = [((float(x), float(y)), 4) for x, y in pts]
            sv = ScenarioVehicle(vehicle, route_xy, (dest.x, dest.y))
            entry = config.get(
                "agent_entry_point", "constant_speed_agent:ConstantSpeedAgent"
            )
            agent_cls = AGENT_ENTRY_POINTS.get(entry)
            if agent_cls is None:
                log.warning("unknown scenario agent %s; using ConstantSpeed", entry)
                agent_cls = ConstantSpeedAgent
            kwargs = dict(config.get("agent_kwargs", {}))
            if agent_cls is BasicAgent:
                agent = agent_cls(sv, self._world, self._tl_registry, **kwargs)
            else:
                agent = agent_cls(sv, **kwargs)
            self.actors[sa_id] = sv
            self.agents[sa_id] = agent

    def tick(self, ego_location=None):
        for sa_id, sv in self.actors.items():
            sv.apply_control(self.agents[sa_id].get_action())
            sv.tick()
        if ego_location is not None:
            for walker in self.walkers.values():
                walker.tick(ego_location)

    def clean(self):
        for sv in self.actors.values():
            sv.clean()
        for walker in self.walkers.values():
            walker.clean()
        self.actors = {}
        self.agents = {}
        self.walkers = {}
