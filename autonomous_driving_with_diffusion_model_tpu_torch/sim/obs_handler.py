"""Config-driven observation composition.

The port's own copy of the JAX package's ``sim/obs_handler.py``, which it may not import.

First-party equivalent of the reference's obs-manager handler (reference:
carla_gym/core/obs_manager/obs_manager_handler.py:1-52 — dynamic import of
``carla_gym.core.obs_manager.<module>`` per ``obs_configs`` entry): the same
YAML ``obs_configs`` blocks (configs/agent/obs_configs/*.yaml, each entry a
dict with a ``module`` key) compose observations from the framework's tested
pure functions over a ``CarlaDrivingEnv``.

    handler = ObsHandler({"speed": {"module": "actor_state.speed"}, ...})
    obs = handler.get_observation(env)   # {"speed": {...}, ...}

Camera/IMU modules read the env's existing frame-synced sensor data (the env
spawns its sensor suite once, rather than per obs manager); unsupported
modules raise at construction so config errors surface early.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from .obs import (
    control_obs,
    route_obs,
    object_finder_obs,
    speed_obs,
    stop_sign_obs,
    velocity_obs,
    waypoint_plan_obs,
)

__all__ = ["ObsHandler", "OBS_MODULES", "register_obs_module"]


def _ego_kinematics(env):
    tf = env.ego.get_transform()
    vel = env.ego.get_velocity()
    fwd = tf.get_forward_vector()
    return tf, vel, fwd


def _speed(env, cfg):
    tf, vel, fwd = _ego_kinematics(env)
    return speed_obs((vel.x, vel.y, vel.z), (fwd.x, fwd.y, fwd.z), tf.rotation.yaw)


def _control(env, cfg):
    c = env.ego.get_control()
    # km/h -> m/s with the reference's 0.8 factor (control.py:32)
    limit = float(getattr(env.ego, "get_speed_limit", lambda: 0.0)()) / 3.6 * 0.8
    return control_obs(c.throttle, c.steer, c.brake, c.gear, speed_limit=limit)


def _velocity(env, cfg):
    tf, vel, _ = _ego_kinematics(env)
    acc = env.ego.get_acceleration()
    ang = env.ego.get_angular_velocity()
    return velocity_obs((vel.x, vel.y, vel.z), (acc.x, acc.y, acc.z), ang.z, tf.rotation.yaw)


def _object_finder(kind):
    def fn(env, cfg):
        tf, _, _ = _ego_kinematics(env)
        loc = tf.location
        return object_finder_obs(
            (loc.x, loc.y, loc.z),
            tf.rotation.yaw,
            env._surrounding(kind),
            max_detection_number=int(cfg.get("max_detection_number", 10)),
            distance_threshold=float(cfg.get("distance_threshold", 15.0)),
        )

    return fn


def _traffic_light(env, cfg):
    return {"at_red_light": [int(env._at_red_light())]}


def _stop_sign(env, cfg):
    loc = env.ego.get_location()
    target_id = env.run_stop_sign.target_stop_id
    trigger = None
    if target_id is not None:
        sign = env.stop_registry.get(target_id)
        if sign is not None:
            trigger = env.stop_registry.trigger_center(sign)
    return stop_sign_obs(
        (loc.x, loc.y), trigger, env.run_stop_sign.stop_completed,
        distance_threshold=float(cfg.get("distance_threshold", 4.0)),
    )


def _waypoint_plan(env, cfg):
    tf, _, _ = _ego_kinematics(env)
    if env.tracker is not None and env.tracker.route:
        plan = env.tracker.route
        return waypoint_plan_obs(
            (tf.location.x, tf.location.y), tf.rotation.yaw, plan,
            steps=int(cfg.get("steps", 10)),
        )
    # xy-route fallback (no planner): synthesize wp-likes from the route list
    from types import SimpleNamespace

    plan = [
        (
            SimpleNamespace(
                transform=SimpleNamespace(location=SimpleNamespace(x=p[0], y=p[1])),
                road_id=0, lane_id=0, is_junction=False,
            ),
            cmd,
        )
        for p, cmd in env.route[env._route_idx:]
    ] or [(SimpleNamespace(
        transform=SimpleNamespace(location=SimpleNamespace(x=tf.location.x, y=tf.location.y)),
        road_id=0, lane_id=0, is_junction=False), 4)]
    return waypoint_plan_obs(
        (tf.location.x, tf.location.y), tf.rotation.yaw, plan,
        steps=int(cfg.get("steps", 10)),
    )


def _route(env, cfg):
    tf, _, _ = _ego_kinematics(env)
    if env.tracker is not None and env.tracker.route:
        plan = env.tracker.route
        remaining = env.tracker.route_length - env.tracker.route_completed
    else:
        from types import SimpleNamespace

        pts = env.route[env._route_idx:] or [((tf.location.x, tf.location.y), 4)]
        plan = [
            (SimpleNamespace(
                transform=SimpleNamespace(
                    location=SimpleNamespace(x=p[0], y=p[1]),
                    rotation=SimpleNamespace(yaw=0.0),
                ),
                road_id=0, lane_id=0, is_junction=False), cmd)
            for p, cmd in pts
        ]
        remaining = env._route_length_m() - env.completed_m
    return route_obs(
        (tf.location.x, tf.location.y), tf.rotation.yaw, plan,
        max(0.0, remaining), route_steps=int(cfg.get("route_steps", 5)),
    )


def _camera(env, cfg):
    # the env consumes each tick's frame-synced sensor data exactly once
    # (reset/step -> _observe); read the cached frame rather than re-draining
    # the queues (reference spawns one sensor per obs manager instead)
    obs = env.last_obs
    return {
        "data": np.asarray(obs["camera"][0]),
        "bev_data": np.asarray(obs["bev"]),
        "compass": obs["compass"],
    }


def _birdview(env, cfg):
    if env._birdview is None:
        raise RuntimeError(
            "birdview.chauffeurnet needs CarlaDrivingEnv(birdview_h5=...)"
        )
    return env._birdview_obs()


OBS_MODULES: Dict[str, Callable] = {
    "actor_state.speed": _speed,
    "actor_state.control": _control,
    "actor_state.velocity": _velocity,
    "actor_state.route": _route,
    "object_finder.vehicle": _object_finder("vehicle"),
    "object_finder.pedestrian": _object_finder("walker"),
    "object_finder.traffic_light_new": _traffic_light,
    "object_finder.stop_sign": _stop_sign,
    "navigation.waypoint_plan": _waypoint_plan,
    "camera.rgb": _camera,
    "birdview.chauffeurnet": _birdview,
}


def register_obs_module(name: str):
    """Extension point for custom obs managers (the handler analogue of the
    reference's dynamic import)."""

    def deco(fn):
        OBS_MODULES[name] = fn
        return fn

    return deco


class ObsHandler:
    def __init__(self, obs_configs: Dict[str, Dict]):
        self._entries = []
        for obs_id, cfg in obs_configs.items():
            module = cfg.get("module")
            if module not in OBS_MODULES:
                raise KeyError(
                    f"unknown obs module {module!r} for {obs_id!r}; "
                    f"available: {sorted(OBS_MODULES)}"
                )
            self._entries.append((obs_id, module, dict(cfg)))

    def get_observation(self, env) -> Dict[str, Dict]:
        return {
            obs_id: OBS_MODULES[module](env, cfg)
            for obs_id, module, cfg in self._entries
        }
