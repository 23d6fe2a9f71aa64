"""Roach "valeo" RL reward + hazard predicates, simulator-independent.

The port's own copy of the JAX package's ``sim/reward.py``, which it may not import.

Pure-function re-designs of the reference reward stack (reference:
carla_gym/core/task_actor/ego_vehicle/reward/valeo_action.py:31-166 and
carla_gym/utils/hazard_actor.py:16-51): desired speed derived from
vehicle/pedestrian/red-light/stop-sign proximity, lateral-position and
heading penalties, and a steer-jerk action penalty. All inputs are plain
arrays in the ego frame.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .criteria import cast_angle

__all__ = [
    "is_within_distance_ahead",
    "lbc_hazard_vehicle",
    "lbc_hazard_walker",
    "desired_speed_from_hazards",
    "ValeoActionReward",
]

MAXIMUM_SPEED = 6.0


def is_within_distance_ahead(target_loc, max_distance: float, up_angle_th: float = 45.0) -> bool:
    """Ego-frame cone test (reference: carla_gym/utils/hazard_actor.py:5-13)."""
    target_loc = np.asarray(target_loc, np.float64)
    norm = np.linalg.norm(target_loc[:2])
    if norm < 0.001:
        return True
    if norm > max_distance:
        return False
    angle = np.degrees(np.arccos(np.clip(target_loc[0] / norm, -1.0, 1.0)))
    return angle < up_angle_th


def lbc_hazard_vehicle(obs: Dict, proximity_threshold: float = 9.5) -> Optional[np.ndarray]:
    """obs: {"binary_mask": (N,), "rotation": (N, 3) [r, p, yaw], "location": (N, 3)}
    in the ego frame. Returns the first hazard location or None
    (reference: hazard_actor.py:16-32: |yaw| <= 150 and within 45-degree cone)."""
    for i, valid in enumerate(obs["binary_mask"]):
        if not valid:
            continue
        sv_yaw = obs["rotation"][i][2]
        if abs(sv_yaw) > 150:
            continue
        sv_loc = np.asarray(obs["location"][i])
        if is_within_distance_ahead(sv_loc, proximity_threshold, up_angle_th=45):
            return sv_loc
    return None


def lbc_hazard_walker(obs: Dict, proximity_threshold: float = 9.5) -> Optional[np.ndarray]:
    """Distance-modulated cone for walkers on the road
    (reference: hazard_actor.py:35-51)."""
    for i, valid in enumerate(obs["binary_mask"]):
        if not valid:
            continue
        if int(obs.get("on_sidewalk", np.zeros(len(obs["binary_mask"])))[i]) == 1:
            continue
        ped_loc = np.asarray(obs["location"][i])
        dist = np.linalg.norm(ped_loc)
        degree = 162 / (np.clip(dist, 1.5, 10.5) + 0.3)
        if is_within_distance_ahead(ped_loc, proximity_threshold, up_angle_th=degree):
            return ped_loc
    return None


def _proximity_speed(loc_xy, standoff: float, maximum_speed: float) -> float:
    dist = max(0.0, float(np.linalg.norm(np.asarray(loc_xy)[:2])) - standoff)
    return maximum_speed * float(np.clip(dist, 0.0, 5.0)) / 5.0


def desired_speed_from_hazards(
    hazard_vehicle_loc=None,
    hazard_ped_loc=None,
    red_light_loc=None,
    stop_sign_loc=None,
    maximum_speed: float = MAXIMUM_SPEED,
) -> float:
    """Reference valeo_action.py:56-97: per-hazard standoffs 8/6/5/5 m, linear
    ramp over 5 m, min over all sources."""
    spd = [maximum_speed]
    if hazard_vehicle_loc is not None:
        spd.append(_proximity_speed(hazard_vehicle_loc, 8.0, maximum_speed))
    if hazard_ped_loc is not None:
        spd.append(_proximity_speed(hazard_ped_loc, 6.0, maximum_speed))
    if red_light_loc is not None:
        spd.append(_proximity_speed(red_light_loc, 5.0, maximum_speed))
    if stop_sign_loc is not None:
        spd.append(_proximity_speed(stop_sign_loc, 5.0, maximum_speed))
    return min(spd)


class ValeoActionReward:
    """Stateful reward (keeps last steer for the jerk penalty)."""

    def __init__(self, maximum_speed: float = MAXIMUM_SPEED):
        self._maximum_speed = maximum_speed
        self._last_steer = 0.0

    def get(
        self,
        ev_speed: float,
        ev_loc,
        ev_yaw: float,
        steer: float,
        wp_loc,
        wp_yaw: float,
        desired_speed: float,
        terminal_reward: float = 0.0,
    ) -> Tuple[float, Dict]:
        """All yaws in degrees; locations world-frame xy."""
        # steer-jerk penalty (valeo_action.py:38-42)
        r_action = -0.1 if abs(steer - self._last_steer) > 0.01 else 0.0
        self._last_steer = steer

        # r_speed (valeo_action.py:99-105)
        r_speed = 1.0 - abs(ev_speed - desired_speed) / self._maximum_speed

        # r_position: lateral distance to the route waypoint (107-119)
        d_vec = np.asarray(ev_loc, np.float64)[:2] - np.asarray(wp_loc, np.float64)[:2]
        yaw_rad = np.deg2rad(wp_yaw)
        wp_unit_right = np.array([-np.sin(yaw_rad), np.cos(yaw_rad)])
        lateral_distance = abs(float(np.dot(wp_unit_right, d_vec)))
        r_position = -1.0 * (lateral_distance / 2.0)

        # r_rotation: heading difference in radians (121-128)
        r_rotation = -1.0 * abs(np.deg2rad(cast_angle(ev_yaw - wp_yaw)))

        reward = r_speed + r_position + r_rotation + terminal_reward + r_action
        debug = {
            "r_speed": r_speed,
            "r_position": r_position,
            "r_rotation": r_rotation,
            "r_action": r_action,
            "desired_speed": desired_speed,
        }
        return reward, debug
