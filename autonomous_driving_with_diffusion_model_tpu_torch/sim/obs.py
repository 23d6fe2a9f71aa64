"""Observation computation, simulator-independent.

The port's own copy of the JAX package's ``sim/obs.py``, which it may not import.

Pure-function versions of the obs managers the pipeline consumes (reference:
carla_gym/core/obs_manager/actor_state/{speed,control,velocity}.py,
object_finder/{vehicle,pedestrian}.py) plus the RlCameraWrapper state-vector
assembly (env_agents/rl_camera/utils/rl_camera_wrapper.py:213-265). An env
adapter supplies raw actor states; these produce the exact dict layouts the
agents, collector, and hazard predicates expect.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ActorState",
    "speed_obs",
    "control_obs",
    "velocity_obs",
    "object_finder_obs",
    "process_obs",
    "waypoint_plan_obs",
    "GnssPlanTracker",
    "stop_sign_obs",
    "route_obs",
]


@dataclass
class ActorState:
    """World-frame state of a surrounding actor."""

    actor_id: int
    location: Tuple[float, float, float]
    rotation: Tuple[float, float, float]  # roll, pitch, yaw (deg)
    velocity: Tuple[float, float, float]
    extent: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    road_id: int = 0
    lane_id: int = 0
    on_sidewalk: bool = False


def speed_obs(velocity_xyz, forward_vec, yaw_deg: float) -> Dict[str, np.ndarray]:
    """reference: actor_state/speed.py:33-51."""
    v = np.asarray(velocity_xyz, np.float64)
    f = np.asarray(forward_vec, np.float64)
    return {
        "speed": np.array([np.linalg.norm(v)], np.float32),
        "speed_xy": np.array([np.linalg.norm(v[:2])], np.float32),
        "forward_speed": np.array([float(np.dot(v, f))], np.float32),
        "yaw": np.array([yaw_deg], np.float32),
    }


def control_obs(throttle, steer, brake, gear, speed_limit=0.0) -> Dict[str, np.ndarray]:
    """reference: actor_state/control.py."""
    return {
        "throttle": np.array([throttle], np.float32),
        "steer": np.array([steer], np.float32),
        "brake": np.array([brake], np.float32),
        "gear": np.array([gear], np.float32),
        "speed_limit": np.array([speed_limit], np.float32),
    }


def _rotate_to_ego(vec_xy, ego_yaw_deg: float) -> np.ndarray:
    yaw = np.deg2rad(ego_yaw_deg)
    c, s = np.cos(-yaw), np.sin(-yaw)
    v = np.asarray(vec_xy, np.float64)
    return np.array([c * v[0] - s * v[1], s * v[0] + c * v[1]])


def velocity_obs(vel_xyz, acc_xyz, ang_vel_z, ego_yaw_deg: float) -> Dict[str, np.ndarray]:
    """Ego-frame velocity/acceleration (reference: actor_state/velocity.py)."""
    return {
        "vel_xy": _rotate_to_ego(np.asarray(vel_xyz)[:2], ego_yaw_deg).astype(np.float32),
        "acc_xy": _rotate_to_ego(np.asarray(acc_xyz)[:2], ego_yaw_deg).astype(np.float32),
        "vel_ang_z": np.array([ang_vel_z], np.float32),
    }


def object_finder_obs(
    ego_location,
    ego_yaw_deg: float,
    actors: Sequence[ActorState],
    distance_threshold: float = 15.0,
    max_detection_number: int = 10,
    frame: int = 0,
) -> Dict[str, np.ndarray]:
    """Nearby-actor observation in the ego frame (reference:
    object_finder/vehicle.py:76-128): filter by distance, sort by distance,
    transform loc/rot/vel into the ego frame, pad with a binary mask. The
    layout feeds ``sim.reward.lbc_hazard_*`` directly."""
    ego_loc = np.asarray(ego_location, np.float64)

    def dist(a: ActorState) -> float:
        return float(np.linalg.norm(np.asarray(a.location) - ego_loc))

    nearby = sorted((a for a in actors if dist(a) <= distance_threshold), key=dist)
    nearby = nearby[:max_detection_number]

    location, rotation, velocity = [], [], []
    binary_mask, extent, road_id, lane_id, on_sidewalk = [], [], [], [], []
    for a in nearby:
        delta = np.asarray(a.location, np.float64) - ego_loc
        loc_ev = _rotate_to_ego(delta[:2], ego_yaw_deg)
        location.append([loc_ev[0], loc_ev[1], delta[2]])
        roll, pitch, yaw = a.rotation
        rotation.append([roll, pitch, ((yaw - ego_yaw_deg + 180.0) % 360.0) - 180.0])
        vel_ev = _rotate_to_ego(np.asarray(a.velocity)[:2], ego_yaw_deg)
        velocity.append([vel_ev[0], vel_ev[1], a.velocity[2]])
        binary_mask.append(1)
        extent.append(list(a.extent))
        road_id.append(a.road_id)
        lane_id.append(a.lane_id)
        on_sidewalk.append(int(a.on_sidewalk))
    for _ in range(max_detection_number - len(binary_mask)):
        binary_mask.append(0)
        location.append([0, 0, 0])
        rotation.append([0, 0, 0])
        velocity.append([0, 0, 0])
        extent.append([0, 0, 0])
        road_id.append(0)
        lane_id.append(0)
        on_sidewalk.append(0)

    return {
        "frame": frame,
        "binary_mask": np.array(binary_mask, np.int8),
        "location": np.array(location, np.float32),
        "rotation": np.array(rotation, np.float32),
        "extent": np.array(extent, np.float32),
        "absolute_velocity": np.array(velocity, np.float32),
        "road_id": np.array(road_id, np.int16),
        "lane_id": np.array(lane_id, np.int8),
        "on_sidewalk": np.array(on_sidewalk, np.int8),
    }


def process_obs(obs: Dict, input_states: Sequence[str], train: bool = True) -> Dict:
    """Canonical agent observation dict (reference:
    rl_camera_wrapper.py:213-265): the state vector is concatenated in the
    fixed key order yaw, speed_norm, speed, speed_limit, control(4), acc_xy,
    vel_xy, vel_ang_z — gated by ``input_states``."""
    state_list = []
    if "yaw" in input_states:
        state_list.append(obs["speed"]["yaw"])
    if "speed_norm" in input_states:
        state_list.append(obs["speed"]["speed"])
    if "speed" in input_states:
        state_list.append(obs["speed"]["speed_xy"])
    if "speed_limit" in input_states:
        state_list.append(obs["control"]["speed_limit"])
    if "control" in input_states:
        state_list.append(obs["control"]["throttle"])
        state_list.append(obs["control"]["steer"])
        state_list.append(obs["control"]["brake"])
        state_list.append(obs["control"]["gear"] / 5.0)
    if "acc_xy" in input_states:
        state_list.append(obs["velocity"]["acc_xy"])
    if "vel_xy" in input_states:
        state_list.append(obs["velocity"]["vel_xy"])
    if "vel_ang_z" in input_states:
        state_list.append(obs["velocity"]["vel_ang_z"])
    state = np.concatenate(state_list)

    camera = obs["camera"]["data"]
    target_waypoint = obs["target_waypoint"]
    next_waypoint = obs["next_waypoint"]
    next_command = obs["next_command"]
    if not train:
        camera = np.expand_dims(camera, 0)
        state = np.expand_dims(state, 0)
        target_waypoint = np.expand_dims(target_waypoint, 0)
        next_waypoint = np.expand_dims(next_waypoint, 0)
        next_command = np.expand_dims(next_command, 0)

    return {
        "state": state.astype(np.float32),
        "camera": camera,
        "bev": obs["camera"]["bev_data"],
        "at_red_light": obs["traffic_light"]["at_red_light"],
        "compass": obs["camera"]["compass"],
        "target_waypoint": target_waypoint,
        "cur_waypoint": obs["cur_waypoint"],
        "next_waypoint": next_waypoint,
        "next_command": next_command,
    }


# --------------------------------------------------------- navigation obs


def waypoint_plan_obs(ev_loc_xy, ev_yaw_deg: float, route_plan, steps: int) -> Dict:
    """Plan-window observation: the next ``steps`` route entries in the ego
    frame with command/road/lane/junction annotations (reference:
    carla_gym/core/obs_manager/navigation/waypoint_plan.py:46-80). The last
    entry pads short routes."""
    ev = np.asarray(ev_loc_xy, np.float64)[:2]
    yaw = np.deg2rad(ev_yaw_deg)
    c, s = np.cos(-yaw), np.sin(-yaw)
    location, command, road_id, lane_id, is_junction = [], [], [], [], []
    for i in range(steps):
        wp, option = route_plan[min(i, len(route_plan) - 1)]
        loc = wp.transform.location
        d = np.array([loc.x - ev[0], loc.y - ev[1]])
        location.append([c * d[0] - s * d[1], s * d[0] + c * d[1]])
        command.append(int(getattr(option, "value", option)))
        road_id.append(wp.road_id)
        lane_id.append(wp.lane_id)
        is_junction.append(bool(wp.is_junction))
    return {
        "location": np.asarray(location, np.float32),
        "command": np.asarray(command, np.int8),
        "road_id": np.asarray(road_id, np.int8),
        "lane_id": np.asarray(lane_id, np.int8),
        "is_junction": np.asarray(is_junction, np.int8),
    }


class GnssPlanTracker:
    """Target-GPS selection over the sparse leaderboard plan (reference:
    carla_gym/core/obs_manager/navigation/gnss.py:89-143): advance the plan
    index once the next target is behind the ego and within 12 m; lane-change
    commands defer to the following command."""

    CHANGE_COMMANDS = (5, 6)  # CHANGELANELEFT / CHANGELANERIGHT

    def __init__(self, global_plan_gps: Sequence):
        self._plan = [
            (self._gps_tuple(gps), int(getattr(opt, "value", opt)))
            for gps, opt in global_plan_gps
        ]
        self._idx = -1

    @staticmethod
    def _gps_tuple(gps):
        if isinstance(gps, dict):
            return (float(gps["lat"]), float(gps["lon"]), float(gps.get("z", 0.0)))
        return tuple(float(v) for v in gps)

    @staticmethod
    def _gps_to_xy(lat: float, lon: float) -> np.ndarray:
        from ..driving.gps import gps2xyz

        x, y, _ = gps2xyz(lat, lon, 0.0, lat_ref=0.0, lon_ref=0.0)
        return np.array([x, y])

    def tick(self, gnss_lat_lon_z, imu7) -> Dict:
        gnss = np.asarray(gnss_lat_lon_z, np.float64)
        imu = np.asarray(imu7, np.float64)
        compass = 0.0 if np.isnan(imu[-1]) else float(imu[-1])

        next_gps, _ = self._plan[min(self._idx + 1, len(self._plan) - 1)]
        vec = self._gps_to_xy(next_gps[0], next_gps[1]) - self._gps_to_xy(gnss[0], gnss[1])
        yaw = compass - np.pi / 2.0  # north-referenced compass -> world yaw
        c, s = np.cos(-yaw), np.sin(-yaw)
        loc_in_ev = np.array([c * vec[0] - s * vec[1], s * vec[0] + c * vec[1]])
        if np.linalg.norm(loc_in_ev) < 12.0 and loc_in_ev[0] < 0.0:
            self._idx += 1
        self._idx = min(self._idx, len(self._plan) - 2)

        _, cmd0 = self._plan[max(0, self._idx)]
        gps_point, cmd1 = self._plan[self._idx + 1]
        if cmd0 in self.CHANGE_COMMANDS and cmd1 not in self.CHANGE_COMMANDS:
            command = cmd1
        else:
            command = cmd0
        return {
            "gnss": gnss.astype(np.float32),
            "imu": imu.astype(np.float32),
            "target_gps": np.asarray(gps_point, np.float32),
            "command": np.asarray([command], np.int8),
        }


def stop_sign_obs(ev_loc, target_trigger_loc, stop_completed: bool,
                  distance_threshold: float = 4.0) -> Dict:
    """at_stop_sign flag: the criterion's targeted, not-yet-completed sign is
    within threshold (reference: obs_manager/object_finder/stop_sign.py:20-34)."""
    at = 0
    if target_trigger_loc is not None and not stop_completed:
        d = np.linalg.norm(
            np.asarray(ev_loc, np.float64)[:2] - np.asarray(target_trigger_loc, np.float64)[:2]
        )
        if d < distance_threshold:
            at = 1
    return {"at_stop_sign": at}


def route_obs(
    ev_loc_xy,
    ev_yaw_deg: float,
    route_plan,
    route_remaining_m: float,
    route_steps: int = 5,
) -> Dict:
    """RL route observation (reference: obs_manager/actor_state/route.py:35-89):
    clipped lateral distance + heading diff to the current route waypoint,
    the next ``route_steps`` waypoints in the ego frame, and km remaining."""
    from .criteria import cast_angle

    ev = np.asarray(ev_loc_xy, np.float64)[:2]
    wp, _ = route_plan[0]
    wp_loc = wp.transform.location
    wp_yaw = float(wp.transform.rotation.yaw)
    d_vec = ev - np.array([wp_loc.x, wp_loc.y])
    yaw_rad = np.deg2rad(wp_yaw)
    wp_unit_right = np.array([-np.sin(yaw_rad), np.cos(yaw_rad)])
    lateral = float(np.clip(abs(np.dot(wp_unit_right, d_vec)), 0.0, 2.0))
    angle = float(np.clip(np.deg2rad(abs(cast_angle(ev_yaw_deg - wp_yaw))), -2.0, 2.0))

    window = waypoint_plan_obs(ev_loc_xy, ev_yaw_deg, route_plan, route_steps)
    return {
        "lateral_dist": np.array([lateral], np.float32),
        "angle_diff": np.array([angle], np.float32),
        "route_locs": window["location"].reshape(-1),
        "dist_remaining": np.array([route_remaining_m / 1000.0], np.float32),
    }
