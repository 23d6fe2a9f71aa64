"""Driving criteria as simulator-independent state machines.

The port's own copy of the JAX package's ``sim/criteria.py``, which it may not import.

Pure-logic re-designs of the carla-roach criteria suite (reference:
carla_gym/core/task_actor/common/criteria/*.py). The CARLA-object queries
(map waypoints, sensors, trigger volumes) are abstracted into plain-data
inputs supplied per tick by the env adapter; thresholds, dedup rules and the
state machines match the reference exactly.

Each ``tick`` returns an info dict on the tick the infraction fires, else
None — the same contract the ego-vehicle handler accumulates into episode
infraction buffers (feeding ``driving.scoring.EpisodeCounters``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Blocked",
    "RouteDeviation",
    "CollisionTracker",
    "EncounterLight",
    "RunRedLight",
    "RunStopSign",
    "OutsideRouteLaneTracker",
    "segments_intersect",
    "point_inside_boundingbox",
    "cast_angle",
]


def cast_angle(x: float) -> float:
    """Cast angle to [-180, +180) (reference: carla_gym/utils/transforms.py)."""
    return ((x + 180.0) % 360.0) - 180.0


def segments_intersect(seg1, seg2) -> bool:
    """2-D segment intersection (replaces shapely in run_red_light.py:66-78)."""
    (p1, p2), (p3, p4) = seg1, seg2
    p1, p2, p3, p4 = (np.asarray(p, np.float64)[:2] for p in (p1, p2, p3, p4))

    def orient(a, b, c):
        v = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
        return 0 if abs(v) < 1e-12 else (1 if v > 0 else -1)

    def on_seg(a, b, c):
        return (
            min(a[0], b[0]) - 1e-12 <= c[0] <= max(a[0], b[0]) + 1e-12
            and min(a[1], b[1]) - 1e-12 <= c[1] <= max(a[1], b[1]) + 1e-12
        )

    o1, o2 = orient(p1, p2, p3), orient(p1, p2, p4)
    o3, o4 = orient(p3, p4, p1), orient(p3, p4, p2)
    if o1 != o2 and o3 != o4:
        return True
    return (
        (o1 == 0 and on_seg(p1, p2, p3))
        or (o2 == 0 and on_seg(p1, p2, p4))
        or (o3 == 0 and on_seg(p3, p4, p1))
        or (o4 == 0 and on_seg(p3, p4, p2))
    )


def point_inside_boundingbox(point, bb_center, bb_extent) -> bool:
    """Axis-aligned-in-local-frame rectangle test (run_stop_sign.py:146-166),
    including the reference's slim-bbox "bugfix" that squares the extent."""
    ex = max(bb_extent[0], bb_extent[1])
    ey = ex
    A = (bb_center[0] - ex, bb_center[1] - ey)
    B = (bb_center[0] + ex, bb_center[1] - ey)
    D = (bb_center[0] - ex, bb_center[1] + ey)
    M = (point[0], point[1])
    AB = (B[0] - A[0], B[1] - A[1])
    AD = (D[0] - A[0], D[1] - A[1])
    AM = (M[0] - A[0], M[1] - A[1])
    am_ab = AM[0] * AB[0] + AM[1] * AB[1]
    ab_ab = AB[0] * AB[0] + AB[1] * AB[1]
    am_ad = AM[0] * AD[0] + AM[1] * AD[1]
    ad_ad = AD[0] * AD[0] + AD[1] * AD[1]
    return 0 < am_ab < ab_ab and 0 < am_ad < ad_ad


class Blocked:
    """Speed < 0.1 m/s for > 90 s (reference: blocked.py:5-27)."""

    def __init__(self, speed_threshold=0.1, below_threshold_max_time=90.0):
        self._speed_threshold = speed_threshold
        self._below_threshold_max_time = below_threshold_max_time
        self._time_last_valid_state: Optional[float] = None

    def tick(self, speed_xy: float, sim_time: float, step: int, ev_loc=None):
        info = None
        if speed_xy < self._speed_threshold and self._time_last_valid_state is not None:
            if (sim_time - self._time_last_valid_state) > self._below_threshold_max_time:
                info = {
                    "step": step,
                    "simulation_time": sim_time,
                    "ev_loc": list(ev_loc) if ev_loc is not None else None,
                }
        else:
            self._time_last_valid_state = sim_time
        return info


class RouteDeviation:
    """Offroad 15/30 m, >30% of route (reference: route_deviation.py:2-33)."""

    def __init__(self, offroad_min=15, offroad_max=30, max_route_percentage=0.3):
        self._offroad_min = offroad_min
        self._offroad_max = offroad_max
        self._max_route_percentage = max_route_percentage
        self._out_route_distance = 0.0

    def tick(self, ev_loc, ref_waypoint_loc, distance_traveled, route_length, sim_time=0.0, step=0):
        distance = float(
            np.linalg.norm(np.asarray(ev_loc[:2]) - np.asarray(ref_waypoint_loc[:2]))
        )
        off_route_max = distance > self._offroad_max
        off_route_min = False
        if distance > self._offroad_min:
            self._out_route_distance += distance_traveled
            if self._out_route_distance / route_length > self._max_route_percentage:
                off_route_min = True
        if off_route_max or off_route_min:
            return {
                "step": step,
                "simulation_time": sim_time,
                "ev_loc": list(ev_loc),
                "off_route_max": off_route_max,
                "off_route_min": off_route_min,
            }
        return None


class CollisionTracker:
    """Collision dedup/classification (reference: collision.py:6-134).

    The env adapter feeds raw collision events (from the sim's collision
    sensor); this reproduces the same-id memory (5 s), micro-collision area
    filter (3 m register / 5 m forget), intensity threshold, and type
    classification. ``on_collision`` ingests an event; ``tick`` returns the
    pending deduped info once.
    """

    TYPE_STATIC = 0
    TYPE_VEHICLE = 1
    TYPE_PEDESTRIAN = 2
    TYPE_OTHER = -1

    def __init__(
        self,
        intensity_threshold=0.0,
        min_area_of_collision=3,
        max_area_of_collision=5,
        max_id_time=5,
    ):
        self._collision_info = None
        self.registered_collisions: List[np.ndarray] = []
        self.last_id = None
        self.collision_time = None
        self._min_area = min_area_of_collision
        self._max_area = max_area_of_collision
        self._max_id_time = max_id_time
        self._intensity_threshold = intensity_threshold

    @staticmethod
    def classify(other_type_id: str) -> int:
        if (
            "static" in other_type_id or "traffic" in other_type_id
        ) and "sidewalk" not in other_type_id:
            return CollisionTracker.TYPE_STATIC
        if "vehicle" in other_type_id:
            return CollisionTracker.TYPE_VEHICLE
        if "walker" in other_type_id:
            return CollisionTracker.TYPE_PEDESTRIAN
        return CollisionTracker.TYPE_OTHER

    def on_collision(
        self,
        ev_loc,
        other_actor_id: int,
        other_type_id: str,
        normal_impulse,
        frame: int,
        timestamp: float,
    ):
        if self.last_id == other_actor_id:
            return
        ev_loc = np.asarray(ev_loc, np.float64)
        for loc in self.registered_collisions:
            if np.linalg.norm(ev_loc - loc) <= self._min_area:
                return
        intensity = float(np.linalg.norm(np.asarray(normal_impulse)))
        if intensity < self._intensity_threshold:
            return
        self._collision_info = {
            "step": frame,
            "simulation_time": timestamp,
            "collision_type": self.classify(other_type_id),
            "other_actor_id": other_actor_id,
            "other_actor_type_id": other_type_id,
            "intensity": intensity,
            "ev_loc": ev_loc.tolist(),
        }
        self.collision_time = timestamp
        self.registered_collisions.append(ev_loc)
        if other_actor_id != 0:  # static objects keep id memory clear
            self.last_id = other_actor_id

    def tick(self, ev_loc, sim_time: float, start_frame: int = 0, start_time: float = 0.0):
        ev_loc = np.asarray(ev_loc, np.float64)
        self.registered_collisions = [
            loc
            for loc in self.registered_collisions
            if np.linalg.norm(ev_loc - loc) <= self._max_area
        ]
        if self.last_id and sim_time - self.collision_time > self._max_id_time:
            self.last_id = None
        info = self._collision_info
        self._collision_info = None
        if info is not None:
            info["step"] -= start_frame
            info["simulation_time"] -= start_time
        return info


class EncounterLight:
    """New nearby light encountered (reference: encounter_light.py:4-26)."""

    def __init__(self, dist_threshold=7.5):
        self._last_light_id = None
        self._dist_threshold = dist_threshold

    def tick(self, light_id, light_loc, sim_time=0.0, step=0):
        """light_id/light_loc: nearest affecting light within threshold (or None),
        as computed by the env's TrafficLightHandler equivalent."""
        if light_id is not None and light_id != self._last_light_id:
            self._last_light_id = light_id
            return {
                "step": step,
                "simulation_time": sim_time,
                "id": light_id,
                "tl_loc": list(light_loc) if light_loc is not None else None,
            }
        return None


@dataclass
class StopLine:
    """One stop line of a traffic light, in the ego's road network frame."""

    wp_forward: Tuple[float, float]  # lane direction unit-ish vector
    road_id: int
    lane_id: int
    left: Tuple[float, float]
    right: Tuple[float, float]


@dataclass
class LightObservation:
    id: int
    is_red: bool
    trigger_loc: Tuple[float, float]
    stop_lines: Sequence[StopLine] = field(default_factory=tuple)
    loc: Tuple[float, float, float] = (0.0, 0.0, 0.0)


class RunRedLight:
    """Tail segment crossing an affecting red light's stop line within 30 m
    (reference: run_red_light.py:7-64)."""

    def __init__(self, distance_light=30.0):
        self._last_red_light_id = None
        self._distance_light = distance_light

    def tick(
        self,
        ev_loc,
        ev_dir,
        tail_close_pt,
        tail_far_pt,
        tail_road_id: int,
        tail_lane_id: int,
        lights: Sequence[LightObservation],
        sim_time: float = 0.0,
        step: int = 0,
    ):
        ev_loc = np.asarray(ev_loc, np.float64)
        for light in lights:
            if np.linalg.norm(ev_loc[:2] - np.asarray(light.trigger_loc)) > self._distance_light:
                continue
            if not light.is_red:
                continue
            if self._last_red_light_id == light.id:
                continue
            for sl in light.stop_lines:
                dot = ev_dir[0] * sl.wp_forward[0] + ev_dir[1] * sl.wp_forward[1]
                if tail_road_id == sl.road_id and tail_lane_id == sl.lane_id and dot > 0:
                    if segments_intersect((tail_close_pt, tail_far_pt), (sl.left, sl.right)):
                        self._last_red_light_id = light.id
                        return {
                            "step": step,
                            "simulation_time": sim_time,
                            "id": light.id,
                            "tl_loc": list(light.loc),
                            "ev_loc": ev_loc.tolist(),
                        }
        return None


class RunStopSign:
    """Stop-sign state machine (reference: run_stop_sign.py:28-80): on first
    affect -> "encounter"; leaving the influence zone without having reached
    speed < 0.1 while inside the trigger volume -> "run"."""

    def __init__(self, proximity_threshold=50.0, speed_threshold=0.1):
        self._proximity_threshold = proximity_threshold
        self._speed_threshold = speed_threshold
        self._target_stop_id = None
        self._stop_completed = False
        self._affected_by_stop = False

    @property
    def target_stop_id(self):
        """Currently-targeted sign id (None when scanning) — lets the env
        adapter drive the registry queries and the reward's stop-sign hazard
        (reference valeo_action.py:75-88 reads the criterion's target)."""
        return self._target_stop_id

    @property
    def stop_completed(self) -> bool:
        return self._stop_completed

    def tick(
        self,
        ev_loc,
        speed_xy: float,
        affecting_stop_id,
        inside_trigger: bool,
        still_affected: bool,
        stop_loc=None,
        sim_time: float = 0.0,
        step: int = 0,
    ):
        """``affecting_stop_id``: id of a stop sign currently affecting the
        vehicle (env-side geometric scan, run_stop_sign.py:82-144), or None.
        ``inside_trigger``: ev inside the targeted sign's trigger volume.
        ``still_affected``: the *targeted* sign still affects the vehicle."""
        info = None
        if self._target_stop_id is None:
            if affecting_stop_id is not None:
                self._target_stop_id = affecting_stop_id
                info = {
                    "event": "encounter",
                    "step": step,
                    "simulation_time": sim_time,
                    "id": affecting_stop_id,
                    "stop_loc": list(stop_loc) if stop_loc is not None else None,
                    "ev_loc": list(ev_loc),
                }
        else:
            if not self._stop_completed and speed_xy < self._speed_threshold:
                self._stop_completed = True
            if not self._affected_by_stop and inside_trigger:
                self._affected_by_stop = True
            if not still_affected:
                if not self._stop_completed and self._affected_by_stop:
                    info = {
                        "event": "run",
                        "step": step,
                        "simulation_time": sim_time,
                        "id": self._target_stop_id,
                        "stop_loc": list(stop_loc) if stop_loc is not None else None,
                        "ev_loc": list(ev_loc),
                    }
                self._target_stop_id = None
                self._stop_completed = False
                self._affected_by_stop = False
        return info


class OutsideRouteLaneTracker:
    """Outside-lane / wrong-lane accounting (reference: outside_route_lane.py:6-119).

    The env adapter supplies per-tick lane geometry (distance to nearest
    driving/parking lane center, lane width, ids, junction flags, yaws); this
    reproduces the hysteresis and the distance accounting consumed by the
    penalty factor.
    """

    def __init__(
        self,
        allowed_out_distance=1.3,
        max_allowed_vehicle_angle=120.0,
        max_allowed_waypoint_angle=150.0,
    ):
        self._allowed_out_distance = allowed_out_distance
        self._max_vehicle_angle = max_allowed_vehicle_angle
        self._max_waypoint_angle = max_allowed_waypoint_angle
        self._outside_lane_active = False
        self._wrong_lane_active = False
        self._last_road_id = None
        self._last_lane_id = None
        self._pre_wp_yaw = None
        self._pre_wp_is_junction = False

    def tick(
        self,
        ev_loc,
        ev_yaw: float,
        lane_distance: float,
        lane_width: float,
        road_id: int,
        lane_id: int,
        wp_yaw: float,
        is_junction: bool,
        distance_traveled: float,
        sim_time: float = 0.0,
        step: int = 0,
    ):
        self._outside_lane_active = lane_distance > (lane_width / 2 + self._allowed_out_distance)

        if is_junction:
            self._wrong_lane_active = False
        elif self._last_road_id != road_id or self._last_lane_id != lane_id:
            if self._pre_wp_is_junction:
                self._wrong_lane_active = abs(cast_angle(wp_yaw - ev_yaw)) > self._max_vehicle_angle
            else:
                prev_yaw = self._pre_wp_yaw if self._pre_wp_yaw is not None else wp_yaw
                if abs(cast_angle(wp_yaw - prev_yaw)) >= self._max_waypoint_angle:
                    self._wrong_lane_active = not bool(self._wrong_lane_active)
                else:
                    self._wrong_lane_active = False

        self._last_road_id = road_id
        self._last_lane_id = lane_id
        self._pre_wp_yaw = wp_yaw
        self._pre_wp_is_junction = is_junction

        if self._outside_lane_active or self._wrong_lane_active:
            return {
                "step": step,
                "simulation_time": sim_time,
                "ev_loc": list(ev_loc),
                "distance_traveled": distance_traveled,
                "outside_lane": self._outside_lane_active,
                "wrong_lane": self._wrong_lane_active,
            }
        return None
