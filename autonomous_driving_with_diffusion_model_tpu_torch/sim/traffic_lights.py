"""First-party traffic-light / stop-sign registries and lane observation.

The port's own copy of the JAX package's ``sim/traffic_lights.py``, which it may not import.

First-party equivalent of the reference's world-scanning utilities that feed
the criteria suite (``sim.criteria``), the reward hazards, and the birdview
renderer:

- ``TrafficLightRegistry`` — per-light stop-line segments + trigger locations
  built from the world's traffic-light actors (reference:
  carla_gym/utils/traffic_light.py:7-127 ``_get_traffic_light_waypoints`` +
  ``TrafficLightHandler.reset``), plus the affecting-light query
  (``get_light_state``, reference traffic_light.py:128-184) and the per-color
  stop-line extraction the chauffeurnet birdview consumes
  (``get_stopline_vtx``, reference traffic_light.py:208-227).
- ``StopSignRegistry`` — the stop-sign scan + trigger-volume tests that drive
  the ``RunStopSign`` state machine (reference:
  carla_gym/core/task_actor/common/criteria/run_stop_sign.py:82-166).
- ``lane_observation`` — nearest driving/parking-lane geometry for
  ``OutsideRouteLaneTracker`` (reference: outside_route_lane.py:44-71).

Everything here is an adapter over duck-typed CARLA world/map objects (the
mock in tests/mock_carla.py implements the same surface); all decision logic
stays in the tested pure state machines in ``sim.criteria``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .criteria import LightObservation, StopLine, point_inside_boundingbox

__all__ = [
    "TrafficLightRegistry",
    "StopSignRegistry",
    "LaneObservation",
    "lane_observation",
    "rotation_matrix",
    "transform_point",
]

RED, YELLOW, GREEN = "Red", "Yellow", "Green"


def rotation_matrix(roll_deg: float, pitch_deg: float, yaw_deg: float) -> np.ndarray:
    """CARLA/UE transform rotation matrix (column 0 = forward vector)."""
    r, p, y = np.deg2rad([roll_deg, pitch_deg, yaw_deg])
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    return np.array(
        [
            [cp * cy, cy * sp * sr - sy * cr, -cy * sp * cr - sy * sr],
            [cp * sy, sy * sp * sr + cy * cr, -sy * sp * cr + cy * sr],
            [sp, -cp * sr, cp * cr],
        ]
    )


def transform_point(transform, local_xyz) -> np.ndarray:
    """Apply a CARLA transform to a local point, in numpy (so the registries
    never require ``carla.Transform.transform`` on mock objects)."""
    rot = transform.rotation
    R = rotation_matrix(rot.roll, rot.pitch, rot.yaw)
    loc = transform.location
    return R @ np.asarray(local_xyz, np.float64) + np.array([loc.x, loc.y, loc.z])


def _loc_xy(obj) -> np.ndarray:
    return np.array([obj.x, obj.y], np.float64)


@dataclass
class _StoplineWaypoint:
    """Plain-data snapshot of one advanced stop-line waypoint."""

    road_id: int
    lane_id: int
    forward: Tuple[float, float]
    location: Tuple[float, float]
    prev_road_id: int  # waypoint 4 m behind (traffic_light.py:161-167)
    prev_lane_id: int


@dataclass
class _LightEntry:
    actor: object
    trigger_loc: Tuple[float, float]  # world-frame trigger-volume center (xy)
    waypoints: List[_StoplineWaypoint]
    stop_lines: List[StopLine]
    junction_paths: List[List[Tuple[float, float]]]


def _build_light_entry(light, carla_map) -> _LightEntry:
    """Discretize the trigger volume, advance each lane's waypoint to the
    junction, and record the stop-line segment (0.4 lane-widths either side)
    — reference traffic_light.py:7-87."""
    base_tf = light.get_transform()
    tv_loc = light.trigger_volume.location
    tv_ext = light.trigger_volume.extent
    import carla

    # Discretize the trigger box (0.9 margin avoids adjacent lanes)
    ini_wps = []
    for x in np.arange(-0.9 * tv_ext.x, 0.9 * tv_ext.x, 1.0):
        world_pt = transform_point(base_tf, (tv_loc.x + x, tv_loc.y, tv_loc.z))
        wpx = carla_map.get_waypoint(carla.Location(*map(float, world_pt)))
        if wpx is None:
            continue
        if (
            not ini_wps
            or ini_wps[-1].road_id != wpx.road_id
            or ini_wps[-1].lane_id != wpx.lane_id
        ):
            ini_wps.append(wpx)

    waypoints: List[_StoplineWaypoint] = []
    stop_lines: List[StopLine] = []
    junction_wps = []
    for wpx in ini_wps:
        # advance to the junction entrance
        while not wpx.is_intersection:
            nxt = wpx.next(0.5)
            if nxt and not nxt[0].is_intersection:
                wpx = nxt[0]
            else:
                break
        junction_wps.append(wpx)
        fwd = wpx.transform.get_forward_vector()
        loc = wpx.transform.location
        right = np.array([-fwd.y, fwd.x])
        left_v = _loc_xy(loc) - 0.4 * wpx.lane_width * right
        right_v = _loc_xy(loc) + 0.4 * wpx.lane_width * right
        prev = wpx.previous(4.0)
        prev_wp = prev[0] if prev else wpx
        waypoints.append(
            _StoplineWaypoint(
                road_id=wpx.road_id,
                lane_id=wpx.lane_id,
                forward=(float(fwd.x), float(fwd.y)),
                location=(float(loc.x), float(loc.y)),
                prev_road_id=prev_wp.road_id,
                prev_lane_id=prev_wp.lane_id,
            )
        )
        stop_lines.append(
            StopLine(
                wp_forward=(float(fwd.x), float(fwd.y)),
                road_id=wpx.road_id,
                lane_id=wpx.lane_id,
                left=tuple(map(float, left_v)),
                right=tuple(map(float, right_v)),
            )
        )

    # all junction-crossing paths under this light (traffic_light.py:67-80);
    # consumed by birdview rendering of light-colored junction lanes
    junction_paths: List[List[Tuple[float, float]]] = []
    # each queue entry carries its own path-so-far so branches from different
    # junction arms never interleave, and dead ends still flush their path
    queue: List[Tuple[object, List[Tuple[float, float]]]] = [
        (wp, []) for wp in junction_wps
    ]
    guard = 0
    while queue and guard < 10_000:
        guard += 1
        wp, path = queue.pop()
        loc = wp.transform.location
        path = path + [(float(loc.x), float(loc.y))]
        successors = wp.next(1.0)
        terminated = not successors
        for nxt in successors:
            if nxt.is_junction:
                queue.append((nxt, path))
            else:
                terminated = True
        if terminated:
            junction_paths.append(path)

    trigger_world = transform_point(base_tf, (tv_loc.x, tv_loc.y, tv_loc.z))
    return _LightEntry(
        actor=light,
        trigger_loc=(float(trigger_world[0]), float(trigger_world[1])),
        waypoints=waypoints,
        stop_lines=stop_lines,
        junction_paths=junction_paths,
    )


class TrafficLightRegistry:
    """Scan a CARLA world once per episode and answer per-tick light queries
    (reference: TrafficLightHandler, traffic_light.py:90-227)."""

    def __init__(self, world, carla_map=None):
        self._map = carla_map if carla_map is not None else world.get_map()
        self.entries: List[_LightEntry] = []
        for actor in world.get_actors():
            if "traffic_light" in actor.type_id:
                self.entries.append(_build_light_entry(actor, self._map))

    def __len__(self) -> int:
        return len(self.entries)

    @staticmethod
    def _state_name(state) -> str:
        # real carla: enum with .name; mock: plain string
        return getattr(state, "name", str(state))

    def light_observations(self, ev_loc_xy, max_dist: float = 50.0) -> List[LightObservation]:
        """Nearby lights as plain-data ``LightObservation``s for RunRedLight."""
        ev = np.asarray(ev_loc_xy, np.float64)[:2]
        out = []
        for e in self.entries:
            if np.linalg.norm(ev - np.asarray(e.trigger_loc)) > max_dist:
                continue
            loc = e.actor.get_location()
            out.append(
                LightObservation(
                    id=e.actor.id,
                    is_red=self._state_name(e.actor.state) == RED,
                    trigger_loc=e.trigger_loc,
                    stop_lines=tuple(e.stop_lines),
                    loc=(loc.x, loc.y, loc.z),
                )
            )
        return out

    def get_light_state(self, veh_transform, offset: float = 0.0, dist_threshold: float = 15.0):
        """(state, loc_in_ev, light_id) of the light affecting the vehicle's
        lane, or (None, None, None) — reference traffic_light.py:128-184."""
        import carla

        fwd = veh_transform.get_forward_vector()
        veh_dir = np.array([fwd.x, fwd.y, fwd.z])
        hit = transform_point(veh_transform, (offset, 0.0, 0.0))
        hit_wp = self._map.get_waypoint(carla.Location(*map(float, hit)))
        if hit_wp is None:
            return None, None, None

        for e in self.entries:
            if not e.waypoints:
                continue
            # midpoint of the first/last stop-line waypoints (reference:144-147)
            mid = 0.5 * (
                np.asarray(e.waypoints[0].location) + np.asarray(e.waypoints[-1].location)
            )
            if np.linalg.norm(mid - hit[:2]) > dist_threshold:
                continue
            for wp in e.waypoints:
                dot = veh_dir[0] * wp.forward[0] + veh_dir[1] * wp.forward[1]
                same = hit_wp.road_id == wp.road_id and hit_wp.lane_id == wp.lane_id
                same_prev = (
                    hit_wp.road_id == wp.prev_road_id and hit_wp.lane_id == wp.prev_lane_id
                )
                if (same or same_prev) and dot > 0:
                    # stop-line location in the ego frame
                    rot = veh_transform.rotation
                    R = rotation_matrix(rot.roll, rot.pitch, rot.yaw)
                    loc = veh_transform.location
                    world = np.array([wp.location[0], wp.location[1], loc.z])
                    loc_in_ev = R.T @ (world - np.array([loc.x, loc.y, loc.z]))
                    return (
                        self._state_name(e.actor.state),
                        loc_in_ev.astype(np.float32),
                        e.actor.id,
                    )
        return None, None, None

    def at_red_light(self, veh_transform, dist_threshold: float = 15.0) -> bool:
        """Red OR yellow affecting light (reference expert semantics,
        carla_gym/utils/traffic_light_new.py:29-43)."""
        state, _, _ = self.get_light_state(veh_transform, dist_threshold=dist_threshold)
        return state in (RED, YELLOW)

    def get_stopline_vtx(self, veh_loc_xy, color: int, dist_threshold: float = 50.0):
        """Stop-line segments of nearby lights in the given state
        (0=green 1=yellow 2=red) for birdview rendering
        (reference traffic_light.py:208-227)."""
        want = {0: GREEN, 1: YELLOW, 2: RED}[color]
        ev = np.asarray(veh_loc_xy, np.float64)[:2]
        vtx = []
        for e in self.entries:
            if np.linalg.norm(ev - np.asarray(e.trigger_loc)) > dist_threshold:
                continue
            if self._state_name(e.actor.state) != want:
                continue
            vtx += [(sl.left, sl.right) for sl in e.stop_lines]
        return vtx


class StopSignRegistry:
    """Stop-sign world scan + trigger tests feeding the ``RunStopSign`` state
    machine (reference: run_stop_sign.py:82-166)."""

    def __init__(self, world, carla_map=None, proximity_threshold: float = 50.0,
                 waypoint_step: float = 1.0):
        self._map = carla_map if carla_map is not None else world.get_map()
        self._proximity_threshold = proximity_threshold
        self._waypoint_step = waypoint_step
        self.signs = [a for a in world.get_actors() if "traffic.stop" in a.type_id]
        self._by_id = {s.id: s for s in self.signs}

    def get(self, sign_id):
        return self._by_id.get(sign_id)

    def _trigger_center_extent(self, sign):
        tf = sign.get_transform()
        tv = sign.trigger_volume
        center = transform_point(tf, (tv.location.x, tv.location.y, tv.location.z))
        return center[:2], (tv.extent.x, tv.extent.y)

    def trigger_center(self, sign):
        """World-frame trigger-volume center (the reward's stop-sign hazard
        anchor, valeo_action.py:80-83)."""
        return self._trigger_center_extent(sign)[0]

    def inside_trigger(self, loc, sign) -> bool:
        center, extent = self._trigger_center_extent(sign)
        return point_inside_boundingbox((loc.x, loc.y), tuple(center), extent)

    def is_affected(self, loc, sign, multi_step: int = 20) -> bool:
        """Coarse distance test, then the vehicle's forward waypoint horizon
        against the trigger box (reference run_stop_sign.py:101-133)."""
        sign_loc = sign.get_transform().location
        if np.linalg.norm(
            np.array([sign_loc.x - loc.x, sign_loc.y - loc.y, sign_loc.z - loc.z])
        ) > self._proximity_threshold:
            return False
        center, extent = self._trigger_center_extent(sign)
        points = [(loc.x, loc.y)]
        wp = self._map.get_waypoint(loc)
        for _ in range(multi_step):
            if wp is None:
                break
            nxt = wp.next(self._waypoint_step)
            if not nxt:
                break
            wp = nxt[0]
            if wp is None:
                break
            p = wp.transform.location
            points.append((p.x, p.y))
        return any(point_inside_boundingbox(p, tuple(center), extent) for p in points)

    def scan(self, veh_transform):
        """First sign affecting the vehicle while it drives with the lane
        (reference run_stop_sign.py:82-99), or None."""
        fwd = veh_transform.get_forward_vector()
        wp = self._map.get_waypoint(veh_transform.location)
        if wp is None:
            return None
        wp_fwd = wp.transform.get_forward_vector()
        if fwd.x * wp_fwd.x + fwd.y * wp_fwd.y + fwd.z * wp_fwd.z <= 0:
            return None  # wrong-lane driving: ignore all
        for sign in self.signs:
            if self.is_affected(veh_transform.location, sign):
                return sign
        return None


@dataclass
class LaneObservation:
    """Per-tick nearest-lane geometry for OutsideRouteLaneTracker."""

    distance: float
    lane_width: float
    road_id: int
    lane_id: int
    wp_yaw: float
    is_junction: bool


def lane_observation(carla_map, ev_loc) -> Optional[LaneObservation]:
    """Distance to the nearest driving/parking lane center plus the driving
    lane's ids/yaw/junction flag (reference outside_route_lane.py:44-119:
    outside-lane uses min(driving, parking); wrong-lane uses the driving wp)."""
    import carla

    driving_wp = carla_map.get_waypoint(
        ev_loc, lane_type=carla.LaneType.Driving, project_to_road=True
    )
    if driving_wp is None:
        return None
    try:
        parking_wp = carla_map.get_waypoint(
            ev_loc, lane_type=carla.LaneType.Parking, project_to_road=True
        )
    except (TypeError, RuntimeError):
        parking_wp = None

    def dist_to(wp):
        p = wp.transform.location
        return float(np.linalg.norm([ev_loc.x - p.x, ev_loc.y - p.y, ev_loc.z - p.z]))

    d_drive = dist_to(driving_wp)
    if parking_wp is not None and dist_to(parking_wp) < d_drive:
        distance, width = dist_to(parking_wp), parking_wp.lane_width
    else:
        distance, width = d_drive, driving_wp.lane_width
    return LaneObservation(
        distance=distance,
        lane_width=float(width),
        road_id=driving_wp.road_id,
        lane_id=driving_wp.lane_id,
        wp_yaw=float(driving_wp.transform.rotation.yaw),
        is_junction=bool(driving_wp.is_junction),
    )
