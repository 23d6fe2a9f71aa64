"""First-party global route planner over the map's lane topology.

The port's own copy of the JAX package's ``sim/route_planner.py``, which it may not import.

Replaces the reference's vendored planner (reference:
carla_gym/core/task_actor/common/navigation/global_route_planner.py:1-497,
map_utils.py, route_manipulation.py:21-165) and the endless-route navigation
half of TaskVehicle (task_vehicle.py:58-199) without depending on networkx or
the CARLA ``agents`` package:

- ``GlobalRoutePlanner`` — samples the map topology into a directed graph
  (lane segments as edges with 1 m waypoint paths, loose-end completion,
  zero-cost lane-change links), A* search with a euclidean heuristic, and
  the turn-decision classifier that annotates each waypoint with a
  ``RoadOption`` command.
- ``downsample_route`` / ``location_to_gps`` / ``location_route_to_gps`` —
  the leaderboard's sparse GPS plan format.
- ``RouteTracker`` — per-episode navigation state: multi-target tracing,
  endless extension to >= ``min_length`` meters via random spawn targets,
  cumulative-distance truncation, completion test, and the downsampled
  GPS/world plans the leaderboard agent consumes.

Everything operates on duck-typed CARLA map/waypoint objects (the mock in
tests/mock_carla.py implements the same surface).
"""

from __future__ import annotations

import heapq
import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..driving.gps import xyz2gps
from .expert import RoadOption

log = logging.getLogger(__name__)

__all__ = [
    "GlobalRoutePlanner",
    "RouteTracker",
    "downsample_route",
    "location_to_gps",
    "location_route_to_gps",
]


def _loc3(loc) -> np.ndarray:
    return np.array([loc.x, loc.y, loc.z], np.float64)


def _unit(a: np.ndarray) -> np.ndarray:
    return a / (np.linalg.norm(a) + np.finfo(float).eps)


@dataclass
class _Edge:
    """One directed lane segment (graph edge)."""

    n1: int
    n2: int
    length: float
    path: List[object]  # intermediate waypoints, resolution apart
    entry_wp: object
    exit_wp: object
    entry_vec: Optional[np.ndarray]
    exit_vec: Optional[np.ndarray]
    net_vec: Optional[np.ndarray]
    intersection: bool
    type: RoadOption
    change_waypoint: Optional[object] = None


def _sampled_topology(carla_map, resolution: float):
    """(entry_wp, exit_wp, entry_xyz, exit_xyz, path) per lane segment, with
    node keys rounded to whole meters so shared junction endpoints merge
    (reference map_utils.py:33-70)."""
    segments = []
    for wp1, wp2 in carla_map.get_topology():
        l1, l2 = wp1.transform.location, wp2.transform.location
        key1 = tuple(np.round([l1.x, l1.y, l1.z], 0))
        key2 = tuple(np.round([l2.x, l2.y, l2.z], 0))
        path = []
        if l1.distance(l2) > resolution:
            w = wp1.next(resolution)
            w = w[0] if w else None
            while w is not None and w.transform.location.distance(l2) > resolution:
                path.append(w)
                nxt = w.next(resolution)
                w = nxt[0] if nxt else None
        else:
            nxt = wp1.next(resolution)
            if nxt:
                path.append(nxt[0])
        segments.append((wp1, wp2, key1, key2, path))
    return segments


class GlobalRoutePlanner:
    """Topology graph + A* + RoadOption command annotation."""

    def __init__(self, carla_map, resolution: float = 1.0):
        self._map = carla_map
        self._resolution = resolution
        self._nodes: Dict[int, Tuple[float, float, float]] = {}
        self._id_map: Dict[Tuple[float, float, float], int] = {}
        self._adj: Dict[int, List[_Edge]] = {}
        self._edges: Dict[Tuple[int, int], _Edge] = {}
        self._road_map: Dict[Tuple[int, int, int], Tuple[int, int]] = {}
        self._topology = _sampled_topology(carla_map, resolution)

        self._intersection_end_node = -1
        self._previous_decision = RoadOption.VOID

        self._build_graph()
        self._find_loose_ends()
        self._lane_change_links()

    # ------------------------------------------------------------ graph build

    def _node(self, key) -> int:
        if key not in self._id_map:
            nid = len(self._id_map)
            self._id_map[key] = nid
            self._nodes[nid] = key
        return self._id_map[key]

    def _add_edge(self, edge: _Edge):
        self._adj.setdefault(edge.n1, []).append(edge)
        self._edges[(edge.n1, edge.n2)] = edge

    @staticmethod
    def _wp_key(wp) -> Tuple[int, int, int]:
        return (wp.road_id, getattr(wp, "section_id", 0), wp.lane_id)

    def _build_graph(self):
        """Lane segments -> directed edges (reference planner:32-103)."""
        for entry_wp, exit_wp, key1, key2, path in self._topology:
            n1, n2 = self._node(key1), self._node(key2)
            self._road_map[self._wp_key(entry_wp)] = (n1, n2)
            fwd1 = entry_wp.transform.get_forward_vector()
            fwd2 = exit_wp.transform.get_forward_vector()
            self._add_edge(
                _Edge(
                    n1=n1,
                    n2=n2,
                    length=len(path) + 1,
                    path=path,
                    entry_wp=entry_wp,
                    exit_wp=exit_wp,
                    entry_vec=np.array([fwd1.x, fwd1.y, fwd1.z]),
                    exit_vec=np.array([fwd2.x, fwd2.y, fwd2.z]),
                    net_vec=_unit(
                        _loc3(exit_wp.transform.location)
                        - _loc3(entry_wp.transform.location)
                    ),
                    intersection=bool(entry_wp.is_junction),
                    type=RoadOption.LANEFOLLOW,
                )
            )

    def _find_loose_ends(self):
        """Dead-end lanes get synthetic terminal edges (reference:105-164)."""
        count = 0
        for _, exit_wp, _, key2, _ in self._topology:
            if self._wp_key(exit_wp) in self._road_map:
                continue
            count += 1
            n1 = self._id_map[key2]
            n2 = -count
            self._road_map[self._wp_key(exit_wp)] = (n1, n2)
            road_key = self._wp_key(exit_wp)
            path = []
            nxt = exit_wp.next(self._resolution)
            while nxt and self._wp_key(nxt[0]) == road_key:
                path.append(nxt[0])
                nxt = nxt[0].next(self._resolution)
            if path:
                end = path[-1].transform.location
                self._nodes[n2] = (end.x, end.y, end.z)
                self._add_edge(
                    _Edge(
                        n1=n1,
                        n2=n2,
                        length=len(path) + 1,
                        path=path,
                        entry_wp=exit_wp,
                        exit_wp=path[-1],
                        entry_vec=None,
                        exit_vec=None,
                        net_vec=None,
                        intersection=bool(exit_wp.is_junction),
                        type=RoadOption.LANEFOLLOW,
                    )
                )

    def _lane_change_links(self):
        """Zero-cost lane-change edges where markings permit (reference:193-263).
        Skipped gracefully on maps whose waypoints lack lane-marking data."""
        import carla

        lane_change = getattr(carla, "LaneChange", None)
        for entry_wp, _, key1, _, path in self._topology:
            if entry_wp.is_junction:
                continue
            left_found = right_found = False
            for wp in path:
                if left_found and right_found:
                    break
                marking_r = getattr(wp, "right_lane_marking", None)
                if (
                    not right_found
                    and marking_r is not None
                    and lane_change is not None
                    and marking_r.lane_change & lane_change.Right
                ):
                    right_found = self._try_change_link(
                        key1, wp, wp.get_right_lane(), RoadOption.CHANGELANERIGHT
                    )
                marking_l = getattr(wp, "left_lane_marking", None)
                if (
                    not left_found
                    and marking_l is not None
                    and lane_change is not None
                    and marking_l.lane_change & lane_change.Left
                ):
                    left_found = self._try_change_link(
                        key1, wp, wp.get_left_lane(), RoadOption.CHANGELANELEFT
                    )

    def _try_change_link(self, key1, wp, target_wp, option: RoadOption) -> bool:
        import carla

        if (
            target_wp is None
            or target_wp.lane_type != carla.LaneType.Driving
            or wp.road_id != target_wp.road_id
        ):
            return False
        seg = self._road_map.get(self._wp_key(target_wp))
        if seg is None:
            return False
        self._add_edge(
            _Edge(
                n1=self._id_map[key1],
                n2=seg[0],
                length=0,
                path=[],
                entry_wp=wp,
                exit_wp=target_wp,
                entry_vec=None,
                exit_vec=None,
                net_vec=None,
                intersection=False,
                type=option,
                change_waypoint=target_wp,
            )
        )
        return True

    # ---------------------------------------------------------------- search

    def _localize(self, location) -> Optional[Tuple[int, int]]:
        wp = self._map.get_waypoint(location)
        if wp is None:
            return None
        return self._road_map.get(self._wp_key(wp))

    def _heuristic(self, n1: int, n2: int) -> float:
        return float(
            np.linalg.norm(np.asarray(self._nodes[n1]) - np.asarray(self._nodes[n2]))
        )

    def _astar(self, source: int, target: int) -> List[int]:
        """A* over the lane graph (replaces nx.astar_path)."""
        open_heap = [(self._heuristic(source, target), 0, source)]
        g = {source: 0.0}
        came: Dict[int, int] = {}
        tie = 0
        while open_heap:
            _, _, node = heapq.heappop(open_heap)
            if node == target:
                path = [node]
                while node in came:
                    node = came[node]
                    path.append(node)
                return path[::-1]
            for edge in self._adj.get(node, ()):
                cand = g[node] + edge.length
                if cand < g.get(edge.n2, np.inf):
                    g[edge.n2] = cand
                    came[edge.n2] = node
                    tie += 1
                    heapq.heappush(
                        open_heap, (cand + self._heuristic(edge.n2, target), tie, edge.n2)
                    )
        raise ValueError(f"no route between graph nodes {source} and {target}")

    def _path_search(self, origin, destination) -> List[int]:
        start, end = self._localize(origin), self._localize(destination)
        if start is None or end is None:
            raise ValueError("could not localize origin/destination on the lane graph")
        route = self._astar(start[0], end[0])
        route.append(end[1])
        return route

    # ---------------------------------------------------------- turn decisions

    def _successive_last_intersection_edge(self, index: int, route: List[int]):
        """Skip past tiny junction edges for a stable turn decision
        (reference:296-321)."""
        last_edge, last_node = None, None
        for i in range(index, len(route) - 1):
            edge = self._edges[(route[i], route[i + 1])]
            if route[i] == route[index]:
                last_edge = edge
            if edge.type == RoadOption.LANEFOLLOW and edge.intersection:
                last_edge, last_node = edge, route[i + 1]
            else:
                break
        return last_node, last_edge

    def _turn_decision(
        self, index: int, route: List[int], threshold: float = np.deg2rad(35)
    ) -> RoadOption:
        """RoadOption for the edge pair around route[index] (reference:323-396):
        entering a junction compares the exit vectors' cross product against
        the other junction exits to call LEFT/STRAIGHT/RIGHT."""
        next_edge = self._edges[(route[index], route[index + 1])]
        if index == 0:
            decision = next_edge.type
            self._previous_decision = decision
            return decision

        previous_node, current_node = route[index - 1], route[index]
        if (
            self._previous_decision != RoadOption.VOID
            and self._intersection_end_node > 0
            and self._intersection_end_node != previous_node
            and next_edge.type == RoadOption.LANEFOLLOW
            and next_edge.intersection
        ):
            decision = self._previous_decision
        else:
            self._intersection_end_node = -1
            current_edge = self._edges[(previous_node, current_node)]
            entering_junction = (
                current_edge.type == RoadOption.LANEFOLLOW
                and not current_edge.intersection
                and next_edge.type == RoadOption.LANEFOLLOW
                and next_edge.intersection
            )
            if not entering_junction:
                decision = next_edge.type
            else:
                last_node, tail_edge = self._successive_last_intersection_edge(
                    index, route
                )
                self._intersection_end_node = (
                    last_node if last_node is not None else -1
                )
                if tail_edge is not None:
                    next_edge = tail_edge
                cv, nv = current_edge.exit_vec, next_edge.exit_vec
                if cv is None or nv is None:
                    decision = next_edge.type
                else:
                    cross_list = [
                        float(np.cross(cv, e.net_vec)[2])
                        for e in self._adj.get(current_node, ())
                        if e.type == RoadOption.LANEFOLLOW
                        and e.n2 != route[index + 1]
                        and e.net_vec is not None
                    ] or [0.0]
                    next_cross = float(np.cross(cv, nv)[2])
                    deviation = np.arccos(
                        np.clip(
                            np.dot(cv, nv) / (np.linalg.norm(cv) * np.linalg.norm(nv)),
                            -1.0,
                            1.0,
                        )
                    )
                    if deviation < threshold:
                        decision = RoadOption.STRAIGHT
                    elif next_cross < min(cross_list):
                        decision = RoadOption.LEFT
                    elif next_cross > max(cross_list):
                        decision = RoadOption.RIGHT
                    elif next_cross < 0:
                        decision = RoadOption.LEFT
                    else:
                        decision = RoadOption.RIGHT

        self._previous_decision = decision
        return decision

    # ------------------------------------------------------------- public api

    @staticmethod
    def _closest_index(current_wp, waypoints) -> int:
        locs = np.array(
            [[w.transform.location.x, w.transform.location.y] for w in waypoints]
        )
        cur = np.array(
            [current_wp.transform.location.x, current_wp.transform.location.y]
        )
        return int(np.argmin(np.linalg.norm(locs - cur, axis=1))) if len(locs) else -1

    def abstract_route_plan(self, origin, destination) -> List[RoadOption]:
        route = self._path_search(origin, destination)
        return [self._turn_decision(i, route) for i in range(len(route) - 1)]

    def trace_route(self, origin, destination) -> List[Tuple[object, RoadOption]]:
        """[(waypoint, RoadOption)] from origin to destination
        (reference:431-497)."""
        trace: List[Tuple[object, RoadOption]] = []
        route = self._path_search(origin, destination)
        current_wp = self._map.get_waypoint(origin)
        dest_wp = self._map.get_waypoint(destination)

        for i in range(len(route) - 1):
            option = self._turn_decision(i, route)
            edge = self._edges[(route[i], route[i + 1])]

            if edge.type not in (RoadOption.LANEFOLLOW, RoadOption.VOID):
                # lane change: jump to the target lane's segment path
                trace.append((current_wp, option))
                seg = self._road_map[self._wp_key(edge.exit_wp)]
                next_edge = self._edges[seg]
                if next_edge.path:
                    idx = self._closest_index(current_wp, next_edge.path)
                    idx = min(len(next_edge.path) - 1, idx + 5)
                    current_wp = next_edge.path[idx]
                else:
                    current_wp = next_edge.exit_wp
                trace.append((current_wp, option))
            else:
                path = [edge.entry_wp] + edge.path + [edge.exit_wp]
                for wp in path[self._closest_index(current_wp, path):]:
                    current_wp = wp
                    trace.append((wp, option))
                    if (
                        len(route) - i <= 2
                        and wp.transform.location.distance(destination)
                        < 2 * self._resolution
                    ):
                        break
                    if (
                        len(route) - i <= 2
                        and dest_wp is not None
                        and self._wp_key(wp) == self._wp_key(dest_wp)
                    ):
                        dest_idx = self._closest_index(dest_wp, path)
                        if self._closest_index(current_wp, path) > dest_idx:
                            break
        return trace


# ------------------------------------------------------- route manipulation


def location_to_gps(location) -> Tuple[float, float, float]:
    """World -> leaderboard plan GPS (web mercator, zero reference —
    reference route_manipulation.py:23-28)."""
    return xyz2gps(location.x, location.y, location.z, lat_ref=0.0, lon_ref=0.0)


def location_route_to_gps(route) -> List[Tuple[Tuple[float, float, float], RoadOption]]:
    return [(location_to_gps(wp.transform.location), option) for wp, option in route]


def downsample_route(route, sample_factor: float) -> List[int]:
    """Indices of a sparse plan: keep lane changes, command transitions, and
    one waypoint per ``sample_factor`` meters (reference:119-165)."""
    ids: List[int] = []
    prev_option = None
    dist = 0.0
    changes = (RoadOption.CHANGELANELEFT, RoadOption.CHANGELANERIGHT)
    for i, (wp, option) in enumerate(route):
        if option in changes:
            ids.append(i)
            dist = 0.0
        elif prev_option != option and prev_option not in changes:
            ids.append(i)
            dist = 0.0
        elif dist > sample_factor:
            ids.append(i)
            dist = 0.0
        elif i == len(route) - 1:
            ids.append(i)
            dist = 0.0
        else:
            cur = wp.transform.location
            prev = route[i - 1][0].transform.location
            dist += cur.distance(prev)
        prev_option = option
    return ids


# ------------------------------------------------------------ route tracker


@dataclass
class RouteTracker:
    """Per-episode navigation state (the TaskVehicle navigation half —
    reference task_vehicle.py:58-199): global route with commands, endless
    extension, cumulative-distance truncation, and the leaderboard plans."""

    planner: GlobalRoutePlanner
    carla_map: object
    route: List[Tuple[object, RoadOption]] = field(default_factory=list)
    route_length: float = 0.0
    route_completed: float = 0.0
    plan_gps: List[Tuple[Tuple[float, float, float], RoadOption]] = field(
        default_factory=list
    )
    plan_world: List[Tuple[object, RoadOption]] = field(default_factory=list)
    last_route_location: Optional[Tuple[float, ...]] = None  # (x, y[, z]);
    # init to the spawn location WITH its z-lift (task_vehicle.py:73),
    # advanced by truncate()
    _saturated_at: Optional[float] = None  # route_length when extension last failed

    @staticmethod
    def _segment_length(route) -> float:
        total = 0.0
        for i in range(len(route) - 1):
            total += route[i][0].transform.location.distance(
                route[i + 1][0].transform.location
            )
        return total

    def _append(self, trace):
        self.route += trace
        self.route_length += self._segment_length(trace)
        # leaderboard sparse plans (task_vehicle.py:75-83)
        gps = location_route_to_gps(trace)
        ids = downsample_route(trace, 50)
        self.plan_gps += [gps[i] for i in ids]
        self.plan_world += [
            (trace[i][0].transform.location, trace[i][1]) for i in ids
        ]

    def trace_to_targets(self, start_location, target_locations: Sequence):
        cur = start_location
        for target in target_locations:
            self._append(self.planner.trace_route(cur, target))
            cur = target

    def extend_random(
        self,
        vehicle_location,
        spawn_transforms: Sequence,
        rng: np.random.Generator,
        min_length: float = 1000.0,
        max_attempts: int = 100,
    ):
        """Endless mode: chain random spawn-point targets until the route is
        at least ``min_length`` m (task_vehicle.py:67-69, 85-102)."""
        if self._saturated_at is not None and self._saturated_at == self.route_length:
            return  # no reachable targets were found last time; nothing changed
        attempts = 0
        while self.route_length < min_length and attempts < max_attempts:
            attempts += 1
            if not self.route:
                last_loc = vehicle_location
                wp = self.carla_map.get_waypoint(last_loc)
                nxt = wp.next(6.0)
                target = (nxt[0] if nxt else wp).transform.location
            else:
                last_loc = self.route[-1][0].transform.location
                last_road = self.carla_map.get_waypoint(last_loc).road_id
                candidates = [t for r, t in spawn_transforms if r != last_road]
                if not candidates:
                    candidates = [t for _, t in spawn_transforms]
                if not candidates:
                    break
                target = candidates[int(rng.integers(len(candidates)))].location
            try:
                self._append(self.planner.trace_route(last_loc, target))
            except ValueError:
                continue  # unreachable target; try another
        if self.route_length < min_length:
            self._saturated_at = self.route_length
            log.warning(
                "endless route extension stopped at %.0f m (< %.0f m)",
                self.route_length,
                min_length,
            )
        else:
            self._saturated_at = None

    def truncate(self, ev_loc_xy, min_distance: float = 7.0, max_distance: float = 50.0) -> float:
        """Pop passed waypoints by cumulative distance; returns meters
        traveled along the route (task_vehicle.py:149-185)."""
        ev = np.asarray(ev_loc_xy, np.float64)[:2]
        closest_idx = 0
        farthest_in_range = -np.inf
        cumulative = 0.0
        for i in range(1, len(self.route)):
            if cumulative > max_distance:
                break
            cur = self.route[i][0].transform.location
            prev = self.route[i - 1][0].transform.location
            cumulative += float(np.hypot(cur.x - prev.x, cur.y - prev.y))
            distance = float(np.hypot(cur.x - ev[0], cur.y - ev[1]))
            if distance <= min_distance and distance > farthest_in_range:
                farthest_in_range = distance
                closest_idx = i
        traveled = self._segment_length(self.route[: closest_idx + 1])
        self.route_completed += traveled
        if closest_idx > 0:
            # the reference records the PREVIOUS head, not the last popped
            # point (task_vehicle.py:182-183, executed verbatim)
            h = self.route[0][0].transform.location
            self.last_route_location = (float(h.x), float(h.y), float(h.z))
        self.route = self.route[closest_idx:]
        return traveled

    def route_transform(self) -> Tuple[Tuple[float, float], float]:
        """((x, y), yaw_deg) of the reward/terminal lateral anchor: the last
        passed route location, heading toward the current route head — the
        reference's get_route_transform (task_vehicle.py:373-383). Falls back
        to the head's own yaw when the two nearly coincide; the coincidence
        test is 3D like the reference's Location.distance, so a z-lifted
        spawn anchor keeps the arctan2 branch even at the spawn xy."""
        head = self.route[0][0].transform.location
        loc0 = self.last_route_location
        if loc0 is None:
            loc0 = (float(head.x), float(head.y), float(head.z))
        z0 = loc0[2] if len(loc0) > 2 else 0.0
        d3 = np.sqrt(
            (head.x - loc0[0]) ** 2 + (head.y - loc0[1]) ** 2 + (head.z - z0) ** 2
        )
        if d3 < 0.1:
            yaw = float(self.route[0][0].transform.rotation.yaw)
        else:
            yaw = float(np.degrees(np.arctan2(head.y - loc0[1], head.x - loc0[0])))
        return (float(loc0[0]), float(loc0[1])), yaw

    def is_completed(
        self, ev_location, final_target_location, percentage_threshold: float = 0.99,
        distance_threshold: float = 10.0,
    ) -> bool:
        if self.route_length <= 0:
            return False
        frac = self.route_completed / self.route_length
        near = (
            float(
                np.hypot(
                    ev_location.x - final_target_location.x,
                    ev_location.y - final_target_location.y,
                )
            )
            < distance_threshold
        )
        return frac > percentage_threshold and near

    def as_xy(self) -> List[Tuple[Tuple[float, float], int]]:
        """Env/expert route format: [((x, y), command_value)]."""
        return [
            ((wp.transform.location.x, wp.transform.location.y), int(option.value))
            for wp, option in self.route
        ]
