"""Leaderboard adversarial-scenario injection along routes.

The port's own copy of the JAX package's ``sim/scenario_injection.py``, which it may not import.

First-party rebuild of the leaderboard's route-scenario sampling pipeline
(reference: leaderboard/leaderboard/scenarios/route_scenario.py:70-81,337-496
and leaderboard/leaderboard/utils/route_parser.py:169-378): parse the
published per-town scenario annotations JSON, match each scenario's trigger
transform against the traced route with the reference's position/angle
tolerances, sample one scenario per trigger point with the reference's
prioritized selection, and translate the sampled definitions into the native
env's scripted adversaries (``sim.scenario_actors``).

Class translation (reference NUMBER_CLASS_TRANSLATION, route_scenario.py:70-81)
onto first-party behaviors:

| Reference class                     | Native behavior                       |
|-------------------------------------|---------------------------------------|
| Scenario1 ControlLoss               | ego steer-noise pulse at the trigger  |
| Scenario2 FollowLeadingVehicle      | slow lead vehicle ahead on the route  |
| Scenario3 DynamicObjectCrossing     | walker crossing when the ego nears    |
| Scenario4 VehicleTurningRoute       | walker crossing at the turn           |
| Scenario5 OtherLeadingVehicle       | slow lead vehicle ahead on the route  |
| Scenario6 ManeuverOppositeDirection | oncoming vehicle in the other lane    |
| Scenario7-9 SignalJunctionCrossing  | vehicle crossing the junction         |
| Scenario10 NoSignalJunctionCrossing | vehicle crossing the junction         |

Divergences (registered in docs/PARITY.md): the native behaviors reuse the
framework's scripted agents instead of srunner's py_trees atomics, so timing
envelopes differ; BackgroundActivity is covered by the suite's zombie
vehicle/walker counts rather than a per-town spawn table.
"""

from __future__ import annotations

import json
import math
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "TRIGGER_THRESHOLD",
    "TRIGGER_ANGLE_THRESHOLD",
    "load_annotations",
    "scan_route_for_scenarios",
    "sample_scenarios",
    "ControlLossEvent",
    "build_injection",
]

# reference route_parser.py:21-22
TRIGGER_THRESHOLD = 2.0  # m, trigger-to-route position tolerance
TRIGGER_ANGLE_THRESHOLD = 10.0  # deg, yaw tolerance

# RoadOption integer values (sim.expert.RoadOption == reference agents enum)
_LEFT, _RIGHT, _STRAIGHT, _LANEFOLLOW = 1, 2, 3, 4
_CHANGELEFT, _CHANGERIGHT = 5, 6


def load_annotations(json_path: str) -> Dict[str, List[dict]]:
    """Parse a published scenario annotations JSON (e.g.
    all_towns_traffic_scenarios.json) into {town: [scenario, ...]}
    (reference: leaderboard_evaluator passes --scenarios;
    route_scenario.py:260-270 reads ``available_scenarios``)."""
    with open(json_path) as f:
        data = json.load(f)
    out: Dict[str, List[dict]] = {}
    for block in data.get("available_scenarios", []):
        for town, scenarios in block.items():
            out.setdefault(town, []).extend(scenarios)
    return out


def _waypoint_float(wp: dict) -> dict:
    return {
        "x": float(wp["x"]),
        "y": float(wp["y"]),
        "z": float(wp.get("z", 0.0)),
        "yaw": float(wp.get("yaw", 0.0)),
    }


def _match(wp: dict, transform) -> bool:
    """Reference route_parser.match_waypoints (route_parser.py:209-222):
    3-D position within 2 m AND yaw within 10 deg (mod 360)."""
    dx = wp["x"] - transform.location.x
    dy = wp["y"] - transform.location.y
    dz = wp["z"] - transform.location.z
    dpos = math.sqrt(dx * dx + dy * dy + dz * dz)
    dyaw = (wp["yaw"] - transform.rotation.yaw) % 360.0
    return dpos < TRIGGER_THRESHOLD and (
        dyaw < TRIGGER_ANGLE_THRESHOLD or dyaw > 360.0 - TRIGGER_ANGLE_THRESHOLD
    )


def _match_position(wp: dict, route) -> Optional[int]:
    for i, (transform, _cmd) in enumerate(route):
        if _match(wp, transform):
            return i
    return None


def _subtype(name: str, match_position: int, route) -> Optional[str]:
    """Route-dependent scenario subtype; None = not viable on this route
    (reference route_parser.get_scenario_type, route_parser.py:235-312)."""

    def decisive(cmd: int) -> bool:
        return cmd not in (_LANEFOLLOW, _CHANGELEFT, _CHANGERIGHT)

    rules = {
        "Scenario4": {_LEFT: "S4left", _RIGHT: "S4right"},
        "Scenario7": {_LEFT: "S7left", _RIGHT: "S7right", _STRAIGHT: "S7opposite"},
        "Scenario8": {_LEFT: "S8left"},
        "Scenario9": {_RIGHT: "S9right"},
    }
    if name not in rules:
        return "valid"
    for _transform, cmd in route[match_position:]:
        if decisive(int(cmd)):
            return rules[name].get(int(cmd))
    return None


def scan_route_for_scenarios(
    town: str, route: Sequence, annotations: Dict[str, List[dict]]
) -> "OrderedDict[int, List[dict]]":
    """Match every annotated trigger to the dense traced route.

    ``route`` is [(transform, command)] — the tracer's (waypoint.transform,
    RoadOption int) pairs at ~1 m resolution (the reference matches against
    ``interpolate_trajectory`` output, route_scenario.py:230-233).
    Returns {trigger_id: [scenario definition, ...]} preserving scan order
    (reference route_parser.scan_route_for_scenarios, route_parser.py:314-378).
    """
    triggers: "OrderedDict[int, dict]" = OrderedDict()
    potential: "OrderedDict[int, List[dict]]" = OrderedDict()
    next_id = 0
    for scenario in annotations.get(town, []):
        name = scenario["scenario_type"]
        for event in scenario.get("available_event_configurations", []):
            wp = _waypoint_float(event["transform"])
            pos = _match_position(wp, route)
            if pos is None:
                continue
            subtype = _subtype(name, pos, route)
            if subtype is None:
                continue
            definition = {
                "name": name,
                "other_actors": event.get("other_actors"),
                "trigger_position": wp,
                "scenario_type": subtype,
            }
            trigger_id = None
            for tid, existing in triggers.items():
                dx = existing["x"] - wp["x"]
                dy = existing["y"] - wp["y"]
                dyaw = (existing["yaw"] - wp["yaw"]) % 360.0
                if math.sqrt(dx * dx + dy * dy) < TRIGGER_THRESHOLD and (
                    dyaw < TRIGGER_ANGLE_THRESHOLD
                    or dyaw > 360.0 - TRIGGER_ANGLE_THRESHOLD
                ):
                    trigger_id = tid
                    break
            if trigger_id is None:
                trigger_id = next_id
                triggers[trigger_id] = wp
                potential[trigger_id] = []
                next_id += 1
            potential[trigger_id].append(definition)
    return potential


def _positions_overlap(a: dict, b: dict) -> bool:
    """Reference compare_scenarios (route_scenario.py:151-186). Note the
    reference computes dyaw of a position with ITSELF (always 0), so the
    check is effectively position-only — reproduced as behavior."""

    def vec(d):
        out = [d["trigger_position"]]
        others = d.get("other_actors") or {}
        for side in ("left", "front", "right"):
            out += others.get(side, [])
        return out

    for pa in vec(a):
        for pb in vec(b):
            dx = float(pa["x"]) - float(pb["x"])
            dy = float(pa["y"]) - float(pb["y"])
            dz = float(pa.get("z", 0.0)) - float(pb.get("z", 0.0))
            if math.sqrt(dx * dx + dy * dy + dz * dz) < TRIGGER_THRESHOLD:
                return True
    return False


def sample_scenarios(
    potential: "OrderedDict[int, List[dict]]", seed: int = 0
) -> List[dict]:
    """One scenario per trigger point: prioritized selection (highest scenario
    number wins), falling back to random draws when the position was already
    used (reference _scenario_sampling, route_scenario.py:337-415)."""
    rgn = np.random.RandomState(seed)
    sampled: List[dict] = []
    for trigger_id in list(potential.keys()):
        candidates = list(potential[trigger_id])

        def number(d):
            try:
                return int(d["name"].split("Scenario")[1])
            except (IndexError, ValueError):
                return -1

        # reference select_scenario keeps the LAST among equal numbers
        # (route_scenario.py:356-370 uses >=), not the first
        choice = None
        higher = -1
        for cand in candidates:
            if number(cand) >= higher:
                higher = number(cand)
                choice = cand
        candidates.remove(choice)
        while any(_positions_overlap(choice, s) for s in sampled):
            if not candidates:
                choice = None
                break
            choice = candidates[int(rgn.randint(len(candidates)))]
            candidates.remove(choice)
        if choice is not None:
            sampled.append(choice)
    return sampled


class ControlLossEvent:
    """Scenario1 (ControlLoss): a short steer-noise pulse when the ego passes
    the trigger point (reference: srunner ControlLoss adds three jittered
    steer perturbations after the trigger; here one triangular pulse of the
    framework's tested noiser shape, sim/noiser.py)."""

    def __init__(self, xy: Tuple[float, float], radius: float = 5.0,
                 duration: float = 2.5, seed: int = 0):
        self.xy = np.asarray(xy, np.float64)
        self.radius = float(radius)
        self.duration = float(duration)
        self._rng = np.random.default_rng(seed)
        self._sign = 1.0 if self._rng.integers(0, 2) else -1.0
        self._start: Optional[float] = None
        self.done = False

    def steer_offset(self, ego_xy, speed: float, sim_time: float) -> float:
        if self.done:
            return 0.0
        if self._start is None:
            if np.linalg.norm(np.asarray(ego_xy) - self.xy) < self.radius:
                self._start = sim_time
            else:
                return 0.0
        t = sim_time - self._start
        if t > self.duration:
            self.done = True
            return 0.0
        # triangular pulse, speed-attenuated like the collection noiser
        peak = 0.35
        ramp = self.duration / 2.0
        mag = peak * (t / ramp if t < ramp else (self.duration - t) / ramp)
        return float(self._sign * mag * (25.0 / (2.3 * speed + 5.0)) * 0.2)


def _offset_transform(wp: dict, forward_m: float = 0.0, right_m: float = 0.0):
    """A (x, y, yaw) shifted in the trigger's local frame."""
    yaw = math.radians(wp["yaw"])
    fx, fy = math.cos(yaw), math.sin(yaw)
    rx, ry = -fy, fx  # CARLA is left-handed: +90 deg = right of forward
    return (
        wp["x"] + forward_m * fx + right_m * rx,
        wp["y"] + forward_m * fy + right_m * ry,
        wp["yaw"],
    )


def build_injection(
    definitions: Sequence[dict],
    *,
    lane_width: float = 3.5,
    seed: int = 0,
    walker_speed: Optional[float] = None,
    walker_trigger_dist: Optional[float] = None,
) -> Dict:
    """Translate sampled scenario definitions into native adversaries.

    Returns a dict with:

    * ``vehicle_routes`` / ``vehicle_configs`` — ScenarioActorHandler inputs
      (lead vehicles, oncoming vehicles, junction crossers);
    * ``walker_specs`` — crossing-walker specs
      [{"spawn_xy", "cross_dir", "trigger_xy", "trigger_dist", "speed"}];
    * ``control_loss`` — [ControlLossEvent] for the env to apply to the ego.

    Spawn geometry per behavior (divergences vs the srunner scenario classes
    are registered in docs/PARITY.md):

    * lead vehicle (S2/S5): 25 m ahead of the trigger along its yaw
      (srunner follow_leading_vehicle.py:73 _first_vehicle_location), driving
      on at a low target speed;
    * crossing walker (S3/S4): on the right shoulder one lane out, crossing
      left across the road when the ego is within 14 m at 3.8 m/s — srunner's
      DynamicObjectCrossing values for a driving lane directly beside the
      sidewalk (num_lane_changes = 2: trigger 12 + n, speed 3 + 0.4n,
      object_crash_vehicle.py:257,386; extracted as oracle in
      tests/test_srunner_envelopes.py);
    * oncoming vehicle (S6): one lane left, 50 m ahead, yaw flipped, at
      srunner's 5.56 m/s _opposite_speed (maneuver_opposite_direction.py:65);
    * junction crosser (S7-S10): at the JSON's other_actors transform when
      present, else one lane left 30 m ahead, crossing straight.
    """
    from .suites import TransformSpec

    vehicle_routes: Dict[str, List] = {}
    vehicle_configs: Dict[str, dict] = {}
    walker_specs: List[dict] = []
    control_loss: List[ControlLossEvent] = []

    for i, definition in enumerate(definitions):
        name = definition["name"]
        wp = definition["trigger_position"]
        sa_id = f"injected_{name}_{i}"
        try:
            num = int(name.split("Scenario")[1])
        except (IndexError, ValueError):
            continue

        if num == 1:
            control_loss.append(
                ControlLossEvent((wp["x"], wp["y"]), seed=seed + i)
            )
        elif num in (3, 4):
            # S4left turns put the crossing hazard on the LEFT shoulder
            # (VehicleTurningRoute crosses from the turn side); S3 and
            # S4right cross from the right shoulder
            side = -1.0 if definition.get("scenario_type") == "S4left" else 1.0
            spawn = _offset_transform(wp, forward_m=8.0, right_m=side * lane_width)
            yaw = math.radians(wp["yaw"])
            walker_specs.append({
                "spawn_xy": (spawn[0], spawn[1]),
                # cross the ego lane perpendicularly, from the spawn side
                "cross_dir": (side * math.sin(yaw), -side * math.cos(yaw)),
                "trigger_xy": (wp["x"], wp["y"]),
                # srunner DynamicObjectCrossing on a sidewalk-adjacent lane:
                # dist = 12 + num_lane_changes, speed = 3 + 0.4*num_lane_changes
                # with num_lane_changes = 2 (object_crash_vehicle.py:309-341,386);
                # overridable for envs that need a slower/lingering hazard
                "trigger_dist": 14.0 if walker_trigger_dist is None else walker_trigger_dist,
                "speed": 3.8 if walker_speed is None else walker_speed,
                "cross_m": 2.5 * lane_width,
            })
        elif num in (2, 5):
            a = _offset_transform(wp, forward_m=25.0)
            b = _offset_transform(wp, forward_m=120.0)
            vehicle_routes[sa_id] = [
                TransformSpec(a[0], a[1], 0.2, yaw=a[2]),
                TransformSpec(b[0], b[1], 0.2, yaw=b[2]),
            ]
            # S2 (FollowLeadingVehicle): the lead drives a stretch then HOLDS
            # a stop, forcing the ego to brake behind it (srunner
            # follow_leading_vehicle.py behavior); S5 keeps rolling slowly
            kwargs = {"target_speed": 4.0}
            if num == 2:
                kwargs["stop_after_m"] = 40.0
            vehicle_configs[sa_id] = {
                "model": "vehicle.*",
                "agent_entry_point": "constant_speed_agent:ConstantSpeedAgent",
                "agent_kwargs": kwargs,
            }
        elif num == 6:
            a = _offset_transform(wp, forward_m=50.0, right_m=-lane_width)
            b = _offset_transform(wp, forward_m=-20.0, right_m=-lane_width)
            yaw_back = (wp["yaw"] + 180.0) % 360.0
            vehicle_routes[sa_id] = [
                TransformSpec(a[0], a[1], 0.2, yaw=yaw_back),
                TransformSpec(b[0], b[1], 0.2, yaw=yaw_back),
            ]
            vehicle_configs[sa_id] = {
                "model": "vehicle.*",
                "agent_entry_point": "constant_speed_agent:ConstantSpeedAgent",
                # srunner ManeuverOppositeDirection._opposite_speed
                # (maneuver_opposite_direction.py:65)
                "agent_kwargs": {"target_speed": 5.56},
            }
        elif num in (7, 8, 9, 10):
            others = definition.get("other_actors") or {}
            placed = None
            for side in ("left", "front", "right"):
                if others.get(side):
                    placed = _waypoint_float(others[side][0])
                    break
            if placed is not None:
                a = (placed["x"], placed["y"], placed["yaw"])
                b = _offset_transform(placed, forward_m=60.0)
            else:
                a = _offset_transform(wp, forward_m=30.0, right_m=-lane_width)
                b = (a[0] + 60.0 * math.cos(math.radians(a[2])),
                     a[1] + 60.0 * math.sin(math.radians(a[2])), a[2])
            vehicle_routes[sa_id] = [
                TransformSpec(a[0], a[1], 0.2, yaw=a[2]),
                TransformSpec(b[0], b[1], 0.2, yaw=b[2] if len(b) > 2 else a[2]),
            ]
            vehicle_configs[sa_id] = {
                "model": "vehicle.*",
                "agent_entry_point": "constant_speed_agent:ConstantSpeedAgent",
                "agent_kwargs": {"target_speed": 7.0},
            }

    return {
        "vehicle_routes": vehicle_routes,
        "vehicle_configs": vehicle_configs,
        "walker_specs": walker_specs,
        "control_loss": control_loss,
    }
