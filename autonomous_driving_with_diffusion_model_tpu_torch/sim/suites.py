"""Benchmark task suites: Endless, NoCrash, CoRL2017, LeaderBoard.

The port's own copy of the JAX package's ``sim/suites.py``, which it may not import.

First-party task builders over the published scenario descriptions
(reference: carla_gym/envs/suites/{endless,nocrash,corl2017,leaderboard}_env.py
+ carla_gym/__init__.py:9-66 env registry + utils/config_utils.py:77-111 route
XML parsing). A *task* is a plain dict the native env consumes per episode:

    {"weather", "route_id", "num_zombie_vehicles", "num_zombie_walkers",
     "ego_route": [TransformSpec, ...]   # empty => endless
     "endless": bool, "target_speed": float}

The scenario-description data files (routes.xml + actors.json per suite /
route-description / town) are the published benchmark definitions; point
``description_root`` at a checkout of them (defaults to the directory named
by ``ADM_SCENARIO_DESCRIPTIONS``). Parsing is carla-free: waypoints become
``TransformSpec``s. The CARLA env that consumes these tasks is not ported
yet: the port's CLIs run them on ``driving.fake_env`` only.
"""

from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

__all__ = [
    "TransformSpec",
    "parse_suite_routes",
    "build_endless_tasks",
    "build_nocrash_tasks",
    "build_corl2017_tasks",
    "build_leaderboard_tasks",
    "build_suite_tasks",
    "SUITES",
    "WEATHER_GROUPS",
    "default_description_root",
]

WEATHER_GROUPS = {
    "new": ["SoftRainSunset", "WetSunset"],
    "train": ["ClearNoon", "WetNoon", "HardRainNoon", "ClearSunset"],
    "train_eval": ["WetNoon", "ClearSunset"],
    "simple": ["ClearNoon"],
    "all": [
        "ClearNoon", "CloudyNoon", "WetNoon", "WetCloudyNoon", "SoftRainNoon",
        "MidRainyNoon", "HardRainNoon", "ClearSunset", "CloudySunset",
        "WetSunset", "WetCloudySunset", "SoftRainSunset", "MidRainSunset",
        "HardRainSunset",
    ],
}


def _weathers(group: str) -> List[str]:
    # unknown group names are treated as a single literal weather preset
    return WEATHER_GROUPS.get(group, [group])


def default_description_root() -> Optional[str]:
    """The published scenario_descriptions tree named by
    ``ADM_SCENARIO_DESCRIPTIONS``, if it is there."""
    cand = os.environ.get("ADM_SCENARIO_DESCRIPTIONS")
    return cand if cand and os.path.isdir(cand) else None


@dataclass
class TransformSpec:
    """Plain-data carla.Transform (x, y, z, roll, pitch, yaw degrees)."""

    x: float
    y: float
    z: float = 0.0
    roll: float = 0.0
    pitch: float = 0.0
    yaw: float = 0.0

    @property
    def location(self):
        return self  # duck-typed .x/.y/.z access

    def as_carla(self):
        import carla

        return carla.Transform(
            carla.Location(self.x, self.y, self.z),
            carla.Rotation(roll=self.roll, pitch=self.pitch, yaw=self.yaw),
        )


def parse_suite_routes(xml_path: str) -> Dict[int, Dict]:
    """routes.xml -> {route_id: {"ego_vehicles": {id: [TransformSpec]},
    "scenario_actors": {id: [TransformSpec]}}} (config_utils.py:77-111)."""
    tree = ET.parse(xml_path)
    out: Dict[int, Dict] = {}
    for route in tree.iter("route"):
        route_id = int(route.attrib["id"])
        out[route_id] = {}
        for actor_type in ("ego_vehicle", "scenario_actor"):
            actors: Dict[str, List[TransformSpec]] = {}
            for actor in route.iter(actor_type):
                actors[actor.attrib["id"]] = [
                    TransformSpec(
                        x=float(wp.attrib["x"]),
                        y=float(wp.attrib["y"]),
                        z=float(wp.attrib.get("z", 0.0)),
                        roll=float(wp.attrib.get("roll", 0.0)),
                        pitch=float(wp.attrib.get("pitch", 0.0)),
                        yaw=float(wp.attrib.get("yaw", 0.0)),
                    )
                    for wp in actor.iter("waypoint")
                ]
            out[route_id][actor_type + "s"] = actors
    return out


def _tasks_from_description(
    description_folder: str,
    weathers: Sequence[str],
    num_zombie_vehicles: int,
    num_zombie_walkers: int,
) -> List[Dict]:
    with open(os.path.join(description_folder, "actors.json")) as f:
        actors = json.load(f)
    routes = parse_suite_routes(os.path.join(description_folder, "routes.xml"))
    hero = actors["ego_vehicles"].get("hero", {})
    tasks = []
    for weather in weathers:
        for route_id, desc in sorted(routes.items()):
            tasks.append(
                {
                    "weather": weather,
                    "description_folder": description_folder,
                    "route_id": route_id,
                    "num_zombie_vehicles": num_zombie_vehicles,
                    "num_zombie_walkers": num_zombie_walkers,
                    "ego_route": desc["ego_vehicles"].get("hero", []),
                    "ego_model": hero.get("model", "vehicle.lincoln.mkz2017"),
                    "target_speed": hero.get("speed", 10.0),
                    "endless": False,
                    "scenario_actors": desc.get("scenario_actors", {}),
                    "scenario_actor_configs": actors.get("scenario_actors", {}),
                }
            )
    return tasks


def build_endless_tasks(
    num_zombie_vehicles: int = 0,
    num_zombie_walkers: int = 0,
    weather_group: str = "simple",
    target_speed: float = 10.0,
    **_,
) -> List[Dict]:
    """Endless RL training tasks (endless_env.py:36-81)."""
    return [
        {
            "weather": weather,
            "description_folder": None,
            "route_id": 0,
            "num_zombie_vehicles": num_zombie_vehicles,
            "num_zombie_walkers": num_zombie_walkers,
            "ego_route": [],
            "ego_model": "vehicle.lincoln.mkz2017",
            "target_speed": target_speed,
            "endless": True,
            "scenario_actors": {},
            "scenario_actor_configs": {},
        }
        for weather in _weathers(weather_group)
    ]


# background-traffic densities per town (nocrash_env.py:53-77)
_NOCRASH_TRAFFIC = {
    "Town01": {"empty": (0, 0), "regular": (20, 50), "dense": (100, 250), "leaderboard": (120, 120)},
    "Town02": {"empty": (0, 0), "regular": (15, 50), "dense": (70, 150), "leaderboard": (70, 70)},
}


def build_nocrash_tasks(
    carla_map: str = "Town01",
    weather_group: str = "train",
    route_description: str = "lbc",
    background_traffic: str = "empty",
    description_root: Optional[str] = None,
    **_,
) -> List[Dict]:
    """NoCrash benchmark tasks (nocrash_env.py:36-113)."""
    assert carla_map in _NOCRASH_TRAFFIC, carla_map
    assert background_traffic in _NOCRASH_TRAFFIC[carla_map], background_traffic
    assert route_description in ("cexp", "lbc", "driving-benchmarks")
    root = description_root or default_description_root()
    if root is None:
        raise FileNotFoundError(
            "NoCrash scenario descriptions not found; set ADM_SCENARIO_DESCRIPTIONS"
        )
    n_veh, n_walk = _NOCRASH_TRAFFIC[carla_map][background_traffic]
    folder = os.path.join(root, "NoCrash", route_description, carla_map)
    return _tasks_from_description(folder, _weathers(weather_group), n_veh, n_walk)


def build_corl2017_tasks(
    carla_map: str = "Town01",
    weather_group: str = "train",
    route_description: str = "lbc",
    task_type: str = "straight",
    description_root: Optional[str] = None,
    **_,
) -> List[Dict]:
    """CoRL2017 benchmark tasks (corl2017_env.py:37-109)."""
    folders = {
        "straight": "Straight",
        "one_curve": "OneCurve",
        "navigation": "Navigation",
        "navigation_dynamic": "Navigation",
    }
    assert task_type in folders, task_type
    root = description_root or default_description_root()
    if root is None:
        raise FileNotFoundError(
            "CoRL2017 scenario descriptions not found; set ADM_SCENARIO_DESCRIPTIONS"
        )
    if task_type == "navigation_dynamic":
        n_veh, n_walk = {"Town01": (20, 50), "Town02": (15, 50)}[carla_map]
    else:
        n_veh, n_walk = 0, 0
    folder = os.path.join(
        root, "CoRL2017", route_description, folders[task_type], carla_map
    )
    return _tasks_from_description(folder, _weathers(weather_group), n_veh, n_walk)


# per-town traffic densities (leaderboard_env.py:37-54)
_LEADERBOARD_VEHICLES = {
    "Town01": 120, "Town02": 70, "Town03": 70, "Town04": 150, "Town05": 120, "Town06": 120,
}
_LEADERBOARD_WALKERS = {
    "Town01": 120, "Town02": 70, "Town03": 70, "Town04": 80, "Town05": 120, "Town06": 80,
}


def build_leaderboard_tasks(
    carla_map: str = "Town01",
    weather_group: str = "train",
    routes_group: Optional[str] = None,
    description_root: Optional[str] = None,
    scenarios_json: Optional[str] = None,
    **_,
) -> List[Dict]:
    """Leaderboard route tasks (leaderboard_env.py:36-121).

    ``scenarios_json`` (or env ADM_SCENARIOS_JSON): path to a published
    per-town scenario annotations file (e.g. all_towns_traffic_scenarios.json)
    — the env then samples and injects adversarial scenarios at route trigger
    points (sim/scenario_injection.py; reference route_scenario.py:337-496)."""
    assert carla_map in _LEADERBOARD_VEHICLES, carla_map
    root = description_root or default_description_root()
    if root is None:
        raise FileNotFoundError(
            "LeaderBoard scenario descriptions not found; set ADM_SCENARIO_DESCRIPTIONS"
        )
    sub = f"{carla_map}_{routes_group}" if (carla_map == "Town04" and routes_group) else carla_map
    folder = os.path.join(root, "LeaderBoard", sub)
    tasks = _tasks_from_description(
        folder,
        _weathers(weather_group),
        _LEADERBOARD_VEHICLES[carla_map],
        _LEADERBOARD_WALKERS[carla_map],
    )
    scenarios_json = scenarios_json or os.environ.get("ADM_SCENARIOS_JSON")
    for task in tasks:
        task["town"] = carla_map
        if scenarios_json:
            task["scenarios_json"] = scenarios_json
    return tasks


# env-id registry (carla_gym/__init__.py:9-66)
SUITES = {
    "Endless-v0": (build_endless_tasks, {}),
    "NoCrash-v0": (build_nocrash_tasks, {"background_traffic": "empty"}),
    "NoCrash-v1": (build_nocrash_tasks, {"background_traffic": "regular"}),
    "NoCrash-v2": (build_nocrash_tasks, {"background_traffic": "dense"}),
    "NoCrash-v3": (build_nocrash_tasks, {"background_traffic": "leaderboard"}),
    "CoRL2017-v0": (build_corl2017_tasks, {"task_type": "straight"}),
    "CoRL2017-v1": (build_corl2017_tasks, {"task_type": "one_curve"}),
    "CoRL2017-v2": (build_corl2017_tasks, {"task_type": "navigation"}),
    "CoRL2017-v3": (build_corl2017_tasks, {"task_type": "navigation_dynamic"}),
    "LeaderBoard-v0": (build_leaderboard_tasks, {}),
}


def build_suite_tasks(env_id: str, **kwargs) -> List[Dict]:
    """Tasks for a registered env id; kwargs override the suite defaults."""
    if env_id not in SUITES:
        raise KeyError(f"unknown env id {env_id!r}; available: {sorted(SUITES)}")
    builder, defaults = SUITES[env_id]
    return builder(**{**defaults, **kwargs})
