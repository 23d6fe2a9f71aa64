"""Episode scoring (reference: carla_gym ego_vehicle_handler.py:8-12,240-324).

The port's own copy of the JAX package's ``driving/scoring.py``, which it may not import.

Pure-function implementation of the roach/leaderboard driving score so
closed-loop evaluation is scoreable without the simulator stack: multiplicative
per-infraction penalties, outside/wrong-lane distance factor, route score
(endless = completed km; fixed route = completion fraction), and
``score_composed = max(route * penalty, 0)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

__all__ = ["PENALTIES", "EpisodeCounters", "episode_stats"]

# leaderboard penalty constants (ego_vehicle_handler.py:8-12)
PENALTIES = {
    "collisions_pedestrian": 0.50,
    "collisions_vehicle": 0.60,
    "collisions_layout": 0.65,
    "red_light": 0.70,
    "stop_infraction": 0.80,
}


@dataclass
class EpisodeCounters:
    """Infraction events + distances accumulated over an episode."""

    collisions_layout: int = 0
    collisions_vehicle: int = 0
    collisions_pedestrian: int = 0
    collisions_others: int = 0
    red_light: int = 0
    encounter_light: int = 0
    stop_infraction: int = 0
    encounter_stop: int = 0
    route_dev: int = 0
    vehicle_blocked: int = 0
    outside_lane_m: float = 0.0
    wrong_lane_m: float = 0.0


def episode_stats(
    counters: EpisodeCounters,
    route_length_m: float,
    route_completed_m: float,
    is_route_completed: bool,
    endless: bool = False,
    timeout: bool = False,
    episode_length: int = 0,
    total_reward: float = 0.0,
) -> Dict[str, float]:
    """Compute the per-episode stat dict (ego_vehicle_handler.py:240-321)."""
    total_km = max(route_length_m / 1000.0, 0.001)
    completed_km = max(route_completed_m / 1000.0, 0.001)
    outside_km = counters.outside_lane_m / 1000.0
    wrong_km = counters.wrong_lane_m / 1000.0

    if endless:
        score_route = completed_km
    else:
        # the reference feeds traced road lengths for both terms so the ratio
        # is naturally <= 1 (ego_vehicle_handler.py:240-262); clamp here
        # because our completed_m can be odometry over a lower-bound length
        score_route = 1.0 if is_route_completed else min(1.0, completed_km / total_km)

    score_penalty = (
        1.0
        * (1 - (outside_km + wrong_km) / completed_km)
        * (PENALTIES["collisions_layout"] ** counters.collisions_layout)
        * (PENALTIES["collisions_vehicle"] ** counters.collisions_vehicle)
        * (PENALTIES["collisions_pedestrian"] ** counters.collisions_pedestrian)
        * (PENALTIES["red_light"] ** counters.red_light)
        * (PENALTIES["stop_infraction"] ** counters.stop_infraction)
    )
    n_collisions = (
        counters.collisions_layout
        + counters.collisions_vehicle
        + counters.collisions_pedestrian
        + counters.collisions_others
    )
    return {
        "score_route": score_route,
        "score_penalty": score_penalty,
        "score_composed": max(score_route * score_penalty, 0.0),
        "length": episode_length,
        "reward": total_reward,
        "timeout": float(timeout),
        "is_route_completed": float(is_route_completed),
        "is_route_completed_nocrash": float(is_route_completed and n_collisions == 0),
        "route_completed_in_km": completed_km,
        "route_length_in_km": total_km,
        "percentage_outside_lane": outside_km / completed_km,
        "percentage_wrong_lane": wrong_km / completed_km,
        "collisions_layout": counters.collisions_layout / completed_km,
        "collisions_vehicle": counters.collisions_vehicle / completed_km,
        "collisions_pedestrian": counters.collisions_pedestrian / completed_km,
        "collisions_others": counters.collisions_others / completed_km,
        "red_light": counters.red_light / completed_km,
        "light_passed": counters.encounter_light - counters.red_light,
        "encounter_light": counters.encounter_light,
        "stop_infraction": counters.stop_infraction / completed_km,
        "stop_passed": counters.encounter_stop - counters.stop_infraction,
        "encounter_stop": counters.encounter_stop,
        "route_dev": counters.route_dev / completed_km,
        "vehicle_blocked": counters.vehicle_blocked / completed_km,
    }
