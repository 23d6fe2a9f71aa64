"""Expert local planner (the data-collection autopilot's control core).

The port's own copy of the JAX package's ``sim/expert.py``, which it may not import.

Pure re-design of the roach scripted expert (reference:
carla_gym/core/task_actor/scenario_actor/agents/utils/local_planner.py:23-82
and controller.py:4-30): command-aware target-waypoint selection with 7.5/5 m
thresholds, lateral PID on the arctan2 heading error, longitudinal PID on the
speed delta, window-30 PID with dt = 0.1 s. NOTE the reference's 0.75x "turn"
slowdown actually applies on EVERY step (an Enum-vs-int comparison that never
matches, local_planner.py:70-71) — reproduced by default, see LocalPlanner.
Hazard gating (vehicle/walker/red light -> full brake) lives in
``sim.reward.lbc_hazard_*``; TaskVehicle equivalents compose the two
(reference: task_vehicle.py:303-328).
"""

from __future__ import annotations

from collections import deque
from enum import Enum
from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["RoadOption", "ExpertPID", "LocalPlanner", "expert_control"]


class RoadOption(Enum):
    VOID = -1
    LEFT = 1
    RIGHT = 2
    STRAIGHT = 3
    LANEFOLLOW = 4
    CHANGELANELEFT = 5
    CHANGELANERIGHT = 6


class ExpertPID:
    """Window PID with dt-scaled integral/derivative (reference controller.py:4-30)."""

    def __init__(self, pid_list, n=30, dt=0.1):
        self._K_P, self._K_I, self._K_D = pid_list
        self._dt = dt
        self._window = deque(maxlen=n)

    def reset(self):
        self._window.clear()

    def step(self, error):
        self._window.append(error)
        if len(self._window) >= 2:
            integral = sum(self._window) * self._dt
            derivative = (self._window[-1] - self._window[-2]) / self._dt
        else:
            integral = 0.0
            derivative = 0.0
        return self._K_P * error + self._K_I * integral + self._K_D * derivative


def _loc_global_to_ref(target_xy, ref_xy, ref_yaw_deg):
    """World -> actor frame (carla_gym/utils/transforms.py loc_global_to_ref)."""
    delta = np.asarray(target_xy, np.float64) - np.asarray(ref_xy, np.float64)
    yaw = np.deg2rad(ref_yaw_deg)
    c, s = np.cos(-yaw), np.sin(-yaw)
    return np.array([c * delta[0] - s * delta[1], s * delta[0] + c * delta[1]])


class LocalPlanner:
    def __init__(
        self,
        target_speed=0.0,
        longitudinal_pid_params=(0.5, 0.025, 0.1),
        lateral_pid_params=(0.75, 0.05, 0.0),
        threshold_before=7.5,
        threshold_after=5.0,
        strict_reference=True,
    ):
        self._target_speed = target_speed
        self._speed_pid = ExpertPID(longitudinal_pid_params)
        self._turn_pid = ExpertPID(lateral_pid_params)
        self._threshold_before = threshold_before
        self._threshold_after = threshold_after
        self._max_skip = 20
        self._last_command = 4
        # The reference compares the target_command ROADOPTION ENUM against
        # the int list [3, 4] (local_planner.py:70-71) — a plain Enum never
        # equals an int, so its expert applies the 0.75 "turn" slowdown on
        # EVERY step, i.e. actually drives at 0.75 * target_speed always.
        # The published dataset was collected that way, so strict mode
        # (default) reproduces it; strict_reference=False gives the
        # evidently-intended turns-only slowdown (PARITY.md).
        self._strict_reference = strict_reference

    def run_step(
        self,
        route_plan: Sequence[Tuple[Tuple[float, float], int]],
        actor_xy,
        actor_yaw_deg: float,
        actor_speed: float,
    ):
        """route_plan: [((x, y), command_value)] world-frame waypoints."""
        actor_xy = np.asarray(actor_xy, np.float64)
        target_index = -1
        for i, (wp_xy, cmd) in enumerate(route_plan[: self._max_skip]):
            threshold = (
                self._threshold_before
                if self._last_command == 4 and cmd != 4
                else self._threshold_after
            )
            if np.linalg.norm(np.asarray(wp_xy) - actor_xy) < threshold:
                self._last_command = cmd
                target_index = i

        if target_index < len(route_plan) - 1:
            target_index += 1
        target_xy, target_command = route_plan[target_index]

        local = _loc_global_to_ref(target_xy, actor_xy, actor_yaw_deg)
        theta = np.arctan2(local[1], local[0])
        steer = self._turn_pid.step(theta)

        target_speed = self._target_speed
        if self._strict_reference or target_command not in (3, 4):
            target_speed *= 0.75
        throttle = self._speed_pid.step(target_speed - actor_speed)

        return float(np.clip(throttle, 0.0, 1.0)), float(np.clip(steer, -1.0, 1.0)), 0.0


def expert_control(
    planner: LocalPlanner,
    route_plan,
    actor_xy,
    actor_yaw_deg,
    actor_speed,
    hazard: bool = False,
):
    """Hazard gate -> full brake, else the local planner
    (reference: task_vehicle.py:303-328)."""
    if hazard:
        return 0.0, 0.0, 1.0
    return planner.run_step(route_plan, actor_xy, actor_yaw_deg, actor_speed)
