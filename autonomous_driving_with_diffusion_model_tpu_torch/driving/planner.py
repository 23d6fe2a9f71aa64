"""GPS route planner for the leaderboard agent (reference: e2e_driving/planner.py:38-92).

The port's own copy of the JAX package's ``driving/planner.py``, which it may not import.

Maintains a deque of (position, command) route nodes; each step pops waypoints
already passed (within ``min_distance``) and returns the next node.
"""

from __future__ import annotations

from collections import deque

import numpy as np

__all__ = ["RoutePlanner"]


class RoutePlanner:
    def __init__(self, min_distance: float, max_distance: float):
        self.route = deque()
        self.min_distance = min_distance
        self.max_distance = max_distance
        # carla 0.9.10 gps -> meters scale (reference: planner.py:44-45)
        self.mean = np.array([0.0, 0.0])
        self.scale = np.array([111324.60662786, 111319.490945])

    def set_route(self, global_plan_world) -> None:
        """global_plan_world: iterable of (transform-or-(x, y), command)."""
        self.route.clear()
        for pos, cmd in global_plan_world:
            if hasattr(pos, "location"):  # carla.Transform
                pos = np.array([pos.location.x, pos.location.y])
            elif hasattr(pos, "x"):  # carla.Location (what the harness passes)
                pos = np.array([pos.x, pos.y])
            else:
                pos = np.asarray(pos, dtype=np.float64)
            self.route.append((pos, cmd))

    def run_step(self, cur_pos):
        cur_pos = np.asarray(cur_pos, dtype=np.float64)
        if len(self.route) == 1:
            return self.route[0]

        to_pop = 0
        farthest_in_range = -np.inf
        cumulative_distance = 0.0
        for i in range(1, len(self.route)):
            if cumulative_distance > self.max_distance:
                break
            cumulative_distance += np.linalg.norm(self.route[i][0] - self.route[i - 1][0])
            distance = np.linalg.norm(self.route[i][0] - cur_pos)
            if distance <= self.min_distance and distance > farthest_in_range:
                farthest_in_range = distance
                to_pop = i

        for _ in range(to_pop):
            if len(self.route) > 2:
                self.route.popleft()

        return self.route[1]
