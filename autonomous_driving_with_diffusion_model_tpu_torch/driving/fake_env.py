"""Synthetic/replay driving environment for closed-loop tests without CARLA.

The port's own copy of the JAX package's ``driving/fake_env.py``, which it may not import.

The reference has no test double — its only envs are the live CARLA gym
wrapper (carla_gym) and the leaderboard harness (SURVEY.md §4 consequence).
This fake env speaks the same observation dict the RlCameraWrapper emits
(reference: env_agents/rl_camera/utils/rl_camera_wrapper.py:213-265) and
integrates simple unicycle kinematics so agent logic is testable end-to-end.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

__all__ = ["FakeDrivingEnv", "ReplayEnv"]


class FakeDrivingEnv:
    """Unicycle-kinematics env emitting RlCameraWrapper-style observations."""

    def __init__(
        self,
        route: Optional[np.ndarray] = None,
        image_hw=(256, 900),
        bev_hw=(512, 512),
        dt: float = 0.1,
        seed: int = 0,
        image_fn=None,
    ):
        """``image_fn(env) -> (H, W, 3) uint8`` replaces the default random
        camera frame — lets tests/learnability render state-consistent
        imagery the model can actually condition on."""
        self.rng = np.random.default_rng(seed)
        self.dt = dt
        self.image_hw = image_hw
        self.bev_hw = bev_hw
        self.image_fn = image_fn
        if route is None:
            # straight route heading +x, waypoints every 2 m
            route = np.stack([np.arange(0.0, 200.0, 2.0), np.zeros(100)], axis=-1)
        self.route = route
        self.reset()

    def _next_point(self, min_dist: float) -> np.ndarray:
        """First route point at least ``min_dist`` ahead of the ego's route
        progress. Progress is a monotonic index (advanced while the next
        point is no farther than the current one) — a raw ``dist > thresh``
        scan would select route[0] again once the ego passes it by more than
        the threshold, steering consumers back toward the origin."""
        while self._route_i + 1 < len(self.route) and (
            np.linalg.norm(self.route[self._route_i + 1] - self.pos)
            <= np.linalg.norm(self.route[self._route_i] - self.pos)
        ):
            self._route_i += 1
        j = self._route_i
        while (
            j < len(self.route) - 1
            and np.linalg.norm(self.route[j] - self.pos) <= min_dist
        ):
            j += 1
        return self.route[j]

    def _obs(self) -> Dict:
        h, w = self.image_hw
        bh, bw = self.bev_hw
        nxt = self._next_point(4.0)
        camera = (
            self.image_fn(self)
            if self.image_fn is not None
            else self.rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        )
        return {
            "camera": [camera],
            "bev": [self.rng.integers(0, 255, (bh, bw, 3), dtype=np.uint8)],
            "compass": [[self.yaw]],
            "cur_waypoint": np.asarray([self.pos]),
            "next_waypoint": np.asarray([nxt]),
            "next_command": [4],  # LANEFOLLOW
            "state": [[self.yaw, self.speed, self.throttle, self.steer, self.brake]],
            "at_red_light": [0],
        }

    def snapshot(self) -> Dict:
        """Full dynamics + RNG state, for counterfactual rollouts: execute a
        candidate plan open-loop from here, then ``restore`` and try another
        (the learned-scorer outcome labeling in learnability.py). The CARLA
        env has no such facility — this is the test double's superpower."""
        return {
            "pos": self.pos.copy(),
            "yaw": self.yaw,
            "speed": self.speed,
            "throttle": self.throttle,
            "steer": self.steer,
            "brake": self.brake,
            "steps": self.steps,
            "route_i": self._route_i,
            "rng": self.rng.bit_generator.state,
        }

    def restore(self, snap: Dict) -> None:
        """Rewind to a ``snapshot`` (inverse of it, including RNG state)."""
        self.pos = snap["pos"].copy()
        self.yaw = snap["yaw"]
        self.speed = snap["speed"]
        self.throttle = snap["throttle"]
        self.steer = snap["steer"]
        self.brake = snap["brake"]
        self.steps = snap["steps"]
        self._route_i = snap["route_i"]
        self.rng.bit_generator.state = snap["rng"]

    def reset(self) -> Dict:
        self.pos = self.route[0].astype(np.float64).copy()
        self.yaw = 0.0
        self.speed = 0.0
        self.throttle = 0.0
        self.steer = 0.0
        self.brake = 0.0
        self.steps = 0
        self._route_i = 0
        return self._obs()

    def step(self, control_dict: Dict[int, np.ndarray]):
        control = control_dict[0]
        if control is None:
            # expert autopilot (the collector passes None; reference routes it
            # to TaskVehicle.get_control_to_target): steer toward the next
            # route point, cruise at ~5 m/s
            nxt = self._next_point(3.0)
            heading = np.arctan2(nxt[1] - self.pos[1], nxt[0] - self.pos[0])
            err = (heading - self.yaw + np.pi) % (2 * np.pi) - np.pi
            control = np.array([0.6 if self.speed < 5.0 else 0.0, np.clip(err, -1, 1), 0.0])
        control = np.asarray(control, np.float64)
        throttle, steer, brake = control[0], control[1], control[2]
        self.throttle, self.steer, self.brake = throttle, steer, brake
        accel = 4.0 * np.clip(throttle, 0, 1) - 8.0 * np.clip(brake, 0, 1) - 0.2 * self.speed
        self.speed = max(0.0, self.speed + accel * self.dt)
        self.yaw += np.clip(steer, -1, 1) * self.speed * 0.2 * self.dt
        self.pos = self.pos + self.speed * self.dt * np.array(
            [np.cos(self.yaw), np.sin(self.yaw)]
        )
        self.steps += 1
        done = bool(np.linalg.norm(self.pos - self.route[-1]) < 2.0)
        return self._obs(), 0.0, done, {}


class ReplayEnv:
    """Replays recorded observations; controls are logged, not applied."""

    def __init__(self, observations: List[Dict]):
        self.observations = observations
        self.controls: List = []
        self._i = 0

    def reset(self) -> Dict:
        self._i = 0
        return self.observations[0]

    def step(self, control_dict):
        self.controls.append(control_dict)
        self._i = min(self._i + 1, len(self.observations) - 1)
        done = self._i >= len(self.observations) - 1
        return self.observations[self._i], 0.0, done, {}
