"""Waypoint -> vehicle-control PID.

The port's own copy of the JAX package's ``driving/controller.py``, which it may not import.

Converts a planned 2-d waypoint sequence (ego frame, meters) into
(throttle, steer, brake). Numerics must match the reference controller
(reference: control/controller.py:29-76) for closed-loop parity; the
aim-point search and desired-speed estimate are vectorized here. Gains and
thresholds come from cfg.PID / cfg.CONTROL (reference: config.py:67-86).
"""

from __future__ import annotations

import numpy as np

from .pid import PIDController

__all__ = ["Controller"]


def _heading_deg90(vec) -> float:
    """Angle from the +y (forward) axis in units of 90 degrees — the
    reference's ``degrees(pi/2 - atan2(y, x)) / 90`` convention."""
    return float(np.degrees(np.pi / 2 - np.arctan2(vec[1], vec[0])) / 90.0)


class Controller:
    def __init__(self, cfg):
        pid = cfg.PID
        ctl = cfg.CONTROL
        self.turn_controller = PIDController(pid.TURN_KP, pid.TURN_KI, pid.TURN_KD, pid.TURN_N)
        self.speed_controller = PIDController(
            pid.SPEED_KP, pid.SPEED_KI, pid.SPEED_KD, pid.SPEED_N
        )
        self.aim_dist = ctl.AIM_DIST
        self.angle_thresh = ctl.ANGLE_THRESH
        self.dist_thresh = ctl.DIST_THRESH
        self.brake_speed = ctl.BRAKE_SPEED
        self.brake_ratio = ctl.BRAKE_RATIO
        self.clip_delta = ctl.CLIP_DELTA
        self.max_throttle = ctl.MAX_THROTTLE

    def control_pid(self, waypoints, velocity, target):
        """waypoints: (N, 2) ego-frame meters; velocity: scalar m/s;
        target: (2,). Returns (throttle, steer, brake)."""
        wps = np.asarray(waypoints, dtype=np.float64)
        target = np.asarray(target, dtype=np.float64)

        # desired speed: twice the mean consecutive-waypoint spacing
        seg = np.diff(wps, axis=0)
        seg_norms = np.linalg.norm(seg, axis=1)
        desired_speed = float(seg_norms.sum() * 2.0 / len(seg_norms))

        # aim point: the waypoint whose segment midpoint lies closest to
        # AIM_DIST from the ego; ties resolve to the earliest index
        mid_norms = np.linalg.norm((wps[1:] + wps[:-1]) / 2.0, axis=1)
        gap = np.abs(self.aim_dist - mid_norms)
        aim = wps[int(np.argmin(gap))]

        angle = _heading_deg90(aim)
        angle_last = _heading_deg90(wps[-1] - wps[-2])
        angle_target = _heading_deg90(target)

        steer_to_target = abs(angle_target) < abs(angle) or (
            abs(angle_target - angle_last) > self.angle_thresh
            and target[1] < self.dist_thresh
        )
        steer = self.turn_controller.step(angle_target if steer_to_target else angle)
        steer = float(np.clip(steer, -1.0, 1.0))

        speed = float(np.asarray(velocity).reshape(-1)[0])
        brake = bool(
            desired_speed < self.brake_speed or speed / desired_speed > self.brake_ratio
        )

        delta = float(np.clip(desired_speed - speed, 0.0, self.clip_delta))
        throttle = float(np.clip(self.speed_controller.step(delta), 0.0, self.max_throttle))
        return (0.0 if brake else throttle), steer, brake
