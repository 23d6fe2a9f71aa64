"""Episode termination logic (reference: ego_vehicle/terminal/valeo_no_det_px.py:21-140).

The port's own copy of the JAX package's ``sim/terminal.py``, which it may not import.

Pure-state re-design of the roach "valeo" terminal handler: done on
blocked / red-light / collision / (eval) timeout, terminal reward
-1 - speed on infractions, and the exploration-suggestion hints used by RL
training. Lateral-distance and leave-target conditions are computed (with the
reference's hysteresis) but, as in the reference, commented out of ``done``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["ValeoTerminal", "ValeoStuckTerminal", "LeaderboardTerminal", "LeaderboardDaggerTerminal"]


class ValeoTerminal:
    def __init__(self, exploration_suggest: bool = True, eval_mode: bool = False,
                 eval_time: float = 1200.0):
        self._exploration_suggest = exploration_suggest
        self._eval_mode = eval_mode
        self._eval_time = eval_time
        self._last_lat_dist = 0.0
        self._min_thresh_lat_dist = 3.5
        self._prev_next_waypoint = None
        self._prev_distance = None

    def get(
        self,
        sim_time: float,
        ev_loc,
        ev_speed: float,
        wp_loc,
        wp_yaw: float,
        next_waypoint_loc,
        info_blocked: Optional[dict],
        info_run_red_light: Optional[dict],
        info_collision: Optional[dict],
        info_run_stop_sign: Optional[dict],
        collision_px: bool = False,
    ) -> Tuple[bool, bool, float, Dict]:
        c_blocked = info_blocked is not None

        # lateral distance with growth hysteresis (valeo_no_det_px.py:25-41)
        d_vec = np.asarray(ev_loc, np.float64)[:2] - np.asarray(wp_loc, np.float64)[:2]
        yaw_rad = np.deg2rad(wp_yaw)
        wp_unit_right = np.array([-np.sin(yaw_rad), np.cos(yaw_rad)])
        lat_dist = abs(float(np.dot(wp_unit_right, d_vec)))
        if lat_dist - self._last_lat_dist > 0.8:
            thresh_lat_dist = lat_dist + 0.5
        else:
            thresh_lat_dist = max(self._min_thresh_lat_dist, self._last_lat_dist)
        c_lat_dist = lat_dist > thresh_lat_dist + 1e-2
        self._last_lat_dist = lat_dist

        c_run_rl = info_run_red_light is not None
        c_collision = info_collision is not None
        c_run_stop = (
            info_run_stop_sign is not None and info_run_stop_sign.get("event") == "run"
        )
        c_collision_px = False if self._eval_mode else collision_px

        # leave-target detection (valeo_no_det_px.py:62-82) — tracked, unused in done
        c_leave_target = False
        nwp = np.asarray(next_waypoint_loc, np.float64)[:2]
        d_next = float(np.linalg.norm(nwp - np.asarray(ev_loc, np.float64)[:2]))
        if self._prev_next_waypoint is None:
            self._prev_next_waypoint = nwp
            self._prev_distance = d_next
        else:
            if np.allclose(self._prev_next_waypoint, nwp):
                if d_next > self._prev_distance + 0.1:
                    c_leave_target = True
                    self._prev_next_waypoint = None
                    self._prev_distance = None
                else:
                    self._prev_distance = d_next
            else:
                self._prev_next_waypoint = nwp
                self._prev_distance = d_next

        timeout = self._eval_mode and sim_time > self._eval_time

        # done mask matches the reference exactly (lat_dist/run_stop/leave_target
        # commented out upstream, valeo_no_det_px.py:92-100)
        done = c_blocked or c_run_rl or c_collision or c_collision_px or timeout

        terminal_reward = -1.0 if done else 0.0
        if c_run_rl or c_collision or c_run_stop or c_collision_px:
            terminal_reward -= ev_speed
        if c_leave_target:
            terminal_reward -= d_next

        exploration_suggest = {"n_steps": 0, "suggest": ("", "")}
        if self._exploration_suggest:
            if c_blocked:
                exploration_suggest = {"n_steps": 100, "suggest": ("go", "")}
            if c_lat_dist:
                exploration_suggest = {"n_steps": 100, "suggest": ("go", "turn")}
            if c_run_rl or c_collision or c_run_stop or c_collision_px:
                exploration_suggest = {"n_steps": 100, "suggest": ("stop", "")}

        debug = {
            "c_blocked": c_blocked,
            "c_lat_dist": c_lat_dist,
            "c_run_rl": c_run_rl,
            "c_collision": c_collision,
            "c_run_stop": c_run_stop,
            "c_leave_target": c_leave_target,
            "lat_dist": lat_dist,
            "exploration_suggest": exploration_suggest,
        }
        return done, timeout, terminal_reward, debug


class LeaderboardTerminal:
    """Leaderboard-eval terminal: done on route completion / blocked / route
    deviation / optional max-time (reference: ego_vehicle/terminal/
    leaderboard.py:1-36). Terminal reward is always 0."""

    def __init__(self, max_time: Optional[float] = None):
        self._max_time = max_time

    def get(self, sim_time: float, is_route_completed: bool,
            info_blocked: Optional[dict], info_route_deviation: Optional[dict]):
        c_blocked = info_blocked is not None
        c_dev = info_route_deviation is not None
        timeout = self._max_time is not None and sim_time > self._max_time
        done = bool(is_route_completed) or c_blocked or c_dev or timeout
        debug = {"blocked": c_blocked, "route_deviation": c_dev}
        return done, timeout, 0.0, debug


class LeaderboardDaggerTerminal:
    """DAgger collection terminal: done on blocked / deviation / (gated)
    collision / red-light / stop-sign run / max-time (reference:
    leaderboard_dagger.py:1-67)."""

    def __init__(self, no_collision: bool = True, no_run_rl: bool = True,
                 no_run_stop: bool = True, max_time: float = 300.0):
        self._no_collision = no_collision
        self._no_run_rl = no_run_rl
        self._no_run_stop = no_run_stop
        self._max_time = max_time

    def get(self, sim_time: float, info_blocked, info_route_deviation,
            info_collision, info_run_red_light, info_run_stop_sign):
        c_blocked = info_blocked is not None
        c_dev = info_route_deviation is not None
        c_col = info_collision is not None and self._no_collision
        c_rl = info_run_red_light is not None and self._no_run_rl
        c_stop = (
            info_run_stop_sign is not None
            and info_run_stop_sign.get("event") == "run"
            and self._no_run_stop
        )
        timeout = sim_time > self._max_time
        done = c_blocked or c_dev or c_col or c_rl or c_stop or timeout
        debug = {
            "traffic_rule_violated": c_col or c_rl or c_stop,
            "blocked": c_blocked,
            "route_deviation": c_dev,
        }
        return done, timeout, 0.0, debug


class ValeoStuckTerminal:
    """The "valeo" RL terminal variant: replaces the 90 s Blocked criterion
    with a 100-tick free-road stuck counter over a 10-tick speed window
    (reference: ego_vehicle/terminal/valeo.py:13-170); same lat-dist
    hysteresis, infraction dones, and exploration suggestions."""

    def __init__(self, exploration_suggest: bool = True, eval_mode: bool = False,
                 eval_time: float = 1200.0, stuck_steps: int = 100):
        self._exploration_suggest = exploration_suggest
        self._eval_mode = eval_mode
        self._eval_time = eval_time
        self._stuck_steps = stuck_steps
        self._stuck_counter = 0
        self._speed_queue: list = []
        self._last_lat_dist = 0.0
        self._min_thresh_lat_dist = 3.5

    def get(
        self,
        sim_time: float,
        ev_loc,
        ev_speed: float,
        wp_loc,
        wp_yaw: float,
        is_free_road: bool,
        info_blocked,
        info_run_red_light,
        info_collision,
        info_run_stop_sign,
    ):
        self._speed_queue.append(float(ev_speed))
        if len(self._speed_queue) > 10:
            self._speed_queue.pop(0)
        mean_speed = float(np.mean(self._speed_queue))
        if is_free_road and mean_speed < 1.0:
            self._stuck_counter += 1
        if mean_speed >= 1.0:
            self._stuck_counter = 0
        c_stuck = self._stuck_counter >= self._stuck_steps

        d_vec = np.asarray(ev_loc, np.float64)[:2] - np.asarray(wp_loc, np.float64)[:2]
        yaw_rad = np.deg2rad(wp_yaw)
        wp_unit_right = np.array([-np.sin(yaw_rad), np.cos(yaw_rad)])
        lat_dist = abs(float(np.dot(wp_unit_right, d_vec)))
        if lat_dist - self._last_lat_dist > 0.8:
            thresh = lat_dist + 0.5
        else:
            thresh = max(self._min_thresh_lat_dist, self._last_lat_dist)
        c_lat = lat_dist > thresh + 1e-2
        self._last_lat_dist = lat_dist

        c_rl = info_run_red_light is not None
        c_col = info_collision is not None
        c_stop = (
            info_run_stop_sign is not None
            and info_run_stop_sign.get("event") == "run"
        )
        c_blocked = info_blocked is not None
        timeout = self._eval_mode and sim_time > self._eval_time
        done = c_stuck or c_lat or c_rl or c_col or c_stop or c_blocked or timeout

        terminal_reward = -1.0 if done else 0.0
        if c_rl or c_col or c_stop:
            terminal_reward -= ev_speed

        exploration_suggest = {"n_steps": 0, "suggest": ("", "")}
        if self._exploration_suggest:
            if c_stuck or c_blocked:
                exploration_suggest = {"n_steps": 100, "suggest": ("go", "")}
            if c_lat:
                exploration_suggest = {"n_steps": 100, "suggest": ("", "turn")}
            if c_rl or c_col or c_stop:
                exploration_suggest = {"n_steps": 100, "suggest": ("stop", "")}

        debug = {
            "c_stuck": c_stuck,
            "c_lat_dist": c_lat,
            "stuck_counter": self._stuck_counter,
            "lat_dist": lat_dist,
            "exploration_suggest": exploration_suggest,
        }
        return done, timeout, terminal_reward, debug
