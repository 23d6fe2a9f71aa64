"""CARLA Leaderboard-1.0 autonomous agent (counterpart of the JAX package's
``driving/leaderboard_agent.py``; reference: e2e_driving/diffusion_agent.py:44-334).

Implements the leaderboard agent contract — ``setup() / sensors() /
run_step(input_data, timestamp) / set_global_plan() / destroy()`` plus the
module-level ``get_entry_point()`` the evaluator resolves by reflection
(leaderboard_evaluator.py:106-109). The planning core is the port's
``DiffusionPlanner``, on the card unless ``device="cpu"`` is asked for.
``carla`` is imported lazily so the agent logic is testable without the
simulator (a plain namespace stands in for ``VehicleControl``); ``cv2`` and
``PIL`` only where images are saved (``SAVE_PATH``), never on a tick.
"""

from __future__ import annotations

import math
import os
import pathlib
from types import SimpleNamespace

import numpy as np

try:
    from ..utils.config import create_cfg, merge_possible_with_base
    from ..utils.constants import GuidanceType
    from .plan import DiffusionPlanner, way_point_to_pixel
    from .planner import RoutePlanner
except ImportError:
    # the official evaluator imports this FILE by path (run_evaluation.sh
    # AGENT=<path>/leaderboard_agent.py -> importlib.import_module of the
    # bare module name, leaderboard_evaluator.py:106-109), so there is no
    # parent package; fall back to absolute imports (repo root on sys.path)
    import sys as _sys

    _repo = str(pathlib.Path(__file__).resolve().parents[2])
    if _repo not in _sys.path:
        _sys.path.insert(0, _repo)
    from autonomous_driving_with_diffusion_model_tpu_torch.utils.config import (
        create_cfg,
        merge_possible_with_base,
    )
    from autonomous_driving_with_diffusion_model_tpu_torch.utils.constants import GuidanceType
    from autonomous_driving_with_diffusion_model_tpu_torch.driving.plan import (
        DiffusionPlanner,
        way_point_to_pixel,
    )
    from autonomous_driving_with_diffusion_model_tpu_torch.driving.planner import RoutePlanner

__all__ = ["DiffusionAgent", "get_entry_point"]

SAVE_PATH = os.environ.get("SAVE_PATH", None)


def get_entry_point():
    return "DiffusionAgent"


def _vehicle_control(throttle=0.0, steer=0.0, brake=0.0):
    try:
        import carla

        return carla.VehicleControl(
            throttle=float(throttle), steer=float(steer), brake=float(brake)
        )
    except ImportError:
        return SimpleNamespace(throttle=float(throttle), steer=float(steer), brake=float(brake))


def _track_sensors():
    """The harness's Track.SENSORS enum when the vendored leaderboard package
    is importable (AgentWrapper.validate_sensor_configuration compares enum
    identity, agent_wrapper.py:263-271); plain string otherwise."""
    try:
        from leaderboard.autoagents.autonomous_agent import Track

        return Track.SENSORS
    except ImportError:
        return "SENSORS"


def _bgr_to_rgb(image) -> np.ndarray:
    """A BGR or BGRA uint8 image -> contiguous RGB: the same bytes as
    ``cv2.cvtColor(image[:, :, :3], cv2.COLOR_BGR2RGB)``."""
    return np.ascontiguousarray(np.asarray(image)[:, :, 2::-1])


class DiffusionAgent:
    """Track.SENSORS leaderboard agent driven by the diffusion planner.

    Constructor/``__call__`` mirror the harness's AutonomousAgent base
    (autonomous_agent.py:37-121) so the leaderboard evaluator can instantiate
    this class directly by reflection and AgentWrapper can drive it.
    ``device`` places the planner (None: the card, which must be there)."""

    def __init__(self, path_to_conf_file=None, route_index=None, device=None):
        self._global_plan = None
        self._global_plan_world_coord = None
        self.wallclock_t0 = None
        self.device = device
        try:  # harness-provided frame-synced sensor buffer
            from leaderboard.envs.sensor_interface import SensorInterface

            self.sensor_interface = SensorInterface()
        except ImportError:
            self.sensor_interface = None
        self.setup(path_to_conf_file, route_index)

    def __call__(self):
        """Drive one step from the harness sensor interface
        (autonomous_agent.py:101-121)."""
        from srunner.scenariomanager.timer import GameTime

        input_data = self.sensor_interface.get_data()
        timestamp = GameTime.get_time()
        if not self.wallclock_t0:
            self.wallclock_t0 = GameTime.get_wallclocktime()
        control = self.run_step(input_data, timestamp)
        control.manual_gear_shift = False
        return control

    def setup(self, path_to_conf_file, route_index=None):
        self.track = _track_sensors()
        self.step = -1
        self.initialized = False
        cfg = create_cfg()
        if path_to_conf_file:
            merge_possible_with_base(cfg, path_to_conf_file)
        opts = os.environ.get("AGENT_OPTS", "")
        if opts:
            cfg.merge_from_list(opts.split())
        self.cfg = cfg
        self.use_guidance_type = GuidanceType[cfg.GUIDANCE.USE_COND]
        self.planner = DiffusionPlanner(cfg, device=self.device)
        self._global_plan_world_coord = None

        if SAVE_PATH is not None:
            now = "run"
            self.save_path = pathlib.Path(SAVE_PATH) / now
            (self.save_path / "rgb").mkdir(parents=True, exist_ok=True)
            (self.save_path / "bev").mkdir(parents=True, exist_ok=True)
        else:
            self.save_path = None

    def _init(self):
        self._route_planner = RoutePlanner(7.0, 50.0)
        self._route_planner.set_route(self._global_plan_world_coord)
        self.initialized = True

    def sensors(self):
        """Sensor suite (reference: diffusion_agent.py:126-177)."""
        return [
            dict(type="sensor.camera.rgb", x=-1.5, y=0.0, z=2.0, roll=0.0, pitch=0.0,
                 yaw=0.0, width=900, height=256, fov=100, id="rgb"),
            dict(type="sensor.camera.rgb", x=0.0, y=0.0, z=50.0, roll=0.0, pitch=-90.0,
                 yaw=0.0, width=512, height=512, fov=5 * 10.0, id="bev"),
            dict(type="sensor.other.imu", x=0.0, y=0.0, z=0.0, roll=0.0, pitch=0.0,
                 yaw=0.0, sensor_tick=0.05, id="imu"),
            dict(type="sensor.other.gnss", x=0.0, y=0.0, z=0.0, roll=0.0, pitch=0.0,
                 yaw=0.0, sensor_tick=0.01, id="gps"),
            dict(type="sensor.speedometer", reading_frequency=20, id="speed"),
        ]

    def tick(self, input_data):
        """Parse sensors + compute the ego-frame target point
        (reference: diffusion_agent.py:234-268 — including its use of raw GPS
        coordinates against the world-frame route, reproduced verbatim)."""
        self.step += 1
        rgb = _bgr_to_rgb(input_data["rgb"][1])
        bev = _bgr_to_rgb(input_data["bev"][1])
        cur_pos = np.asarray(input_data["gps"][1][:2], np.float64)
        speed = input_data["speed"][1]["speed"]
        compass = input_data["imu"][1][-1]
        if isinstance(compass, (list, np.ndarray)):
            compass = float(np.asarray(compass).reshape(-1)[-1])
        if math.isnan(compass):
            compass = 0.0

        next_wp, next_cmd = self._route_planner.run_step(cur_pos)
        theta = compass + np.pi / 2
        R = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
        local = R.T.dot(np.array([next_wp[0] - cur_pos[0], next_wp[1] - cur_pos[1]]))
        target_point = np.array([local[1], -local[0]]) / self.planner.magic_num

        return {
            "rgb": rgb,
            "bev": bev,
            "cur_pos": cur_pos,
            "speed": speed,
            "compass": compass,
            "next_command": getattr(next_cmd, "value", next_cmd),
            "target_point": target_point,
        }

    def run_step(self, input_data, timestamp):
        if not self.initialized:
            self._init()
        tick_data = self.tick(input_data)
        if self.step < self.cfg.ENV.AGENT_WARMUP:
            return _vehicle_control()

        target_point = None
        if self.use_guidance_type != GuidanceType.NO_GUIDANCE:
            target_point = tick_data["target_point"].astype(np.float32)
        traj = self.planner.plan(tick_data["rgb"], target_point)

        throttle, steer, brake = DiffusionPlanner.post_process_control_leaderboard(
            *[float(v) for v in traj[0, 0, -3:]]
        )
        control = _vehicle_control(throttle, steer, brake)

        if self.save_path is not None and self.step % 10 == 0:
            self._save(tick_data, traj[0, :, :2], target_point)
        return control

    def set_global_plan(self, global_plan_gps, global_plan_world_coord, wp=None):
        self._global_plan_gps = global_plan_gps
        self._global_plan_world_coord = global_plan_world_coord

    def _save(self, tick_data, traj_xy, target_point):
        import cv2
        from PIL import Image

        frame = self.step // 10
        bev = tick_data["bev"]
        if target_point is not None:
            bev = cv2.circle(
                bev,
                (
                    way_point_to_pixel(float(target_point[0]), self.planner.magic_num),
                    way_point_to_pixel(float(target_point[1]), self.planner.magic_num),
                ),
                3,
                (0, 255, 0),
                -1,
            )
        for x, y in traj_xy:
            bev = cv2.circle(
                bev,
                (
                    way_point_to_pixel(float(x), self.planner.magic_num),
                    way_point_to_pixel(float(y), self.planner.magic_num),
                ),
                3,
                (0, 0, 255),
                -1,
            )
        Image.fromarray(tick_data["rgb"]).save(self.save_path / "rgb" / ("%04d.png" % frame))
        Image.fromarray(bev).save(self.save_path / "bev" / ("%04d.png" % frame))

    def destroy(self):
        self.planner = None
