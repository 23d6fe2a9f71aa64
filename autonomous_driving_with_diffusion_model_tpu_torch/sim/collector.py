"""Expert-driven dataset collector (reference: misc/data_collect.py:78-237).

The port's own copy of the JAX package's ``sim/collector.py``, which it may not import.

Env-injected re-design of the reference collector: any env with the
RlCameraWrapper observation dict works (live CARLA, or the fake env for
tests). Per sample: buffers ``horizon + 1`` frames every ``save_every_n_frame``
env steps under expert control (``None`` action -> autopilot), then writes

* ``front/{i:06d}.png``   — frame-0 camera image,
* ``bev/{i:06d}.png``     — frame-0 BEV with the GT waypoints painted green,
* ``waypoints/{i:06d}.txt`` — line 0 target point; 16 lines of
  ``[x, y, yaw, speed, throttle, steer, brake]`` where
  ``x = local_y/23.315``, ``y = -local_x/23.315`` in the frame-0 ego frame
  (theta = compass + pi/2), yaw deltas wrapped to (-1, 1), actions taken from
  the NEXT frame (transition i pairs state i with the action leading to i+1).

Red-light special case (data_collect.py:159-166): 16 stationary full-brake
transitions are synthesized and full brake is held while the light stays red;
the stuck light is forced green through the ``force_green_light`` hook.

The JAX collector saves with PIL and paints the waypoints with
``cv2.circle``; this one writes its PNGs with ``data/png.py:write_png`` and
paints each waypoint as the disc ``cv2.circle(img, c, 3, color, -1)`` fills
(``DISC_3``), so it collects where neither library is installed. The decoded
pixels are the same (``tests/test_torch_collect.py``).

It also collects from the port's ``CarlaDrivingEnv``, whose observations
carry the reference wrapper's batch dimension (``next_waypoint`` (1, 1, 2),
the camera (1, H, W, 3)) and whose BEV has none (H, W, 3); the JAX collector
reads both as the fake env lays them out and raises on that env
(``world_to_agent`` unpacks a (1, 2) target). On the fake env both read
the same values.
"""

from __future__ import annotations

import glob
import os
import os.path as osp
from typing import Callable, Optional

import numpy as np

from ..data.png import write_png
from ..utils.constants import MAGIC_NUM

__all__ = ["DataCollector", "world_to_agent", "count_current_saved", "fill_disc"]


def world_to_agent(world_pos, agent_pos, agent_yaw):
    """Rotate a world xy into the agent frame (reference: data_collect.py:96-108)."""
    x, y = world_pos
    x -= agent_pos[0]
    y -= agent_pos[1]
    theta = agent_yaw
    R = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    x, y = R.T.dot(np.array([x, y])).reshape(-1)
    return x, y


def _first_image(images) -> np.ndarray:
    """The first frame of an observation's images: the fake env gives a list
    of one (H, W, C) frame, ``CarlaDrivingEnv`` its camera as (1, H, W, C)
    and its BEV as one (H, W, C) frame with no leading dimension."""
    images = np.asarray(images)
    return images[0] if images.ndim == 4 else images


def count_current_saved(output_dir: str) -> int:
    """Resume point = min count over the three artifact dirs
    (reference: collect_loop.py:7-14, data_collect.py:78-81)."""
    if not os.path.exists(output_dir):
        return 0
    counts = [
        len(glob.glob(osp.join(output_dir, sub, pat)))
        for sub, pat in (("front", "*.png"), ("bev", "*.png"), ("waypoints", "*.txt"))
    ]
    return min(counts)


def _way_point_to_pixel(waypoint: float) -> int:
    return int(256 - waypoint / MAGIC_NUM * 256)


# (dy, dx) of the pixels that OpenCV's filled circle of radius 3 covers
# (cv2.circle with thickness -1 and the default 8-connected line): rows
# dy = +-3 hold only dx = 0, rows +-2 and +-1 dx in [-2, 2], row 0 dx in [-3, 3]
DISC_3 = np.array(
    [(dy, dx) for dy, half in ((-3, 0), (-2, 2), (-1, 2), (0, 3), (1, 2), (2, 2), (3, 0))
     for dx in range(-half, half + 1)],
    np.int64,
)


def fill_disc(img: np.ndarray, center, color=(0, 255, 0)) -> np.ndarray:
    """Paint ``DISC_3`` around ``center`` = (x, y) into ``img`` in place,
    clipped to the image, as ``cv2.circle(img, center, 3, color, -1)`` does;
    channels past ``color``'s get 0, a 2-D image ``color[0]``."""
    h, w = img.shape[:2]
    ys, xs = DISC_3[:, 0] + int(center[1]), DISC_3[:, 1] + int(center[0])
    keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    if img.ndim == 2:
        img[ys[keep], xs[keep]] = color[0]
    else:
        value = np.zeros(img.shape[2], img.dtype)
        n = min(len(color), img.shape[2])
        value[:n] = color[:n]
        img[ys[keep], xs[keep]] = value
    return img


class DataCollector:
    def __init__(
        self,
        env,
        save_root: str,
        total_to_save: int = 5000,
        save_every_n_frame: int = 2,
        horizon: int = 16,
        target_speed: float = 10.0,
        step_to_reset: int = 1000,
        buffer_frames: int = 50,
        force_green_light: Optional[Callable[[], None]] = None,
        is_at_red_light: Optional[Callable[[], bool]] = None,
    ):
        self.env = env
        self.save_root = save_root
        for sub in ("front", "bev", "waypoints"):
            os.makedirs(osp.join(save_root, sub), exist_ok=True)
        self.total_to_save = total_to_save
        self.total_frame_should_pass = horizon
        self.save_every_n_frame = save_every_n_frame
        self.target_speed = target_speed
        self.step_to_reset = step_to_reset
        self.buffer_frames = buffer_frames
        self.force_green_light = force_green_light
        self.is_at_red_light = is_at_red_light
        self.cur_save = count_current_saved(save_root)
        self.magic_number = MAGIC_NUM

    def do_buffer(self, num_buffer: int):
        for _ in range(num_buffer):
            self.env.step({0: None})

    def run(self, max_env_steps: Optional[int] = None) -> int:
        """Collect until ``total_to_save`` samples exist (or max_env_steps)."""
        state = self.env.reset()
        cur_traj = []
        target_bev = None
        init_compass = 0.0
        target_pos = None
        prev_red = False
        count_to_collect = 0
        step_to_reset = 0
        env_steps = 0

        self.do_buffer(self.buffer_frames)

        while self.cur_save < self.total_to_save:
            if max_env_steps is not None and env_steps >= max_env_steps:
                break
            input_control = {0: None} if not prev_red else {0: np.array([0.0, 0.0, 1.0])}
            state, _, done, *_ = self.env.step(input_control)
            env_steps += 1
            cur_pos = np.asarray(state["cur_waypoint"][0], np.float64)
            cur_control = np.asarray(state["state"][0][:5], np.float64).copy()
            cur_control[0] = cur_control[0] / 180.0  # yaw degrees -> [-1, 1]
            cur_control[1] = cur_control[1] / self.target_speed
            camera = _first_image(state["camera"])
            bev = _first_image(state["bev"])

            if done:
                cur_traj.clear()
                count_to_collect = 0
                step_to_reset = 0
                self.do_buffer(self.buffer_frames)
                continue

            if state["at_red_light"][0] == 1 and prev_red:
                continue

            if count_to_collect % self.save_every_n_frame != 0:
                count_to_collect += 1
                continue

            if len(cur_traj) == 0:
                write_png(osp.join(self.save_root, "front", f"{self.cur_save:06d}.png"), camera)
                target_bev = np.copy(bev)
                init_compass = float(np.asarray(state["compass"][0]).reshape(-1)[0])
                target_pos = np.asarray(state["next_waypoint"], np.float64).reshape(-1, 2)[0]

                if state["at_red_light"][0] == 1:
                    # 16 stationary full-brake transitions (data_collect.py:159-166)
                    for _ in range(self.total_frame_should_pass):
                        cur_traj.append(
                            np.concatenate([cur_pos, np.array([0.0, 0.0, 0.0, 0.0, 1.0])])
                        )
                    prev_red = True
                else:
                    prev_red = False

            if len(cur_traj) < self.total_frame_should_pass + 1:
                cur_traj.append(np.concatenate((cur_pos, cur_control)))

            if len(cur_traj) != self.total_frame_should_pass + 1:
                count_to_collect += 1
            else:
                theta = init_compass + np.pi / 2
                added_traj = []
                for idx in range(len(cur_traj) - 1):
                    traj = np.copy(cur_traj[idx][:2])
                    car_state = np.copy(cur_traj[idx][2:4])
                    action = np.copy(cur_traj[idx + 1][-3:])
                    car_state[0] -= cur_traj[0][2]
                    if car_state[0] > 1:
                        car_state[0] -= 1
                    elif car_state[0] < -1:
                        car_state[0] += 1
                    traj = world_to_agent(traj, cur_traj[0][:2], theta)
                    target_bev = fill_disc(
                        target_bev, (_way_point_to_pixel(traj[1]), _way_point_to_pixel(-traj[0]))
                    )
                    added_traj.append(
                        (
                            traj[1] / self.magic_number,
                            -traj[0] / self.magic_number,
                            *car_state.tolist(),
                            *action.tolist(),
                        )
                    )
                target_local = world_to_agent(target_pos, cur_traj[0][:2], theta)
                with open(
                    osp.join(self.save_root, "waypoints", f"{self.cur_save:06d}.txt"), "w"
                ) as f:
                    f.write(
                        f"{target_local[1] / self.magic_number} "
                        f"{-target_local[0] / self.magic_number}\n"
                    )
                    for traj in added_traj:
                        f.write(f"{' '.join(map(str, traj))}\n")
                write_png(osp.join(self.save_root, "bev", f"{self.cur_save:06d}.png"), target_bev)
                cur_traj.clear()
                self.cur_save += 1
                count_to_collect = 0

                if prev_red and self.is_at_red_light is not None and self.is_at_red_light():
                    if self.force_green_light is not None:
                        self.force_green_light()
                    continue

                if step_to_reset > self.step_to_reset:
                    state = self.env.reset()
                    step_to_reset = 0
                self.do_buffer(self.buffer_frames)
            step_to_reset += 1
        return self.cur_save
