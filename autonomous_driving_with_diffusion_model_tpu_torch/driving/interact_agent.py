"""Interactive closed-loop agent (counterpart of the JAX package's
``driving/interact_agent.py``; reference: interact.py:54-321).

Any object with ``reset() -> obs`` / ``step({0: control}) -> (obs, ...)``
is an env: the synthetic ``FakeDrivingEnv``, a ``ReplayEnv``, or a live
simulator. The planning core is the port's ``DiffusionPlanner``, on the card
unless ``device="cpu"`` is asked for.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ..utils.constants import GuidanceType
from .controller import Controller
from .plan import (
    DiffusionPlanner,
    agent_to_world,
    process_next_waypoint,
    way_point_to_pixel,
)

__all__ = ["InteractAgent"]


class InteractAgent:
    def __init__(
        self,
        cfg,
        env,
        planner: Optional[DiffusionPlanner] = None,
        bev_save_path: Optional[str] = None,
        on_frame: Optional[Callable] = None,
        plot_on_world: bool = False,
        pipelined: bool = False,
        device=None,
    ):
        """``device`` places the planner this agent builds when none is
        given (None: the card, which must be there)."""
        self.cfg = cfg
        self.env = env
        self.planner = planner or DiffusionPlanner(cfg, device=device)
        self.controller = Controller(cfg)
        self.use_guidance_type = GuidanceType[cfg.GUIDANCE.USE_COND]
        self.bev_save_path = bev_save_path
        self.on_frame = on_frame
        # draw the planned waypoints into the live simulator through the
        # env's world.debug surface (reference: interact.py:305-312)
        self.plot_on_world = plot_on_world
        # pipelined planning: act on the PREVIOUS frame's plan while this
        # frame's whole plan (frame upload, the plan's launches on the
        # thread's current stream, which is the default stream, and the
        # download) runs on a one-deep worker thread, at one frame of
        # staleness. Opt-in; no reference analogue.
        self.pipelined = pipelined
        self._pending_plan = None
        self._executor = None
        if pipelined:
            from concurrent.futures import ThreadPoolExecutor

            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="plan_pipeline"
            )
        if bev_save_path:
            import os

            os.makedirs(bev_save_path, exist_ok=True)
        self._count = 0

    def close(self) -> None:
        """Shut down the pipelined worker: drop the in-flight plan reference
        and shut the executor down, so per-route agents (the evaluator builds
        a fresh one per route) don't leak a worker thread or leave an orphan
        plan on the card into the next route's warmup."""
        self._pending_plan = None
        if self._executor is not None:
            self._executor.shutdown(wait=False, cancel_futures=True)
            self._executor = None

    # ------------------------------------------------------------------ step

    def _target_point(self, state):
        if self.use_guidance_type == GuidanceType.NO_GUIDANCE:
            return None
        return process_next_waypoint(
            next_point=np.asarray(state["next_waypoint"]),
            cur_point=np.asarray(state["cur_waypoint"])[0],
            yaw=float(np.asarray(state["compass"][0]).reshape(-1)[0]),
        )[0]

    def warmup(self, state) -> None:
        """Run one plan on a real state without the side effects of
        ``compute_control`` (BEV dumps, frame callbacks): the first plan on
        the card builds the kernels, which the evaluator keeps out of the
        watchdog budget."""
        self.planner.plan(np.asarray(state["camera"][0], np.uint8), self._target_point(state))

    def compute_control(self, state) -> np.ndarray:
        """One closed-loop decision (reference: interact.py:279-307)."""
        target_point = self._target_point(state)
        rgb = np.asarray(state["camera"][0], np.uint8)
        if self.pipelined:
            # control staleness (acting on the previous frame's plan) is the
            # documented pipelining trade-off; the debug overlays below must
            # use the POSE OF THE FRAME THE PLAN WAS MADE FOR, so the state
            # is cached alongside the pending future
            fut = self._executor.submit(self._plan_job, rgb, target_point)
            if self._pending_plan is not None:
                prev_fut, plan_state = self._pending_plan
            else:
                prev_fut, plan_state = fut, state
            traj = prev_fut.result()
            self._pending_plan = (fut, state)
        else:
            traj = self.planner.plan(rgb, target_point)
            plan_state = state

        if self.bev_save_path is not None:
            self._save_bev(np.asarray(plan_state["bev"][0]), traj[0, :, :2])
        if self.plot_on_world:
            self._plot_to_world(plan_state, traj)

        if traj.shape[-1] > 2:
            control = DiffusionPlanner.post_process_control_interact(*traj[0, 0, -3:])
        else:
            # 2-d waypoint model: PID path (interact.py:298-307)
            gt_velocity = float(np.asarray(state["state"][0][1]))
            tp = (
                target_point
                if self.use_guidance_type != GuidanceType.NO_GUIDANCE
                else traj[0, 4, :2]
            )
            renew_traj = np.stack([-traj[0, :4, 0], traj[0, :4, 1]], axis=-1)
            renew_target = np.stack([-tp[0], tp[1]], axis=-1)
            throttle, steer, brake = self.controller.control_pid(
                renew_traj, gt_velocity, renew_target
            )
            control = DiffusionPlanner.post_process_control_interact(throttle, steer, brake)
        if self.on_frame is not None:
            self.on_frame(state, traj, control)
        return control

    def _plan_job(self, rgb, target_point) -> np.ndarray:
        """The worker-thread body of one pipelined plan. ``plan`` holds its
        own ``no_grad`` (and the classifier guidance its own
        ``enable_grad``), both thread-local, so the numbers equal the
        sequential path's (tests/test_torch_agents.py)."""
        return self.planner.plan_fetch(self.planner.plan_begin(rgb, target_point))

    def _plot_to_world(self, state, traj) -> None:
        """Draw the planned waypoints into the simulator (reference:
        interact.py:241-272,305-312 plot_to_world): ego-frame meters ->
        world xy via ``agent_to_world``, rendered as 'x' strings through
        the world's debug interface. No-op for envs without one (fake env)."""
        world = getattr(self.env, "world", None)
        debug = getattr(world, "debug", None)
        if debug is None:
            return
        import carla

        points = agent_to_world(
            traj[0, :, :2],
            float(np.asarray(state["compass"][0]).reshape(-1)[0]),
            np.asarray(state["cur_waypoint"])[0],
        )
        for x, y in points:
            debug.draw_string(
                carla.Location(float(x), float(y), 0.5),
                "x",
                draw_shadow=False,
                color=carla.Color(r=0, g=0, b=255),
                life_time=-1,
                persistent_lines=True,
            )

    def _save_bev(self, bev_image, traj_xy_meters):
        import cv2

        img = bev_image.copy()
        for x, y in traj_xy_meters:
            px = way_point_to_pixel(float(x), self.planner.magic_num)
            py = way_point_to_pixel(float(y), self.planner.magic_num)
            img = cv2.circle(img, (px, py), 3, (0, 0, 255), -1)
        cv2.imwrite(
            f"{self.bev_save_path}/{self._count:06d}.jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
        )
        self._count += 1

    # ------------------------------------------------------------------- run

    def run(self, max_steps: Optional[int] = None) -> int:
        """Closed loop until done/max_steps (the reference loops forever,
        interact.py:276-316 — its ``done`` is never set)."""
        state = self.env.reset()
        self._pending_plan = None  # a fresh episode must not act on a stale plan
        steps = 0
        while True:
            control = self.compute_control(state)
            result = self.env.step({0: control})
            state = result[0]
            done = bool(result[2]) if len(result) > 2 else False
            steps += 1
            if done or (max_steps is not None and steps >= max_steps):
                return steps
