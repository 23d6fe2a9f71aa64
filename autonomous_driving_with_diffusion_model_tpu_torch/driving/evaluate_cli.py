"""Benchmark-suite evaluation CLI (counterpart of the JAX package's
``driving/evaluate_cli.py``).

Runs the port's diffusion agent closed-loop over a registered suite's routes
(NoCrash/CoRL2017/LeaderBoard/Endless) with the native CARLA env
(``sim/carla_env.py``), full infraction counting, and writes the leaderboard
``_checkpoint`` JSON (resumable) through ``driving.evaluator``:

    python -m autonomous_driving_with_diffusion_model_tpu_torch.driving.evaluate_cli \
        --env-id NoCrash-v0 --carla-map Town01 --weather-group train_eval \
        --config configs/guidance/free_guidance.yaml \
        --checkpoint-json /tmp/eval/ckpt.json

The planner runs on the card unless ``--device cpu`` is given. ``--host`` and
``--port`` name the CARLA server; ``--fake-env`` swaps in the synthetic env
(plumbing smoke without CARLA). Aggregate scores print via
``driving.statistics`` at the end.
"""

from __future__ import annotations

import argparse
import json

__all__ = ["main", "build_routes", "console_main"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--env-id", default="Endless-v0")
    p.add_argument("--host", default="localhost")
    p.add_argument("--port", default=2000, type=int)
    p.add_argument("--carla-map", default="Town01")
    p.add_argument("--weather-group", default="simple")
    p.add_argument("--route-description", default="lbc")
    p.add_argument("--routes-group", default=None)
    p.add_argument(
        "--scenarios-json", default=None,
        help="published per-town scenario annotations (e.g. "
             "all_towns_traffic_scenarios.json): the native env injects "
             "adversarial scenarios at route trigger points "
             "(sim/scenario_injection.py); also honored via ADM_SCENARIOS_JSON",
    )
    p.add_argument("--config", default=None, help="agent config yaml")
    p.add_argument("--agent-ckpt", default=None, help="model checkpoint (.pth)")
    p.add_argument("--checkpoint-json", required=True, help="_checkpoint output path")
    p.add_argument("--max-steps", default=3000, type=int)
    p.add_argument("--step-timeout", default=None, type=float)
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--fake-env", action="store_true")
    p.add_argument("--device", default=None, help="torch device of the planner (default: the card)")
    p.add_argument("--opts", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def build_routes(env_id: str, tasks) -> list:
    """One evaluator route per suite task, index-aligned with the env's task
    rotation (CarlaDrivingEnv cycles tasks per reset)."""
    import numpy as np

    routes = []
    for i, task in enumerate(tasks):
        route = {
            "id": f"{env_id}/{i:03d}_r{task['route_id']}_{task['weather']}",
            "index": i,
            # endless tasks have no route target: a step-capped partial stays
            # "Completed" instead of the leaderboard's "Failed" (evaluator.py).
            # Default mirrors CarlaDrivingEnv: no ego_route => endless.
            "endless": bool(task.get("endless", not task.get("ego_route"))),
        }
        ego_route = task.get("ego_route") or []
        if len(ego_route) >= 2:
            # straight-line lower bound on route length (the traced road
            # length replaces it once the env has planned; this keeps
            # score_route honest when an episode crashes before tracing)
            pts = np.array([[t.x, t.y] for t in ego_route], np.float64)
            route["length_m"] = float(
                np.sum(np.linalg.norm(np.diff(pts, axis=0), axis=1))
            )
        routes.append(route)
    return routes


def main(argv=None) -> dict:
    args = parse_args(argv)

    from ..sim.suites import build_suite_tasks
    from ..utils.config import create_cfg, merge_possible_with_base
    from .evaluator import RouteEvaluator
    from .interact_agent import InteractAgent
    from .plan import DiffusionPlanner

    cfg = create_cfg()
    if args.config:
        merge_possible_with_base(cfg, args.config)
    if args.opts:
        cfg.merge_from_list(args.opts)
    if args.agent_ckpt:
        cfg.EVAL.CHECKPOINT = args.agent_ckpt

    tasks = build_suite_tasks(
        args.env_id,
        carla_map=args.carla_map,
        weather_group=args.weather_group,
        route_description=args.route_description,
        routes_group=args.routes_group,
        scenarios_json=args.scenarios_json,
    )
    routes = build_routes(args.env_id, tasks)

    if args.fake_env:
        from .fake_env import FakeDrivingEnv

        def env_factory(route):
            return FakeDrivingEnv(seed=route["index"])

        counters_fn = None
        route_length_fn = None
        env_kind = "fake"
    else:
        from ..sim.carla_env import CarlaDrivingEnv

        env = CarlaDrivingEnv(
            host=args.host,
            port=args.port,
            town=args.carla_map,
            eval_mode=True,
            tasks=tasks,
        )

        def env_factory(route):
            # align the env's task rotation with the (resume-skipped) route
            env._task_idx = route["index"] - 1
            return env

        def counters_fn(e):
            return e.counters

        def route_length_fn(e):
            return e._route_length_m()

        env_kind = "carla"

    planner = DiffusionPlanner(cfg, device=args.device)  # built once across all routes

    def agent_factory():
        return InteractAgent(cfg, env=None, planner=planner)

    evaluator = RouteEvaluator(
        agent_factory=agent_factory,
        env_factory=env_factory,
        routes=routes,
        checkpoint_path=args.checkpoint_json,
        max_steps_per_route=args.max_steps,
        counters_fn=counters_fn,
        step_timeout=args.step_timeout,
        route_length_fn=route_length_fn,
        env_kind=env_kind,
    )
    data = evaluator.run(resume=not args.no_resume)

    from .statistics import aggregate

    stats = aggregate(data)
    print(json.dumps(stats, indent=2, default=float))
    return data


def console_main(argv=None) -> int:
    """Entry point for a console script: ``main`` returns the route records
    for library callers, which a generated ``sys.exit(main())`` wrapper would
    misread as a failing exit status."""
    main(argv)
    return 0


if __name__ == "__main__":
    main()
