"""Interactive closed-loop driving CLI (counterpart of the repo root's
``interact.py``; reference: interact.py:324-334).

Usage:
    python -m autonomous_driving_with_diffusion_model_tpu_torch.interact \
        --config configs/guidance/free_guidance.yaml --fake-env --max-steps 100 \
        [--device cpu] [--pipelined] [--save-bev-path out/] \
        [--opts EVAL.CHECKPOINT final.pth ...]

The planner runs on the card unless ``--device cpu`` is given. ``--fake-env``
drives the synthetic kinematics env; the port has no CARLA env yet, so
without it ``main`` raises. The reference's CARLA-only flags
(``--env-factory``, ``--town``, ``--plot-on-world``) come with that env.
"""

import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=None, type=str)
    parser.add_argument("--save-bev-path", default=None, type=str)
    parser.add_argument(
        "--pipelined", default=False, action="store_true",
        help="act on the previous frame's plan while a worker thread plans "
             "this frame's (one frame of staleness)",
    )
    parser.add_argument("--seed", default=None, type=int)
    parser.add_argument("--fake-env", default=False, action="store_true")
    parser.add_argument("--max-steps", default=None, type=int)
    parser.add_argument("--device", default=None, type=str,
                        help="torch device of the planner (default: the card)")
    parser.add_argument("--opts", nargs=argparse.REMAINDER, default=None, type=str)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from autonomous_driving_with_diffusion_model_tpu_torch.driving import (
        DiffusionPlanner,
        InteractAgent,
    )
    from autonomous_driving_with_diffusion_model_tpu_torch.driving.evaluate_cli import NO_CARLA_ENV
    from autonomous_driving_with_diffusion_model_tpu_torch.utils import (
        create_cfg,
        merge_possible_with_base,
    )
    from autonomous_driving_with_diffusion_model_tpu_torch.utils.config import show_config

    if not args.fake_env:
        raise NotImplementedError(NO_CARLA_ENV)
    cfg = create_cfg()
    if args.config is not None:
        merge_possible_with_base(cfg, args.config)
    if args.opts:
        cfg.merge_from_list(args.opts)
    show_config(cfg)

    from autonomous_driving_with_diffusion_model_tpu_torch.driving import FakeDrivingEnv

    env = FakeDrivingEnv(
        image_hw=(cfg.TRAIN.IMAGE_HEIGHT, cfg.TRAIN.IMAGE_WIDTH),
        seed=args.seed or 0,
    )
    planner = DiffusionPlanner(cfg, seed=args.seed or 0, device=args.device)
    agent = InteractAgent(
        cfg, env, planner=planner, bev_save_path=args.save_bev_path,
        pipelined=args.pipelined,
    )
    try:
        steps = agent.run(max_steps=args.max_steps)
    finally:
        # shut the pipelined worker down, drop any in-flight plan
        close = getattr(agent, "close", None)
        if close is not None:
            close()
    print(f"Closed loop finished after {steps} steps")
    return steps


if __name__ == "__main__":
    main()
