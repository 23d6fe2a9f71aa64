"""Interactive closed-loop driving CLI (counterpart of the repo root's
``interact.py``; reference: interact.py:324-334).

Usage:
    python -m autonomous_driving_with_diffusion_model_tpu_torch.interact \
        --config configs/guidance/free_guidance.yaml \
        [--device cpu] [--pipelined] [--save-bev-path out/] [--plot-on-world] \
        [--env-factory carla_native] [--town Town01] \
        [--fake-env --max-steps 100] [--opts EVAL.CHECKPOINT final.pth ...]

The planner runs on the card unless ``--device cpu`` is given. With a CARLA
installation (``carla`` package importable + ``CARLA_SH_PATH`` pointing at
CarlaUE4.sh) this starts the server and drives the env that ``--env-factory``
names (``sim/create_agent.py``); ``--fake-env`` runs the same agent against
the synthetic kinematics env on any machine.
"""

import argparse


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=None, type=str)
    parser.add_argument("--save-bev-path", default=None, type=str)
    parser.add_argument(
        "--plot-on-world", default=False, action="store_true",
        help="draw planned waypoints into the live simulator "
             "(reference interact.py:305-312)",
    )
    parser.add_argument(
        "--pipelined", default=False, action="store_true",
        help="act on the previous frame's plan while a worker thread plans "
             "this frame's (one frame of staleness)",
    )
    parser.add_argument("--seed", default=None, type=int)
    parser.add_argument("--fake-env", default=False, action="store_true")
    parser.add_argument(
        "--env-factory", default="carla_native",
        help="registered env factory or suite id (carla_native, carla_roach, "
             "NoCrash-v0..3, CoRL2017-v0..3, LeaderBoard-v0, Endless-v0)",
    )
    parser.add_argument("--town", default=None, type=str)
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
    from autonomous_driving_with_diffusion_model_tpu_torch.utils import (
        create_cfg,
        merge_possible_with_base,
    )
    from autonomous_driving_with_diffusion_model_tpu_torch.utils.config import show_config

    cfg = create_cfg()
    if args.config is not None:
        merge_possible_with_base(cfg, args.config)
    if args.opts:
        cfg.merge_from_list(args.opts)
    show_config(cfg)

    if args.fake_env:
        from autonomous_driving_with_diffusion_model_tpu_torch.driving import FakeDrivingEnv

        env = FakeDrivingEnv(
            image_hw=(cfg.TRAIN.IMAGE_HEIGHT, cfg.TRAIN.IMAGE_WIDTH),
            seed=args.seed or 0,
        )
        server = None
    else:
        try:
            import carla  # noqa: F401
        except ImportError as exc:
            raise SystemExit(
                "No `carla` package available. Install the CARLA client wheel and "
                "set CARLA_SH_PATH, or run with --fake-env for a simulator-free demo."
            ) from exc
        from autonomous_driving_with_diffusion_model_tpu_torch import sim

        env_config = {"factory": args.env_factory, "port": 2000, "town": args.town}
        server = sim.create_server(env_config, off_screen=False)
        env = sim.create_env(env_config, seed=args.seed or 0)

    planner = DiffusionPlanner(cfg, seed=args.seed or 0, device=args.device)
    agent = InteractAgent(
        cfg, env, planner=planner, bev_save_path=args.save_bev_path,
        plot_on_world=args.plot_on_world, pipelined=args.pipelined,
    )
    try:
        steps = agent.run(max_steps=args.max_steps)
    finally:
        # shut the pipelined worker down, drop any in-flight plan
        close = getattr(agent, "close", None)
        if close is not None:
            close()
    print(f"Closed loop finished after {steps} steps")
    if server is not None:
        server.stop()
    return steps


if __name__ == "__main__":
    main()
