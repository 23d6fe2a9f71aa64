"""Data-collection CLI (reference: misc/data_collect.py:16-77,240-255).

The port's own copy of the JAX package's ``sim/collect_cli.py``, which it may not import.

Usage:
    python -m autonomous_driving_with_diffusion_model_tpu_torch.sim.collect_cli \
        --save-path data --save-num 5000 [--save-every-n-frame 2] \
        [--off-screen] [--fake-env]

With a CARLA install this starts the server and collects from the live env via
the expert autopilot; ``--fake-env`` collects from the synthetic kinematics env
(produces loader-compatible datasets for pipeline testing).
"""

from __future__ import annotations

import argparse
import time


def get_random_seed() -> int:
    """Byte-swapped millisecond seed (reference: data_collect.py:36-44)."""
    t = int(time.time() * 1000.0)
    return (
        ((t & 0xFF000000) >> 24)
        + ((t & 0x00FF0000) >> 8)
        + ((t & 0x0000FF00) << 8)
        + ((t & 0x000000FF) << 24)
    )


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Data Collection")
    parser.add_argument("--save-path", default="data", type=str)
    parser.add_argument("--save-num", default=5000, type=int)
    parser.add_argument("--save-every-n-frame", default=2, type=int)
    parser.add_argument("--off-screen", default=False, action="store_true")
    parser.add_argument("--fake-env", default=False, action="store_true")
    parser.add_argument(
        "--env-factory", default="carla_native",
        help="registered env factory for live collection (carla_native, "
             "carla_roach, or a benchmark suite id)",
    )
    parser.add_argument("--town", default=None, type=str)
    parser.add_argument("--max-env-steps", default=None, type=int)
    parser.add_argument("--seed", default=None, type=int)
    parser.add_argument(
        "--port", default=2000, type=int,
        help="CARLA RPC port (shard-parallel collection gives each shard its "
             "own server/port; see collect_loop --num-shards)",
    )
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    seed = args.seed if args.seed is not None else get_random_seed()

    from .collector import DataCollector

    server = None
    if args.fake_env:
        from ..driving.fake_env import FakeDrivingEnv

        env = FakeDrivingEnv(seed=seed % (2**31))
        collector = DataCollector(
            env,
            args.save_path,
            total_to_save=args.save_num,
            save_every_n_frame=args.save_every_n_frame,
        )
    else:
        from .create_agent import create_env, create_server

        env_config = {"factory": args.env_factory, "town": args.town, "port": args.port}
        server = create_server(env_config, off_screen=args.off_screen)
        env = create_env(env_config, seed=seed)
        collector = DataCollector(
            env,
            args.save_path,
            total_to_save=args.save_num,
            save_every_n_frame=args.save_every_n_frame,
        )
    saved = collector.run(max_env_steps=args.max_env_steps)
    if server is not None:
        server.stop()
    print(f"Finished! saved={saved}")
    return saved


if __name__ == "__main__":
    main()
