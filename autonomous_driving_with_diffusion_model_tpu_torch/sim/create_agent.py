"""Env/server factory (reference: misc/create_agent.py:17-60).

The port's own copy of the JAX package's ``sim/create_agent.py``, which it may not import.

``create_server`` shell-launches the CARLA UE4 binary; ``create_env`` builds
the closed-loop environment. The reference composes a hydra config over the
vendored carla-roach gym stack (carla_gym ``Endless-v0`` + RlCameraWrapper +
SB3 DummyVecEnv); this framework accepts any factory producing an env with the
observation-dict contract (see ``driving.fake_env`` for the schema) so
deployments can plug in carla-roach, a leaner CARLA client, or a replay.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

from .server_utils import CarlaServerManager

__all__ = ["create_server", "create_env", "register_env_factory", "ENV_FACTORIES"]

# name -> callable(env_config, seed) -> env
ENV_FACTORIES = {}


def register_env_factory(name: str):
    def deco(fn: Callable):
        ENV_FACTORIES[name] = fn
        return fn

    return deco


@register_env_factory("fake")
def _fake_env_factory(env_config, seed: int = 0):
    from ..driving.fake_env import FakeDrivingEnv

    return FakeDrivingEnv(seed=seed)


@register_env_factory("carla_native")
def _carla_native_factory(env_config, seed: int = 0):
    """First-party CARLA adapter (sim/carla_env.py) — no carla_gym needed."""
    from .carla_env import CarlaDrivingEnv

    return CarlaDrivingEnv(
        host=env_config.get("host", "localhost"),
        port=env_config.get("port", 2000),
        town=env_config.get("town"),
        target_speed=env_config.get("target_speed", 10.0),
        weather=env_config.get("weather", "ClearNoon"),
        seed=seed,
        eval_mode=env_config.get("eval_mode", False),
    )


def _register_suite_factories():
    """Benchmark env ids (NoCrash-v0..3, CoRL2017-v0..3, LeaderBoard-v0,
    Endless-v0) over the native env + sim.suites task builders
    (reference: carla_gym/__init__.py:9-66)."""
    from .suites import SUITES

    def make(env_id):
        def _factory(env_config, seed: int = 0):
            from .carla_env import CarlaDrivingEnv
            from .suites import build_suite_tasks

            suite_kwargs = dict(env_config.get("suite", {}))
            tasks = build_suite_tasks(env_id, **suite_kwargs)
            return CarlaDrivingEnv(
                host=env_config.get("host", "localhost"),
                port=env_config.get("port", 2000),
                town=env_config.get("town", suite_kwargs.get("carla_map")),
                seed=seed,
                eval_mode=env_config.get("eval_mode", env_id != "Endless-v0"),
                tasks=tasks,
            )

        return _factory

    for env_id in SUITES:
        ENV_FACTORIES[env_id] = make(env_id)


_register_suite_factories()


@register_env_factory("carla_roach")
def _carla_roach_factory(env_config, seed: int = 0):
    """The reference stack: requires the carla package + a carla_gym install
    (the vendored carla-roach environment, reference carla_gym/__init__.py:9-66)."""
    try:
        import carla  # noqa: F401
        import carla_gym  # noqa: F401
        import gymnasium as gym
    except ImportError as exc:
        raise ImportError(
            "carla_roach env needs the `carla` client wheel and a `carla_gym` "
            "package on PYTHONPATH (the reference's vendored carla-roach env)."
        ) from exc
    env = gym.make(
        env_config.get("env_id", "Endless-v0"),
        obs_configs=env_config["obs_configs"],
        reward_configs=env_config["reward_configs"],
        terminal_configs=env_config["terminal_configs"],
        host=env_config.get("host", "localhost"),
        port=env_config.get("port", 2000),
        seed=seed,
        no_rendering=env_config.get("no_rendering", False),
        **env_config.get("env_configs", {}),
    )
    return env


def create_server(env_config, off_screen: bool = False) -> CarlaServerManager:
    """Start the CARLA server (reference: misc/create_agent.py:17-21)."""
    carla_sh = env_config.get("carla_sh_path") or os.environ.get("CARLA_SH_PATH")
    if not carla_sh:
        raise ValueError("Set carla_sh_path in the env config or CARLA_SH_PATH env var")
    manager = CarlaServerManager(carla_sh, port=env_config.get("port", 2000))
    manager.start(off_screen=off_screen)
    return manager


def create_env(env_config, seed: int = 0, factory: Optional[str] = None):
    """Build the closed-loop env via a registered factory
    (reference: misc/create_agent.py:24-60)."""
    name = factory or env_config.get("factory", "carla_roach")
    if name not in ENV_FACTORIES:
        raise KeyError(f"Unknown env factory {name}; available: {list(ENV_FACTORIES)}")
    return ENV_FACTORIES[name](env_config, seed)
