"""The port's simulator layer: only the benchmark task suites so far
(``sim/suites.py``). The CARLA env (the JAX package's ``sim/carla_env.py``
and the rest of its ``sim/``) is not ported yet (``ROADMAP.md`` Queue 1)."""

from .suites import SUITES, WEATHER_GROUPS, TransformSpec, build_suite_tasks

__all__ = ["SUITES", "WEATHER_GROUPS", "TransformSpec", "build_suite_tasks"]
