"""PyTorch and CUDA port of the diffusion planner, for NVIDIA Hopper (H100).

It sits beside the JAX package ``autonomous_driving_with_diffusion_model_tpu``,
which stays the reference, and imports nothing of it. The JAX package's two
Pallas kernels are CUDA C++ kernels here (``ops/csrc``, ``ops/kernels.py``).
It ports the closed-loop planner (``driving.DiffusionPlanner``) and the
agents around it (``driving.InteractAgent``, the leaderboard
``driving/leaderboard_agent.py``, ``driving.RouteEvaluator``, the
``driving.evaluate_cli`` and ``interact`` CLIs) and the trainer
(``train``: the step, EMA, checkpoints, and ``python -m
autonomous_driving_with_diffusion_model_tpu_torch.train``), which run on
the card unless asked for the CPU.
"""

__version__ = "0.1.0"

from .utils import CfgNode, GuidanceType, MAGIC_NUM, create_cfg, merge_possible_with_base  # noqa: F401
