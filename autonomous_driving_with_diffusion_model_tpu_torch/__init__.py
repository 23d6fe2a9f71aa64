"""PyTorch and CUDA port of the diffusion planner, for NVIDIA Hopper (H100).

It sits beside the JAX package ``autonomous_driving_with_diffusion_model_tpu``,
which stays the reference, and imports nothing of it. The JAX package's two
Pallas kernels are CUDA C++ kernels here (``ops/csrc``, ``ops/kernels.py``).
This slice ports the closed-loop planner: ``driving.DiffusionPlanner``.
"""

__version__ = "0.1.0"

from .utils import CfgNode, GuidanceType, MAGIC_NUM, create_cfg, merge_possible_with_base  # noqa: F401
