from .config import CfgNode, create_cfg, merge_possible_with_base
from .constants import ACTION_DIM, ANCHOR_DIMS, MAGIC_NUM, STATE_DIM, GuidanceType
from .device import resolve_device, use_float32_math

__all__ = [
    "CfgNode",
    "create_cfg",
    "merge_possible_with_base",
    "ACTION_DIM",
    "ANCHOR_DIMS",
    "MAGIC_NUM",
    "STATE_DIM",
    "GuidanceType",
    "resolve_device",
    "use_float32_math",
]
