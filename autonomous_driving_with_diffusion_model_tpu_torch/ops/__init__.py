from .kernels import (
    conv1d_gn_mish_plain,
    fused_conv1d_gn_mish,
    fused_residual_block,
    reset_launch_counts,
    residual_block_plain,
)
from .nn import (
    channel_layer_norm,
    conv1d,
    conv1d_transpose,
    conv2d,
    group_norm,
    mish,
    sinusoidal_pos_emb,
)

__all__ = [
    "channel_layer_norm",
    "conv1d",
    "conv1d_transpose",
    "conv2d",
    "group_norm",
    "mish",
    "sinusoidal_pos_emb",
    "conv1d_gn_mish_plain",
    "fused_conv1d_gn_mish",
    "fused_residual_block",
    "residual_block_plain",
    "reset_launch_counts",
]
