from .blocks import (
    CondMLP,
    Conv1dBlock,
    Downsample1d,
    LinearAttention,
    PreNormAttention,
    ResidualTemporalMapBlock,
    TimeMLP,
    TrajPredict,
    TransformerEncoderLayer,
    Upsample1d,
)
from .convert import apply_ema_shadow_params, build_mapping, from_jax_variables, load_torch_checkpoint
from .resnet import ResNet, TinyEncoder, resnet34
from .temporal_unet import TemporalMapUnet, build_model, init_parameters

__all__ = [
    "CondMLP",
    "Conv1dBlock",
    "Downsample1d",
    "LinearAttention",
    "PreNormAttention",
    "ResidualTemporalMapBlock",
    "TimeMLP",
    "TrajPredict",
    "TransformerEncoderLayer",
    "Upsample1d",
    "apply_ema_shadow_params",
    "build_mapping",
    "from_jax_variables",
    "load_torch_checkpoint",
    "ResNet",
    "TinyEncoder",
    "resnet34",
    "TemporalMapUnet",
    "build_model",
    "init_parameters",
]
