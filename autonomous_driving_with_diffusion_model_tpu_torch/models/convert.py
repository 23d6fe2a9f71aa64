"""Weights across the two packages, and reference ``.pth`` loading
(counterpart of the JAX package's ``models/torch_convert.py``).

The port's parameters carry the reference torch ``state_dict`` names, so a
reference checkpoint loads as it is. This module keeps its own copy of the
JAX package's declarative mapping ``(torch_key, flax_path, transform)``
(names, transforms and the torch registration order ``perception,
[cond_mlp], time_mlp, downs, ups, mid_block1, [mid_attn], mid_block2,
[act_conv + state_pred | final_conv]``), so that:

* :func:`from_jax_variables` turns the JAX planner's ``{"params",
  "batch_stats"}`` tree (numpy arrays) into the port's ``state_dict``;
* :func:`load_torch_checkpoint` reads a reference ``.pth`` and overwrites the
  parameters with its EMA ``shadow_params`` list, in ``model.parameters()``
  order (reference: interact.py:102-108, misc/load_param.py:4-8).

Beyond the JAX package's ``.pth`` mapping, which covers ResNet-34 only, the
whole ResNet family and the ``tiny`` test encoder map too, so
:func:`from_jax_variables` carries any JAX encoder; a ``.pth`` stays
ResNet-34 only, as there.

:func:`import_torchvision_backbone` starts the encoder from a torchvision
ResNet-34 ``state_dict`` (``TRAIN.PRETRAINED_BACKBONE``, the reference's
``resnet34(pretrained=True)``), as JAX ``models/torch_convert.py:330-405``
does.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..utils.constants import GuidanceType

__all__ = ["build_mapping", "from_jax_variables", "apply_ema_shadow_params", "load_torch_checkpoint",
           "import_torchvision_backbone", "load_torchvision_backbone"]

T_NONE = "none"  # identical layout
T_CONV1D = "conv1d"  # torch (O, I, K)    <- flax (K, I, O)
T_CONV2D = "conv2d"  # torch (O, I, H, W) <- flax (H, W, I, O)
T_CONVT1D = "convt1d"  # torch (I, O, K)  <- flax (K, I, O)
T_DENSE = "dense"  # torch (O, I)       <- flax (I, O)
T_SQUEEZE = "squeeze"  # torch (1, C, 1)  <- flax (C,)

# flax layout -> torch layout
_TO_TORCH = {
    T_NONE: lambda x: x,
    T_CONV1D: lambda x: np.transpose(x, (2, 1, 0)),
    T_CONV2D: lambda x: np.transpose(x, (3, 2, 0, 1)),
    T_CONVT1D: lambda x: np.transpose(x, (1, 2, 0)),
    T_DENSE: lambda x: np.transpose(x, (1, 0)),
    T_SQUEEZE: lambda x: np.reshape(x, (1, -1, 1)),
}

Entry = Tuple[str, Tuple[str, ...], str]


def _dense(tk: str, fp: Tuple[str, ...]) -> List[Entry]:
    return [(f"{tk}.weight", fp + ("weight",), T_DENSE), (f"{tk}.bias", fp + ("bias",), T_NONE)]


def _conv1d(tk: str, fp: Tuple[str, ...], bias: bool = True) -> List[Entry]:
    out = [(f"{tk}.weight", fp + ("weight",), T_CONV1D)]
    if bias:
        out.append((f"{tk}.bias", fp + ("bias",), T_NONE))
    return out


def _norm(tk: str, fp: Tuple[str, ...]) -> List[Entry]:
    return [(f"{tk}.weight", fp + ("weight",), T_NONE), (f"{tk}.bias", fp + ("bias",), T_NONE)]


def _conv1d_block(tk: str, fp: Tuple[str, ...]) -> List[Entry]:
    """Conv1dBlock: ``.block.0`` conv, ``.block.2`` group norm (helpers.py:95-112)."""
    return _conv1d(f"{tk}.block.0", fp) + [
        (f"{tk}.block.2.weight", fp + ("norm_weight",), T_NONE),
        (f"{tk}.block.2.bias", fp + ("norm_bias",), T_NONE),
    ]


def _res_block(tk: str, fp_name: str, cin: int, cout: int) -> List[Entry]:
    fp = (fp_name,)
    out = _conv1d_block(f"{tk}.blocks.0", fp + ("block1",))
    out += _conv1d_block(f"{tk}.blocks.1", fp + ("block2",))
    out += _dense(f"{tk}.time_mlp.1", fp + ("time_mlp",))
    if cin != cout:
        out += _conv1d(f"{tk}.residual_conv", fp + ("residual_conv",))
    return out


def _attn(tk: str, fp_name: str) -> List[Entry]:
    fp = (fp_name,)
    return [
        (f"{tk}.fn.norm.g", fp + ("norm_g",), T_SQUEEZE),
        (f"{tk}.fn.norm.b", fp + ("norm_b",), T_SQUEEZE),
        (f"{tk}.fn.fn.to_qkv.weight", fp + ("attn", "to_qkv", "weight"), T_CONV1D),
    ] + _conv1d(f"{tk}.fn.fn.to_out", fp + ("attn", "to_out"))


def _bn(tk: str, fp: Tuple[str, ...]) -> Tuple[List[Entry], List[Entry]]:
    stats = [
        (f"{tk}.running_mean", fp + ("running_mean",), T_NONE),
        (f"{tk}.running_var", fp + ("running_var",), T_NONE),
    ]
    return _norm(tk, fp), stats


# MODEL.PERCEPTION -> (bottleneck blocks, blocks per stage), JAX ``resnet.py:211-236``
RESNET_LAYERS = {
    "resnet18": (False, (2, 2, 2, 2)),
    "resnet34": (False, (3, 4, 6, 3)),
    "resnet50": (True, (3, 4, 6, 3)),
    "resnet101": (True, (3, 4, 23, 3)),
    "resnet152": (True, (3, 8, 36, 3)),
    "resnext50_32x4d": (True, (3, 4, 6, 3)),
    "wide_resnet50_2": (True, (3, 4, 6, 3)),
}


def _resnet_mapping(perception: str, prefix: str = "perception") -> Tuple[List[Entry], List[Entry]]:
    """torchvision layout (reference: modeling/resnet.py:163-296); JAX block
    names ``layer{s}_{i}`` with ``ds_conv``/``ds_bn``."""
    bottleneck, layers = RESNET_LAYERS[perception]
    expansion = 4 if bottleneck else 1
    convs = ("conv1", "conv2", "conv3") if bottleneck else ("conv1", "conv2")
    params: List[Entry] = [(f"{prefix}.conv1.weight", ("perception", "conv1", "weight"), T_CONV2D)]
    stats: List[Entry] = []
    p, s = _bn(f"{prefix}.bn1", ("perception", "bn1"))
    params += p
    stats += s
    in_ch = 64
    for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
        stride = 1 if stage == 0 else 2
        for i in range(blocks):
            tk = f"{prefix}.layer{stage + 1}.{i}"
            fp = ("perception", f"layer{stage + 1}_{i}")
            for conv in convs:
                bn = "bn" + conv[-1]
                params.append((f"{tk}.{conv}.weight", fp + (conv, "weight"), T_CONV2D))
                p, s = _bn(f"{tk}.{bn}", fp + (bn,))
                params += p
                stats += s
            if (stride if i == 0 else 1) != 1 or in_ch != planes * expansion:
                params.append((f"{tk}.downsample.0.weight", fp + ("ds_conv", "weight"), T_CONV2D))
                p, s = _bn(f"{tk}.downsample.1", fp + ("ds_bn",))
                params += p
                stats += s
            in_ch = planes * expansion
    params += _dense(f"{prefix}.fc", ("perception", "fc"))
    return params, stats


def _tiny_mapping() -> Tuple[List[Entry], List[Entry]]:
    params = [
        ("perception.conv1.weight", ("perception", "conv1", "weight"), T_CONV2D),
        ("perception.conv2.weight", ("perception", "conv2", "weight"), T_CONV2D),
    ] + _dense("perception.fc", ("perception", "fc"))
    return params, []


def _transformer_layer(tk: str, fp: Tuple[str, ...]) -> List[Entry]:
    return [
        (f"{tk}.self_attn.in_proj_weight", fp + ("in_proj_weight",), T_DENSE),
        (f"{tk}.self_attn.in_proj_bias", fp + ("in_proj_bias",), T_NONE),
        *_dense(f"{tk}.self_attn.out_proj", fp + ("out_proj",)),
        *_dense(f"{tk}.linear1", fp + ("linear1",)),
        *_dense(f"{tk}.linear2", fp + ("linear2",)),
        *_norm(f"{tk}.norm1", fp + ("norm1",)),
        *_norm(f"{tk}.norm2", fp + ("norm2",)),
    ]


def build_mapping(cfg) -> Tuple[List[Entry], List[Entry]]:
    """(param_entries, batch_stat_entries); param_entries follow the torch
    ``named_parameters()`` order."""
    perception = cfg.MODEL.get("PERCEPTION", "resnet34")
    if perception in RESNET_LAYERS:
        params, stats = _resnet_mapping(perception)
    elif perception == "tiny":
        params, stats = _tiny_mapping()
    else:
        raise ValueError(f"no weight mapping for MODEL.PERCEPTION={perception!r}")
    use_cond = GuidanceType[cfg.TRAIN.USE_COND]
    attention = cfg.MODEL.USE_ATTN
    dims = [cfg.MODEL.TRANSITION_DIM] + [cfg.MODEL.DIM * m for m in cfg.MODEL.DIM_MULTS]
    in_out = list(zip(dims[:-1], dims[1:]))
    n_res = len(in_out)

    if use_cond == GuidanceType.FREE_GUIDANCE:
        params += _dense("cond_mlp.0", ("cond_mlp", "fc1"))
        params += _dense("cond_mlp.2", ("cond_mlp", "fc2"))
    params += _dense("time_mlp.1", ("time_mlp", "fc1"))
    params += _dense("time_mlp.3", ("time_mlp", "fc2"))

    for ind, (dim_in, dim_out) in enumerate(in_out):
        params += _res_block(f"downs.{ind}.0", f"down{ind}_res1", dim_in, dim_out)
        params += _res_block(f"downs.{ind}.1", f"down{ind}_res2", dim_out, dim_out)
        if attention:
            params += _attn(f"downs.{ind}.2", f"down{ind}_attn")
        if ind < n_res - 1:
            params += _conv1d(f"downs.{ind}.3.conv", (f"down{ind}_down", "conv"))

    for ind, (dim_in, dim_out) in enumerate(reversed(in_out[1:])):
        params += _res_block(f"ups.{ind}.0", f"up{ind}_res1", dim_out * 2, dim_in)
        params += _res_block(f"ups.{ind}.1", f"up{ind}_res2", dim_in, dim_in)
        if attention:
            params += _attn(f"ups.{ind}.2", f"up{ind}_attn")
        params.append((f"ups.{ind}.3.conv.weight", (f"up{ind}_up", "weight"), T_CONVT1D))
        params.append((f"ups.{ind}.3.conv.bias", (f"up{ind}_up", "bias"), T_NONE))

    mid_dim = dims[-1]
    params += _res_block("mid_block1", "mid_block1", mid_dim, mid_dim)
    if attention:
        params += _attn("mid_attn", "mid_attn")
    params += _res_block("mid_block2", "mid_block2", mid_dim, mid_dim)

    if use_cond == GuidanceType.CLASSIFIER_GUIDANCE:
        params += _conv1d_block("act_conv.0", ("act_block",))
        params += _conv1d("act_conv.1", ("act_head",))
        params += _dense("state_pred.input_proj", ("state_pred", "input_proj"))
        for i in range(2):
            params += _transformer_layer(f"state_pred.encoder_traj.layers.{i}", ("state_pred", f"layer{i}"))
        params += _norm("state_pred.encoder_traj.norm", ("state_pred", "norm"))
        params += _dense("state_pred.output_proj", ("state_pred", "output_proj"))
    else:
        params += _conv1d_block("final_conv.0", ("final_block",))
        params += _conv1d("final_conv.1", ("final_head",))
    return params, stats


def _get_path(tree: Dict, path: Tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return tree


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(x, dtype=np.float32))


def from_jax_variables(variables: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """The JAX planner's ``{"params", "batch_stats"}`` tree (numpy arrays) ->
    the port's ``state_dict`` with zero ``num_batches_tracked`` buffers, ready
    for ``load_state_dict(strict=True)``."""
    params_map, stats_map = build_mapping(cfg)
    params, stats = variables["params"], variables.get("batch_stats", {})
    out: Dict[str, torch.Tensor] = {}
    for torch_key, flax_path, tf in params_map:
        out[torch_key] = _tensor(_TO_TORCH[tf](np.asarray(_get_path(params, flax_path), np.float32)))
    for torch_key, flax_path, tf in stats_map:
        out[torch_key] = _tensor(_TO_TORCH[tf](np.asarray(_get_path(stats, flax_path), np.float32)))
        if torch_key.endswith("running_var"):
            out[torch_key.replace("running_var", "num_batches_tracked")] = torch.tensor(0, dtype=torch.int64)
    return out


def apply_ema_shadow_params(state_dict: Dict[str, Any], shadow_params: List[Any], cfg) -> Dict[str, Any]:
    """Overwrite the parameters of ``state_dict`` with the EMA ``shadow_params``
    list, which follows ``model.parameters()`` order (misc/load_param.py:4-8)."""
    params_map, _ = build_mapping(cfg)
    if len(shadow_params) != len(params_map):
        raise ValueError(f"shadow_params length {len(shadow_params)} != expected {len(params_map)}")
    out = dict(state_dict)
    for (torch_key, _, _), shadow in zip(params_map, shadow_params):
        out[torch_key] = _tensor(shadow)
    return out


def load_torch_checkpoint(path: str, cfg, use_ema: bool = True) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` -> the port's ``state_dict``: ``state_dict``, then
    the EMA shadow overwrite (reference: interact.py:102-108). ResNet-34
    only, the reference's encoder, as in JAX ``models/torch_convert.py:171-174``."""
    perception = cfg.MODEL.get("PERCEPTION", "resnet34")
    if perception != "resnet34":
        raise ValueError(
            f"torch checkpoint conversion requires MODEL.PERCEPTION=resnet34 "
            f"(the reference's encoder), got {perception}"
        )
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state_dict = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    if use_ema and isinstance(ckpt, dict) and "ema_state_dict" in ckpt:
        state_dict = apply_ema_shadow_params(state_dict, ckpt["ema_state_dict"]["shadow_params"], cfg)
    return state_dict


def import_torchvision_backbone(state_dict: Dict[str, Any], tv_state_dict: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """The model's ``state_dict`` with its encoder from a torchvision ResNet-34
    ``state_dict`` (keys ``conv1.weight``, ``layer1.0.bn1.running_mean``, ...;
    torch tensors or numpy arrays), as the reference's fresh training run
    starts (modeling/temporal.py:83-84):

    * every encoder conv weight, BatchNorm parameter and running statistic
      comes from ``tv_state_dict``, bit for bit;
    * torchvision's 1000-way ``fc`` is dropped: the fresh (time_dim, 512)
      head stays;
    * every other entry is left as it is, ``num_batches_tracked`` included
      (JAX keeps no such counter).

    A missing key raises ``KeyError``, a shape that differs ``ValueError``
    naming the key, and an encoder other than ResNet-34 ``ValueError``.
    Returns a new dict; the inputs are not changed."""
    perception = cfg.MODEL.get("PERCEPTION", "resnet34")
    if perception != "resnet34":
        raise ValueError(
            f"TRAIN.PRETRAINED_BACKBONE requires MODEL.PERCEPTION=resnet34 (a torchvision resnet34 "
            f"state_dict), got {perception}"
        )
    params_map, stats_map = _resnet_mapping("resnet34")
    out = dict(state_dict)
    for torch_key, _, _ in params_map + stats_map:
        if torch_key.startswith("perception.fc."):
            continue  # the fresh time_dim head, not ImageNet's 1000-way fc
        key = torch_key[len("perception."):]
        if key not in tv_state_dict:
            raise KeyError(f"Missing key in torchvision state_dict: {key}")
        arr = _tensor(tv_state_dict[key])
        have = out[torch_key]
        if tuple(arr.shape) != tuple(have.shape):
            raise ValueError(f"{key}: torchvision shape {tuple(arr.shape)} != model {tuple(have.shape)}")
        out[torch_key] = arr.to(have.dtype)
    return out


def load_torchvision_backbone(path: str, state_dict: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """:func:`import_torchvision_backbone` from a ``.pth`` file: a bare
    ``state_dict``, a dict holding one under ``state_dict``, or a saved
    module (what ``torchvision.models.resnet34(pretrained=True)`` gives)."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if hasattr(sd, "state_dict"):  # a whole module was saved
        sd = sd.state_dict()
    return import_torchvision_backbone(state_dict, sd, cfg)
