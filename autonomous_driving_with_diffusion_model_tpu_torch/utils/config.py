"""Configuration system (the port's own copy of the JAX package's
``utils/config.py``: same keys, same defaults, same YAML semantics).

A minimal, dependency-free re-implementation of the yacs ``CfgNode`` surface the
reference uses (reference: config.py:9-156): a nested attribute-dict with

* ``create_cfg()`` producing the exact default tree of the reference planner,
* ``_BASE_`` single-inheritance YAML merge (reference: config.py:106-111),
* dotted-key CLI override lists (``cfg.merge_from_list(["EVAL.SAMPLE_STEPS", "10"])``),
* a pretty printer (``show_config``).

The reference's YAML config files (configs/default.yaml, configs/guidance/*.yaml)
parse unchanged through this module.
"""

from __future__ import annotations

import copy
import os.path as osp
import pprint
from typing import Any, List

import yaml

__all__ = [
    "CfgNode",
    "create_cfg",
    "merge_possible_with_base",
    "show_config",
    "pretty_print_cfg",
]


class CfgNode(dict):
    """Nested attribute dictionary with yacs-like merge semantics."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as exc:  # pragma: no cover - attribute error path
            raise AttributeError(name) from exc

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as exc:  # pragma: no cover
            raise AttributeError(name) from exc

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    # ------------------------------------------------------------------ merge
    @staticmethod
    def _coerce(old: Any, new: Any, key: str) -> Any:
        """Coerce ``new`` to the type of ``old`` (yacs-compatible leniency)."""
        if old is None or new is None:
            return new
        if isinstance(old, tuple) and isinstance(new, list):
            return tuple(new)
        if isinstance(old, list) and isinstance(new, tuple):
            return list(new)
        if isinstance(old, float) and isinstance(new, int) and not isinstance(new, bool):
            return float(new)
        if isinstance(old, bool) != isinstance(new, bool) and (
            isinstance(old, bool) or isinstance(new, bool)
        ):
            raise ValueError(f"Type mismatch for key {key}: {type(old)} vs {type(new)}")
        if type(old) is not type(new) and not (
            isinstance(old, (int, float)) and isinstance(new, (int, float))
        ):
            raise ValueError(
                f"Type mismatch for key {key}: {type(old).__name__} vs {type(new).__name__}"
            )
        return new

    def merge_from_other_cfg(self, other: dict, _path: str = "") -> None:
        for key, value in other.items():
            if key == "_BASE_":
                continue
            full_key = f"{_path}.{key}" if _path else key
            if key in self and isinstance(self[key], CfgNode) and isinstance(value, dict):
                self[key].merge_from_other_cfg(value, full_key)
            elif key in self:
                self[key] = self._coerce(self[key], value, full_key)
            else:
                raise KeyError(f"Non-existent config key: {full_key}")

    def merge_from_file(self, config_path: str) -> None:
        with open(config_path, "r") as f:
            loaded = yaml.safe_load(f) or {}
        self.merge_from_other_cfg(_to_cfg(loaded))

    def merge_from_list(self, opts: List[str]) -> None:
        assert len(opts) % 2 == 0, f"Override list must have even length, got {opts}"
        for key, raw in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for part in parts[:-1]:
                if part not in node:
                    raise KeyError(f"Non-existent config key: {key}")
                node = node[part]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {key}")
            value = raw
            if isinstance(raw, str):
                try:
                    value = yaml.safe_load(raw)
                except yaml.YAMLError:  # keep raw string
                    value = raw
            node[leaf] = self._coerce(node[leaf], value, key)

    # ------------------------------------------------------------------- io
    def dump_yaml(self) -> str:
        return yaml.safe_dump(_to_plain(self), sort_keys=True)


def _to_cfg(obj: Any) -> Any:
    if isinstance(obj, dict):
        node = CfgNode()
        for k, v in obj.items():
            node[k] = _to_cfg(v)
        return node
    return obj


def _to_plain(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _to_plain(v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return list(obj)
    return obj


def create_cfg() -> CfgNode:
    """Default configuration tree.

    Mirrors the reference's defaults key-for-key (reference: config.py:9-103) so
    its YAML files and CLI override strings work unchanged.
    """
    cfg = CfgNode()
    cfg._BASE_ = None
    cfg.PROJECT_NAME = "carla_diffusion"
    cfg.PROJECT_DIR = None

    cfg.ENV = CfgNode()
    cfg.ENV.CONFIG_PATH = "data_collect"
    cfg.ENV.AGENT_WARMUP = 1

    # ======= Model =======
    cfg.MODEL = CfgNode()
    cfg.MODEL.HORIZON = 16
    cfg.MODEL.TRANSITION_DIM = 7
    cfg.MODEL.USE_ATTN = False
    cfg.MODEL.DIM = 64
    cfg.MODEL.DIM_MULTS = (1, 2, 4, 8)
    cfg.MODEL.DIFFUSER_BUILDING_BLOCK = "concat"
    # TPU-native extension: perception encoder family. The reference hardcodes
    # resnet34 (modeling/temporal.py:83); torch-checkpoint conversion requires
    # "resnet34". "tiny" is a 2-conv encoder for tests/experiments.
    cfg.MODEL.PERCEPTION = "resnet34"
    # Port extension: the denoiser family. "temporal_map_unet", the
    # reference's (modeling/temporal.py); "conditional_unet1d", Diffusion
    # Policy's CNN (Chi et al., RSS 2023; models/conditional_unet1d.py): FiLM
    # residual blocks on [step embedding | the last N_OBS_STEPS
    # observations], an observation [image feature | target point], DIM x
    # DIM_MULTS its down_dims, PERCEPTION "resnet18_gn_keypoints"; serving
    # only, no guidance. The next four keys are its own.
    cfg.MODEL.ARCH = "temporal_map_unet"
    cfg.MODEL.STEP_EMBED_DIM = 128  # diffusion_step_embed_dim
    cfg.MODEL.N_OBS_STEPS = 2  # the requests a plan conditions on
    cfg.MODEL.OBS_FEATURE_DIM = 64  # one frame's image feature
    cfg.MODEL.NUM_KEYPOINTS = 32  # the spatial softmax's keypoints
    # Port extension: "rdt", RDT-1B (Liu et al., ICLR 2025; models/rdt.py):
    # a DiT over [t, ctrl_freq, state, HORIZON actions] cross-attending to
    # an instruction's tokens and to SigLIP's image tokens of N_OBS_STEPS
    # frames x CAMERAS cameras; DPM-Solver++ with x0 ("sample") prediction;
    # serving only, one hypothesis, no guidance. Its own keys (widths as
    # RDT's configs/base.yaml and SigLIP so400m-patch14-384 publish them):
    cfg.MODEL.RDT = CfgNode()
    cfg.MODEL.RDT.HIDDEN = 2048
    cfg.MODEL.RDT.DEPTH = 28
    cfg.MODEL.RDT.HEADS = 32
    cfg.MODEL.RDT.STATE_DIM = 128  # the unified action / state vector
    cfg.MODEL.RDT.LANG_DIM = 4096  # T5-v1.1-XXL's embedding
    cfg.MODEL.RDT.LANG_SLOTS = 32  # instruction tokens a plan holds
    cfg.MODEL.RDT.MAX_LANG_LEN = 1024  # the instruction's position table
    cfg.MODEL.RDT.CAMERAS = 3  # image slots a frame
    cfg.MODEL.RDT.REAL_CAMERAS = 1  # the first of them; the others the background image
    cfg.MODEL.RDT.LANG_ADAPTOR = "mlp2x_gelu"
    cfg.MODEL.RDT.IMG_ADAPTOR = "mlp2x_gelu"
    cfg.MODEL.RDT.STATE_ADAPTOR = "mlp3x_gelu"
    cfg.MODEL.RDT.CTRL_FREQ = 10  # Hz
    # where the transition's channels (x, y, yaw, speed, throttle, steer,
    # brake) and the target point sit in the unified vector
    cfg.MODEL.RDT.ACTION_SLOTS = (30, 31, 33, 100, 10, 102, 11)
    cfg.MODEL.RDT.TARGET_SLOTS = (80, 81)
    cfg.MODEL.RDT.VISION_WIDTH = 1152
    cfg.MODEL.RDT.VISION_DEPTH = 27
    cfg.MODEL.RDT.VISION_HEADS = 16
    cfg.MODEL.RDT.VISION_MLP = 4304
    cfg.MODEL.RDT.IMAGE_SIZE = 384
    cfg.MODEL.RDT.PATCH = 14

    # ======= Train =======
    cfg.TRAIN = CfgNode()
    cfg.TRAIN.RESUME = None
    # TPU-native extension: path to a torchvision ImageNet resnet34 .pth.
    # The reference always trains from resnet34(pretrained=True)
    # (modeling/temporal.py:83, weights downloaded in modeling/resnet.py:
    # 299-311); set this to start a fresh run from the same ImageNet weights
    # (models/torch_convert.py:import_torchvision_backbone). Empty = random
    # init. Also the premise of TPU.BN_MODE=frozen's "pretrained running
    # stats".
    cfg.TRAIN.PRETRAINED_BACKBONE = ""
    cfg.TRAIN.USE_COND = "NO_GUIDANCE"
    cfg.TRAIN.USE_FREE_COND_PROB = 0.7
    cfg.TRAIN.LOG_INTERVAL = 20
    cfg.TRAIN.SAVE_INTERVAL = 3000
    cfg.TRAIN.SAMPLE_INTERVAL = 3000
    cfg.TRAIN.USE_IMG_AUGMENTOR = True
    cfg.TRAIN.ROOT = None
    cfg.TRAIN.IMAGE_HEIGHT = 256
    cfg.TRAIN.IMAGE_WIDTH = 900

    cfg.TRAIN.BATCH_SIZE = 32
    cfg.TRAIN.NUM_WORKERS = 4
    cfg.TRAIN.MAX_ITER = 100000
    cfg.TRAIN.GRADIENT_ACCUMULATION_STEPS = 1
    cfg.TRAIN.GRAD_NORM = 1.0

    cfg.TRAIN.EMA_MAX_DECAY = 0.9999
    cfg.TRAIN.EMA_INV_GAMMA = 1.0
    cfg.TRAIN.EMA_POWER = 0.75

    cfg.TRAIN.LR = 0.0001
    cfg.TRAIN.LR_WARMUP = 1000

    cfg.TRAIN.TIME_STEPS = 100
    cfg.TRAIN.SAMPLE_STEPS = cfg.TRAIN.TIME_STEPS
    cfg.TRAIN.NOISE_SCHEDULER = CfgNode()
    # BETA_START/BETA_END apply to the `linear` schedule only.
    cfg.TRAIN.NOISE_SCHEDULER.BETA_START = 1e-4
    cfg.TRAIN.NOISE_SCHEDULER.BETA_END = 0.02
    cfg.TRAIN.NOISE_SCHEDULER.TYPE = "squaredcos_cap_v2"
    cfg.TRAIN.NOISE_SCHEDULER.PRED_TYPE = "sample"

    # ======= PID =======
    cfg.PID = CfgNode()
    cfg.PID.TURN_KP = 1
    cfg.PID.TURN_KI = 0.5
    cfg.PID.TURN_KD = 1.0
    cfg.PID.TURN_N = 40
    cfg.PID.SPEED_KP = 5
    cfg.PID.SPEED_KI = 0.5
    cfg.PID.SPEED_KD = 1.0
    cfg.PID.SPEED_N = 40

    # ======= Control =======
    cfg.CONTROL = CfgNode()
    cfg.CONTROL.AIM_DIST = 4.0
    cfg.CONTROL.ANGLE_THRESH = 0.3
    cfg.CONTROL.DIST_THRESH = 10
    cfg.CONTROL.BRAKE_SPEED = 0.4
    cfg.CONTROL.BRAKE_RATIO = 1.1
    cfg.CONTROL.CLIP_DELTA = 0.25
    cfg.CONTROL.MAX_THROTTLE = 9

    # ======= Guidance =======
    cfg.GUIDANCE = CfgNode()
    cfg.GUIDANCE.USE_COND = "NO_GUIDANCE"
    cfg.GUIDANCE.LOSS_LIST = None
    cfg.GUIDANCE.STEP = 1
    cfg.GUIDANCE.CLASSIFIER_SCALE = 0.1
    cfg.GUIDANCE.FREE_SCALE = 1.0

    # ======= Eval =======
    cfg.EVAL = CfgNode()
    cfg.EVAL.BATCH_SIZE = 4
    cfg.EVAL.ETA = 0
    cfg.EVAL.CHECKPOINT = None
    # "ddim" | "ddpm" | "dpm" (DPM-Solver++ 2M — the reference configures it,
    # interact.py:92-94, but its registry lacks the entry; live here)
    cfg.EVAL.SCHEDULER = "ddim"
    cfg.EVAL.SAMPLE_STEPS = 100
    # Port extension: the agents' x0 post-processing. Dynamic thresholding,
    # as the reference's agents sample (interact.py:81-94), or, False,
    # clipping to [-1, 1] (Diffusion Policy's DDPMScheduler).
    cfg.EVAL.THRESHOLDING = True

    # ======= TPU-native extensions (absent from the reference) =======
    cfg.TPU = CfgNode()
    # Compute dtype for the model forward pass ("float32" | "bfloat16").
    cfg.TPU.COMPUTE_DTYPE = "float32"
    # Run the image encoder once per plan instead of once per denoise step.
    # Numerically identical when the image is constant across steps (eval-mode
    # BN); `False` reproduces the reference execution for parity audits
    # (reference recomputes it per step: modeling/temporal.py:203).
    cfg.TPU.HOIST_PERCEPTION = True
    # Data-parallel mesh axis size hint (-1 = all available devices).
    cfg.TPU.DATA_PARALLEL = -1
    # Reuse one fixed init-noise tensor across plans (reference interact.py:100).
    cfg.TPU.FIXED_INIT_NOISE = True
    # Run Conv1dBlocks as one fused Pallas kernel (conv+GN+Mish) on TPU.
    # Read by the JAX package only: on a CUDA device the PyTorch port always
    # runs its CUDA kernels (ops/kernels.py), with no switch.
    cfg.TPU.USE_PALLAS_CONV = False
    # lax.scan unroll factor for the fused sampling loop: >1 lets XLA fuse
    # across denoise steps, cutting per-step sequencing overhead at batch 1
    # (costs compile time and program size; 1 = no unrolling).
    cfg.TPU.SCAN_UNROLL = 1
    # Multi-hypothesis planning: sample K trajectories per plan (one fused
    # program, perception encoded once) and drive the best-scoring one —
    # near-free on the MXU (batch-8 costs ~1.4x batch-1 wall time).
    cfg.TPU.NUM_HYPOTHESES = 1
    # Hypothesis scorer: "auto" = endpoint-to-target distance for guided
    # modes, min-jerk for unguided; "guidance_loss" scores with the
    # TargetGuidance loss itself (softmin-weighted whole-trajectory distance,
    # the same objective classifier guidance descends); "jerk" forces comfort.
    # "learned" ranks with an outcome-trained net (models/scorer.py; needs
    # TPU.SCORER_CHECKPOINT, an .npz from learnability.py --learned-scorer).
    cfg.TPU.HYPOTHESIS_SCORER = "auto"
    # Path to a saved learned-scorer .npz (models.scorer.save_scorer).
    cfg.TPU.SCORER_CHECKPOINT = ""
    # Rematerialize the train-step forward on backward (jax.checkpoint):
    # drops activations from HBM for large batch at 900x256 (~1/3 extra fwd
    # FLOPs; gradients unchanged).
    cfg.TPU.REMAT = False
    # Encoder BatchNorm mode during training. "frozen" (the TPU default,
    # docs/PARITY.md divergence #8) normalizes with the running stats (the
    # torch practice of freezing BN when fine-tuning a pretrained backbone —
    # pair it with TRAIN.PRETRAINED_BACKBONE): it removes the per-conv batch
    # reductions measured as the ENTIRE train-vs-inference MFU gap
    # (docs/DESIGN.md; 48% -> 59.8% useful MFU at b256 bf16) and trains to
    # identical flagship quality (held-out RMS 0.1505 vs 0.151 m,
    # LEARNABILITY_FROZEN.json). "train" is the strict-parity switch: the
    # reference's model.train() batch-statistics semantics, exactly.
    cfg.TPU.BN_MODE = "frozen"
    # Device-resident dataset for training: "auto" uploads the whole decoded
    # dataset to HBM once when it fits the byte budget below and gathers
    # batches on device (no per-step host->device bulk transfer); "on"/"off"
    # force it. Single-process only; epoch/shuffle order identical to the
    # host loader.
    cfg.TPU.DEVICE_DATA = "auto"
    cfg.TPU.DEVICE_DATA_MAX_BYTES = 512 * 1024 * 1024
    # Explicit denoising grid (strictly-decreasing train-timestep indices)
    # overriding EVAL.SAMPLE_STEPS' leading spacing. Set by progressively
    # distilled checkpoints (distill.py records each stage's grid), whose
    # halved grids are not reachable by leading spacing. Empty = leading.
    cfg.TPU.SAMPLE_TIMESTEPS = []
    return cfg


def merge_possible_with_base(cfg: CfgNode, config_path: str) -> None:
    """Merge a YAML file, honoring a relative ``_BASE_`` parent (single level).

    Reference: config.py:106-111.
    """
    with open(config_path, "r") as f:
        new_cfg = yaml.safe_load(f) or {}
    if "_BASE_" in new_cfg and new_cfg["_BASE_"]:
        cfg.merge_from_file(osp.join(osp.dirname(config_path), new_cfg["_BASE_"]))
    cfg.merge_from_other_cfg(_to_cfg(new_cfg))


def pretty_print_cfg(cfg: CfgNode) -> str:
    def _indent(s_: str, num_spaces: int) -> str:
        s = s_.split("\n")
        if len(s) == 1:
            return s_
        first = s.pop(0)
        return first + "\n" + "\n".join((num_spaces * " ") + line for line in s)

    parts = []
    for k, v in sorted(cfg.items()):
        sep = "\n" if isinstance(v, dict) else " "
        body = pretty_print_cfg(v) if isinstance(v, dict) else pprint.pformat(v)
        parts.append(_indent(f"{k}:{sep}{body}", 2))
    return "\n".join(parts)


def show_config(cfg: CfgNode) -> None:
    try:
        from colorama import Fore, Style
        from tabulate import tabulate

        table = tabulate(
            {"Configuration": [pretty_print_cfg(cfg)]}, headers="keys", tablefmt="fancy_grid"
        )
        print(f"{Fore.BLUE}{table}{Style.RESET_ALL}")
    except ImportError:  # pragma: no cover
        print(pretty_print_cfg(cfg))
