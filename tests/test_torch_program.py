"""The port's CUDA-graph programs (``ops/program.py``) through their owners.

On the CPU: the generation rule of the plan, train and distill programs (an
in-place write to a tensor an owner follows drops its programs, and the
next call builds under the next generation; the owner's own steps do not
move it). On a card only (``gpu``): a capture that fails raises for the
plan, the train step and the augmentation, naming the key, and keeps no
program. The ``gpu`` tests run without JAX:
``python -m pytest tests/test_torch_program.py -m gpu --noconftest``.
"""

import numpy as np
import pytest
import torch

from autonomous_driving_with_diffusion_model_tpu_torch.data import augment as aug
from autonomous_driving_with_diffusion_model_tpu_torch.diffusion import grid_chain, make_distill_step, make_schedule
from autonomous_driving_with_diffusion_model_tpu_torch.driving import DiffusionPlanner
from autonomous_driving_with_diffusion_model_tpu_torch.models import build_model
from autonomous_driving_with_diffusion_model_tpu_torch.ops import kernels
from autonomous_driving_with_diffusion_model_tpu_torch.train import create_train_state, make_train_step
from autonomous_driving_with_diffusion_model_tpu_torch.train.cli import iteration_generators
from autonomous_driving_with_diffusion_model_tpu_torch.train.program import DistillProgram, TrainProgram
from autonomous_driving_with_diffusion_model_tpu_torch.train.state import TrainStep
from autonomous_driving_with_diffusion_model_tpu_torch.utils.config import create_cfg

torch.set_num_threads(1)

B = 4
HW = (32, 48)


def _cfg():
    cfg = create_cfg()
    cfg.MODEL.DIM = 8
    cfg.MODEL.DIM_MULTS = (1, 2)
    cfg.MODEL.PERCEPTION = "tiny"
    cfg.TRAIN.TIME_STEPS = cfg.TRAIN.SAMPLE_STEPS = 10
    cfg.EVAL.SAMPLE_STEPS = 2
    cfg.TRAIN.IMAGE_HEIGHT, cfg.TRAIN.IMAGE_WIDTH = HW
    return cfg


def _batch(device):
    rng = np.random.default_rng(1)
    return {
        "image": torch.from_numpy(rng.standard_normal((B, *HW, 3)).astype(np.float32)).to(device),
        "trajs": torch.from_numpy((rng.standard_normal((B, 16, 7)) * 0.3).astype(np.float32)).to(device),
        "target": torch.from_numpy(rng.standard_normal((B, 2)).astype(np.float32)).to(device),
    }


# each owner on ``device``: (the owner, a call of it, a tensor it follows)


def _plan(device):
    planner = DiffusionPlanner(_cfg(), seed=0, device=device)
    frame = np.random.default_rng(0).integers(0, 256, (*HW, 3), dtype=np.uint8)
    return planner._program, lambda: planner.plan(frame), next(planner.model.parameters())


def _train(device):
    cfg = _cfg()
    state = create_train_state(build_model(cfg, device=device, seed=0), cfg)
    program = TrainProgram(make_train_step(make_schedule("squaredcos_cap_v2", 10, device=device), cfg), device)
    call = lambda: program(state, _batch(device), generator=iteration_generators(state.step, device)[1])
    return program, call, next(state.model.parameters())


def _distill(device):
    teacher = build_model(_cfg(), device=device, seed=0)
    init_state, step = make_distill_step(make_schedule("squaredcos_cap_v2", 10, device=device),
                                         grid_chain(10, 5, 1)[0], lr=1e-3, warmup=1, decay_steps=3)
    state = init_state(teacher)
    program = DistillProgram(step, device)
    call = lambda: program(state, teacher, _batch(device), generator=iteration_generators(state.step, device)[1])
    return program, call, next(teacher.parameters())  # the teacher's weights are followed too


def _augment(device):
    program = aug.AugmentProgram(device)
    images = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (B, *HW, 3), dtype=np.uint8)).to(device)
    return program, lambda: program(images, torch.Generator().manual_seed(0), 0), None


OWNERS = {"plan": _plan, "train": _train, "distill": _distill, "augment": _augment}


@pytest.mark.parametrize("owner", ["plan", "train", "distill"])
def test_a_write_to_a_followed_tensor_is_a_new_generation(owner):
    """Two calls share one key and one generation (a step's own writes do
    not move it); a tensor the owner follows written in place from outside
    drops every program, and the next call builds under generation + 1."""
    program, call, followed = OWNERS[owner]("cpu")
    call()
    call()
    generation, key = program.generation, program.key
    assert generation == 0 and key[-1] == generation and list(program.programs) == [key]
    with torch.no_grad():
        followed.mul_(0.5)  # same storage, a new _version
    call()
    assert program.generation == generation + 1 and program.key[-1] == generation + 1
    assert program.key[:-1] == key[:-1] and list(program.programs) == [program.key]


def _syncing(fn):
    """``fn`` followed by a host sync on its output, which a capture refuses."""
    def run(*args, **kw):
        out = fn(*args, **kw)
        float((out[0] if isinstance(out, tuple) else out).sum())
        return out
    return run


@pytest.mark.gpu
@pytest.mark.parametrize("owner,pattern", [
    ("plan", r"capturing the plan .*frame \(32, 48, 3\)"),
    ("train", r"capturing the train step .*batch\.image \(4, 32, 48, 3\)"),
    ("augment", r"capturing the augmentation .*images \(4, 32, 48, 3\)"),
])
def test_failed_capture_raises_on_card(monkeypatch, owner, pattern):
    """A body that waits on the card cannot be captured: every call raises,
    naming the key, keeps no program and never runs the eager body in the
    replay's place; the plan's failed builds count no launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    target, name = {"plan": (DiffusionPlanner, "_plan"), "train": (TrainStep, "body"),
                    "augment": (aug, "augment_body")}[owner]
    monkeypatch.setattr(target, name, _syncing(getattr(target, name)))
    program, call, _ = OWNERS[owner]("cuda")
    kernels.reset_launch_counts()
    for _ in range(2):
        with pytest.raises(RuntimeError, match=pattern):
            call()
    assert program.programs == {}
    if owner == "plan":
        assert not any(kernels.launch_counts().values())
