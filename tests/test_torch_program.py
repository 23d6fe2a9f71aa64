"""The port's CUDA-graph programs (``ops/program.py``) through their owners.

On the CPU: the generation rule of the plan, train and distill programs (an
in-place write to a tensor an owner follows drops its programs, and the
next call builds under the next generation; the owner's own steps do not
move it), every way of writing the planner's weights after a plan, and
the plan's follower of its modules' tensors (``ops/program.py``'s
``ModuleTensors``), which walks the modules only on a change of their
structure. On a card only (``gpu``): a capture that fails raises for the
plan, the train step and the augmentation, naming the key, and keeps no
program. The ``gpu`` tests run without JAX:
``python -m pytest tests/test_torch_program.py -m gpu --noconftest``.
"""

import copy

import numpy as np
import pytest
import torch
from torch import nn

from autonomous_driving_with_diffusion_model_tpu_torch.data import augment as aug
from autonomous_driving_with_diffusion_model_tpu_torch.diffusion import grid_chain, make_distill_step, make_schedule
from autonomous_driving_with_diffusion_model_tpu_torch.driving import DiffusionPlanner
from autonomous_driving_with_diffusion_model_tpu_torch.models import build_model
from autonomous_driving_with_diffusion_model_tpu_torch.ops import kernels
from autonomous_driving_with_diffusion_model_tpu_torch.ops.program import ModuleTensors
from autonomous_driving_with_diffusion_model_tpu_torch.train import create_train_state, make_train_step
from autonomous_driving_with_diffusion_model_tpu_torch.train.cli import iteration_generators
from autonomous_driving_with_diffusion_model_tpu_torch.train.program import DistillProgram, TrainProgram
from autonomous_driving_with_diffusion_model_tpu_torch.train.state import TrainStep
from autonomous_driving_with_diffusion_model_tpu_torch.utils import profiling
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


def _half(t: torch.Tensor) -> torch.Tensor:
    return t.detach() * 0.5


def _bn(model):
    return next(m for m in model.modules() if isinstance(m, nn.BatchNorm2d))


def _write_data(model, _other):
    weight = model.final_conv[-1].weight
    weight.data = _half(weight)
    return weight


def _assign_parameter(model, _other):
    conv = model.final_conv[-1]
    conv.weight = nn.Parameter(_half(conv.weight))
    return conv.weight


def _register_buffer(model, _other):
    bn = _bn(model)
    bn.register_buffer("running_var", bn.running_var * 2)
    return bn.running_var


def _replace_in_module_list(model, _other):
    model.downs[0][0] = copy.deepcopy(model.downs[0][0])
    return next(model.downs[0][0].parameters())


def _replace_in_sequential(model, _other):
    layer = model.perception.layer1
    layer[0] = copy.deepcopy(layer[0])
    return layer[0].bn1.running_mean


# each way of writing the planner's weights after a plan: (model, a model of
# other weights) -> a tensor the model holds after the write
WRITES = {
    "copy_": lambda model, other: model.final_conv[-1].weight.copy_(other.final_conv[-1].weight),
    "load_state_dict": lambda model, other: (model.load_state_dict(other.state_dict()), _bn(model).running_mean)[1],
    "load_state_dict_assign": lambda model, other: (model.load_state_dict(other.state_dict(), assign=True),
                                                    _bn(model).running_mean)[1],
    "data": _write_data,
    "to_dtype": lambda model, _other: _bn(model.to(torch.float64).to(torch.float32)).running_mean,
    "parameter_attribute": _assign_parameter,
    "buffer_registered": _register_buffer,
    "module_list_item": _replace_in_module_list,
    "sequential_item": _replace_in_sequential,
}


@pytest.mark.parametrize("how", list(WRITES))
def test_a_weight_written_after_a_plan_is_a_new_generation(how):
    """Weights written after a plan, by any path: the next plan follows the
    next generation; and the tensor the model holds after the write is
    followed in turn, so an in-place write to it is one more."""
    cfg = _cfg()
    cfg.MODEL.PERCEPTION = "resnet18"  # BatchNorm: buffers as well as parameters
    planner = DiffusionPlanner(cfg, seed=0, device="cpu")
    other = build_model(cfg, device="cpu", seed=1)
    program = planner._program
    frame = np.random.default_rng(0).integers(0, 256, (*HW, 3), dtype=np.uint8)
    planner.plan(frame)
    planner.plan(frame)
    assert program.generation == 0
    with torch.no_grad():
        held = WRITES[how](planner.model, other)
    planner.plan(frame)
    assert program.generation == 1 and list(program.programs) == [program.key]
    with torch.no_grad():
        held.mul_(0.5)
    planner.plan(frame)
    assert program.generation == 2 and list(program.programs) == [program.key]


def test_plans_with_nothing_written_walk_the_modules_once():
    """Plans that write nothing keep one generation and walk the modules
    once, whatever registers into modules outside the planner's; a
    registration into one of its modules walks them again, and keeps the
    generation where it changed no tensor."""
    profiling.reset()
    planner = DiffusionPlanner(_cfg(), seed=0, device="cpu")
    program, frame = planner._program, np.random.default_rng(0).integers(0, 256, (*HW, 3), dtype=np.uint8)
    for _ in range(4):
        planner.plan(frame)
    nn.Sequential(nn.Linear(2, 2), nn.Mish())[1:]  # registrations into modules that are not the planner's
    planner.plan(frame)
    assert program.generation == 0 and program.weights.walks == 1
    assert profiling.report()["counters"]["weights_walks.plan"]["count"] == 1
    planner.model.final_conv = planner.model.final_conv  # the same submodule registered again
    planner.plan(frame)
    planner.plan(frame)
    assert program.generation == 0 and program.weights.walks == 2
    assert profiling.report()["counters"]["weights_walks.plan"]["count"] == 2


class _Tree(nn.Module):
    def __init__(self):
        super().__init__()
        self.linear = nn.Linear(2, 2)
        self.items = nn.ModuleList([nn.Linear(2, 2), nn.Linear(2, 2)])
        self.chain = nn.Sequential(nn.Linear(2, 2), nn.BatchNorm1d(2))
        self.spare = [nn.Linear(2, 2)]  # made before the follower's first walk; not in the tree


def _replace_buffer_unregistered(tree):
    tree.chain[1]._buffers["running_mean"] = torch.ones(2)  # as Module.to replaces buffers


# changes of a tree that register nothing: (the change, walks after it)
UNREGISTERED = {
    "delete_a_parameter": (lambda tree: delattr(tree.linear, "bias"), 2),
    "delete_a_buffer": (lambda tree: delattr(tree.chain[1], "running_var"), 2),
    "module_list_insert": (lambda tree: tree.items.insert(0, tree.spare[0]), 2),
    "module_list_delete": (lambda tree: tree.items.__delitem__(0), 2),
    "sequential_delete": (lambda tree: tree.chain.__delitem__(1), 2),
    "buffer_replaced_in_its_slot": (_replace_buffer_unregistered, 1),
}


@pytest.mark.parametrize("change", list(UNREGISTERED))
def test_a_change_that_registers_nothing_moves_the_key(change):
    """A deletion or an insertion that registers nothing changes the number
    of entries in a module's dicts: the follower walks again; a tensor put
    into its slot without a registration is keyed without a walk."""
    tree = _Tree()
    follower = ModuleTensors([tree])
    key = follower.key()
    assert follower.key() == key and follower.walks == 1
    write, walks = UNREGISTERED[change]
    write(tree)
    assert follower.key() != key and follower.walks == walks
    assert follower.key() == ModuleTensors([tree]).key()


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
