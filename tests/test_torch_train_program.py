"""The training-side programs (``train/program.py``): the train step, the
distill step and the scorer fit on fixed buffers, a CUDA graph per key on
a card.

On the CPU, where a program runs its step on its buffers: the program
against the eager step bit for bit over three steps (every parameter,
moment, EMA shadow, BatchNorm buffer and the loss), in the three guidance
modes, BN frozen and train, REMAT and G = 2; the program against JAX's
jitted step at ``tests/test_torch_train.py``'s tolerances; the LR and EMA
scalars against the schedules across the warmup and past the EMA's
activation; the distill program against JAX's distill step at
``tests/test_torch_distill.py``'s; the scorer's replayed step against JAX's
``train_scorer`` at ``tests/test_torch_scorer.py``'s; the ``_version``
bump after a replay, read by the kernel packs and the plan program; and
draws given without a dropout generator.

On a card only (``gpu``): graph against eager bit for bit with TF32 off,
a plan and a sample after graph steps against a fresh model's (a failed
capture raising: ``tests/test_torch_program.py``). JAX is imported inside the tests that compare with it, so
that the ``gpu`` tests also run without JAX:
``python -m pytest tests/test_torch_train_program.py -m gpu --noconftest``.
"""

import copy

import numpy as np
import pytest
import torch

from autonomous_driving_with_diffusion_model_tpu_torch.diffusion import make_schedule
from autonomous_driving_with_diffusion_model_tpu_torch.models import blocks, build_model
from autonomous_driving_with_diffusion_model_tpu_torch.ops import kernels
from autonomous_driving_with_diffusion_model_tpu_torch.train import create_train_state, make_train_step
from autonomous_driving_with_diffusion_model_tpu_torch.train.cli import iteration_generators
from autonomous_driving_with_diffusion_model_tpu_torch.train.ema import ema_decay_for_step
from autonomous_driving_with_diffusion_model_tpu_torch.train.program import (
    DistillProgram,
    TrainProgram,
    replay_steps,
)
from autonomous_driving_with_diffusion_model_tpu_torch.train.state import (
    TrainStep,
    _cosine_schedule,
    ema_config,
    make_lr_schedule,
    make_optimizer,
)
from autonomous_driving_with_diffusion_model_tpu_torch.utils.config import create_cfg

torch.set_num_threads(1)

B = 4
HW = (32, 48)
N_STEPS = 3

# (USE_COND, BN_MODE, REMAT, G): the three guidance modes, BN train, REMAT
# (with the classifier's dropout, whose masks the recompute must redraw) and
# two micro-batches
CASES = [
    ("NO_GUIDANCE", "frozen", False, 1),
    ("FREE_GUIDANCE", "frozen", False, 1),
    ("CLASSIFIER_GUIDANCE", "frozen", False, 1),
    ("NO_GUIDANCE", "train", False, 1),
    ("CLASSIFIER_GUIDANCE", "frozen", True, 1),
    ("NO_GUIDANCE", "train", True, 1),
    ("FREE_GUIDANCE", "train", False, 2),
]


def cfg_of(use_cond="NO_GUIDANCE", bn_mode="frozen", remat=False, groups=1, perception="tiny"):
    cfg = create_cfg()
    cfg.MODEL.DIM = 64 if use_cond == "CLASSIFIER_GUIDANCE" else 8
    cfg.MODEL.DIM_MULTS = (1, 2)
    cfg.MODEL.PERCEPTION = perception
    cfg.TRAIN.USE_COND = use_cond
    cfg.TRAIN.TIME_STEPS = 10
    cfg.TRAIN.SAMPLE_STEPS = 10
    cfg.TRAIN.LR = 1e-3
    cfg.TRAIN.LR_WARMUP = 1
    cfg.TRAIN.IMAGE_HEIGHT, cfg.TRAIN.IMAGE_WIDTH = HW
    cfg.TPU.BN_MODE = bn_mode
    cfg.TPU.REMAT = remat
    cfg.TRAIN.GRADIENT_ACCUMULATION_STEPS = groups
    return cfg


def batch_of(device="cpu", seed=1, batch=B):
    rng = np.random.default_rng(seed)
    return {
        "image": torch.from_numpy(rng.standard_normal((batch, *HW, 3)).astype(np.float32)).to(device),
        "trajs": torch.from_numpy((rng.standard_normal((batch, 16, 7)) * 0.3).astype(np.float32)).to(device),
        "target": torch.from_numpy(rng.standard_normal((batch, 2)).astype(np.float32)).to(device),
    }


def twin_states(cfg, device="cpu"):
    """Two train states from the same weights (seed 0)."""
    model = build_model(cfg, device=device, seed=0)
    return create_train_state(model, cfg), create_train_state(copy.deepcopy(model), cfg)


def assert_states_equal(a, b):
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[k], sb[k]), (name, k)
    for (name, x), y in zip(a.model.named_buffers(), b.model.buffers()):
        assert torch.equal(x, y), name
    for s, t in zip(a.ema.shadow_params, b.ema.shadow_params, strict=True):
        assert torch.equal(s, t)
    assert (a.step, a.ema.optimization_step, a.scheduler.last_epoch) == \
           (b.step, b.ema.optimization_step, b.scheduler.last_epoch)


def run_turns(cfg, device="cpu", n_steps=N_STEPS):
    """The eager step on one state and the program on its twin, in turns,
    from the same batch and iteration generators: (eager metrics, program
    metrics, states, program, launches of each eager step, of each program
    step)."""
    eager_state, prog_state = twin_states(cfg, device)
    schedule = make_schedule(cfg.TRAIN.NOISE_SCHEDULER.TYPE, cfg.TRAIN.SAMPLE_STEPS, device=device)
    step = make_train_step(schedule, cfg)
    program = TrainProgram(make_train_step(schedule, cfg), device)
    batch = batch_of(device)
    eager, graph, eager_launches, graph_launches = [], [], [], []
    for it in range(n_steps):
        kernels.reset_launch_counts()
        eager.append(step(eager_state, batch, generator=iteration_generators(it, device)[1]))
        eager_launches.append(kernels.launch_counts())
        kernels.reset_launch_counts()
        graph.append(program(prog_state, batch, generator=iteration_generators(it, device)[1]))
        graph_launches.append(kernels.launch_counts())
    return eager, graph, (eager_state, prog_state), program, eager_launches, graph_launches


@pytest.mark.parametrize("use_cond,bn_mode,remat,groups", CASES)
def test_program_equals_the_eager_step(use_cond, bn_mode, remat, groups):
    cfg = cfg_of(use_cond, bn_mode, remat, groups)
    eager, graph, (a, b), program, le, lg = run_turns(cfg)
    for m, n in zip(eager, graph):
        assert torch.equal(m["loss"], n["loss"]) and (m["lr"], m["ema_decay"]) == (n["lr"], n["ema_decay"])
    assert_states_equal(a, b)
    assert le == lg  # no launches on the CPU: the wrappers count the card's
    assert len(program.programs) == 1  # one key for the three steps


def test_new_batch_shape_is_a_new_key_and_new_state_a_new_generation():
    cfg = cfg_of()
    state, _ = twin_states(cfg)
    program = TrainProgram(make_train_step(make_schedule("squaredcos_cap_v2", 10), cfg), "cpu")
    for batch in (batch_of(), batch_of(batch=2), batch_of()):
        program(state, batch, generator=torch.Generator().manual_seed(0))
    assert sorted(k[0][0][1] for k in program.programs) == [(2, *HW, 3), (B, *HW, 3)]
    generation = program.key[-1]
    state.model.load_state_dict(build_model(cfg, device="cpu", seed=3).state_dict())  # written from outside
    program(state, batch_of(), generator=torch.Generator().manual_seed(0))
    assert program.key[-1] == generation + 1 and len(program.programs) == 1


@pytest.mark.parametrize("use_cond", ["NO_GUIDANCE", "FREE_GUIDANCE", "CLASSIFIER_GUIDANCE"])
def test_program_matches_jax_jitted_step(use_cond):
    """Three program steps against JAX's jitted step from the same weights,
    batch and draws (``tests/test_torch_train.py``'s tolerances)."""
    import jax
    from test_torch_train import check_against_jax, jax_draws, jax_run, make_batch, no_dropout, port_cfg, port_model

    cfg = port_cfg(use_cond)
    jax_result = jax_run(use_cond)
    model = port_model(cfg, jax_result[0])
    if use_cond == "CLASSIFIER_GUIDANCE":
        no_dropout(model)
    state = create_train_state(model, cfg)
    program = TrainProgram(make_train_step(make_schedule(cfg.TRAIN.NOISE_SCHEDULER.TYPE, cfg.TRAIN.SAMPLE_STEPS),
                                           cfg), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    losses, lrs, decays, grads = [], [], [], None
    for i in range(N_STEPS):
        m = program(state, batch, jax_draws(jax.random.PRNGKey(i), cfg))
        losses.append(float(m["loss"]))
        lrs.append(m["lr"])
        decays.append(m["ema_decay"])
        if i == 0:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    check_against_jax(cfg, jax_result, (state, losses, lrs, decays, grads))


@pytest.mark.parametrize("warmup,decay_steps", [(3, 0), (0, 0), (2, 6), (1, 1)])
def test_lr_scalar_follows_the_schedules(warmup, decay_steps):
    """The optimizer's LR scalar before update k holds the update's LR,
    ``make_lr_schedule`` or ``_cosine_schedule`` at k in float32, as the
    JAX schedules give it (``tests/test_torch_train.py`` holds the two to
    JAX's), through the warmup and past the decay's end."""
    p = torch.nn.Parameter(torch.zeros(3))
    opt, sched = make_optimizer([p], 1e-3, warmup, decay_steps)
    fn = _cosine_schedule(1e-3, warmup, decay_steps) if decay_steps else make_lr_schedule(1e-3, warmup)
    for k in range(decay_steps + warmup + 4):
        lr = opt.param_groups[0]["lr"]
        assert lr.dtype == torch.float32 and lr.shape == ()
        assert float(lr) == float(np.float32(fn(k))) == sched.get_last_lr()[0], k
        p.grad = torch.ones(3)
        opt.step()
        sched.step()


def test_ema_scalar_follows_the_decay_past_its_activation():
    """The EMA's scalar holds 1 - ``ema_decay_for_step`` of each update,
    0 up to update_after_step + 1 (5001) and the warmup decay after; three
    program steps across it move the shadow by ``s - (1 - d) (s - p)``."""
    from autonomous_driving_with_diffusion_model_tpu.train import EmaConfig as JaxEmaConfig
    from autonomous_driving_with_diffusion_model_tpu.train import ema_decay_for_step as jax_ema_decay

    cfg = cfg_of()
    state, _ = twin_states(cfg)
    ecfg = ema_config(cfg)
    jcfg = JaxEmaConfig(decay=ecfg.decay, update_after_step=ecfg.update_after_step,
                        use_ema_warmup=ecfg.use_ema_warmup, inv_gamma=ecfg.inv_gamma, power=ecfg.power)
    step = TrainStep(make_schedule("squaredcos_cap_v2", 10), cfg)
    for k in (0, 1, 4999, 5000, 5001, 5002, 6000, 10**6):
        state.ema.optimization_step = k
        lr, decay = step.begin(state)
        assert decay == ema_decay_for_step(ecfg, k + 1) == float(jax_ema_decay(jcfg, k + 1)), k
        assert state.ema.factor.dtype == torch.float32
        assert float(state.ema.factor) == float(np.float32(1.0) - np.float32(decay)), k
    assert ema_decay_for_step(ecfg, 5001) == 0.0 and ema_decay_for_step(ecfg, 5002) > 0.0

    state.ema.optimization_step = 4999
    state.scheduler.set_epoch(4999)
    state.step = 4999
    program = TrainProgram(step, "cpu")
    decays = []
    for it in range(3):
        before = [s.clone() for s in state.ema.shadow_params]
        m = program(state, batch_of(), generator=iteration_generators(it, "cpu")[1])
        decays.append(m["ema_decay"])
        f = np.float32(1.0) - np.float32(m["ema_decay"])
        for s0, s, p in zip(before, state.ema.shadow_params, state.model.parameters()):
            assert torch.equal(s, s0 - (s0 - p.detach()) * torch.tensor(f))
        assert m["lr"] == float(np.float32(cfg.TRAIN.LR))
    assert decays[:2] == [0.0, 0.0] and decays[2] == ema_decay_for_step(ecfg, 5002) > 0.0
    assert state.step == state.ema.optimization_step == 5002


@pytest.mark.parametrize("use_cond", ["NO_GUIDANCE", "FREE_GUIDANCE"])
def test_distill_program_matches_jax(use_cond):
    """Three distill steps through the program against JAX's jitted distill
    step (``tests/test_torch_distill.py``'s tolerances)."""
    import test_torch_distill as td
    from autonomous_driving_with_diffusion_model_tpu_torch.diffusion import grid_chain, make_distill_step
    from autonomous_driving_with_diffusion_model_tpu_torch.utils.constants import GuidanceType

    import jax

    cfg = td.port_cfg(use_cond)
    variables, jstates, jlosses = td.jax_run(use_cond, False)
    teacher = td.port_teacher(cfg, variables)
    init_state, step = make_distill_step(
        make_schedule("squaredcos_cap_v2", td.T), grid_chain(td.T, td.START, 1)[0],
        use_cond=GuidanceType[use_cond], free_scale=td.FREE_SCALE, lr=td.LR, warmup=1, decay_steps=td.N_STEPS)
    state = init_state(teacher)
    program = DistillProgram(step, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in td.make_batch().items()}
    losses, lrs = [], []
    for it in range(td.N_STEPS):
        m = program(state, teacher, batch, draws=td.jax_draws(jax.random.PRNGKey(it), 3))
        losses.append(float(m["loss"]))
        lrs.append(m["lr"])
    np.testing.assert_allclose(losses, jlosses, rtol=2e-5)
    np.testing.assert_allclose(lrs, [0.0, td.LR, td.LR / 2], rtol=1e-6)
    final = jstates[-1]
    start = td.as_port(variables["params"], cfg, variables)
    want_params = td.as_port(final.params, cfg, variables)
    shadow = td.as_port(final.ema.shadow_params, cfg, variables)
    g_jax = {k: v / (1.0 - td.BETA1) for k, v in td.as_port(jstates[0].opt_state[0].mu, cfg, variables).items()}
    for (name, p), s in zip(state.student.named_parameters(), state.ema.shadow_params):
        noise = g_jax[name].abs() < max(td.NOISE_GRAD, 1e-3 * float(g_jax[name].abs().max()))
        for got, want in ((p.detach(), want_params[name]), (s, shadow[name])):
            assert ((got - want).abs() <= 2 * sum(lrs)).all(), name
            if (~noise).any():
                moved, jax_moved = (got - start[name])[~noise], (want - start[name])[~noise]
                assert (moved - jax_moved).norm() <= 1e-3 * jax_moved.norm() + 1e-6, name
    assert state.step == td.N_STEPS == int(final.step) and len(program.programs) == 1


def test_scorer_replayed_step_matches_jax_train_scorer():
    """``scorer_step`` run by ``replay_steps`` (the scorer fit's program) for
    50 steps against JAX's ``train_scorer`` from the same init, on the
    training rows JAX's split takes (``tests/test_torch_scorer.py``'s
    tolerance on the parameters)."""
    import jax

    from autonomous_driving_with_diffusion_model_tpu.models import scorer as jscorer
    from autonomous_driving_with_diffusion_model_tpu_torch.models.scorer import HypothesisScorer, scorer_step
    from test_torch_scorer import _outcome_set

    trajs, targets, outcomes, _ = _outcome_set()
    start = jax.tree.map(np.asarray, jscorer.init_scorer(3, 16, 7))
    want_params, want = jscorer.train_scorer(trajs, targets, outcomes, seed=3, steps=50)
    tr = np.setdiff1d(np.arange(len(trajs)), want["val_indices"])
    mu, sd = float(outcomes[tr].mean()), float(outcomes[tr].std() + 1e-8)
    net = HypothesisScorer.from_params(start)
    step = scorer_step(net, torch.from_numpy(trajs[tr]), torch.from_numpy(targets[tr]),
                          torch.from_numpy(((outcomes - mu) / sd)[tr]), lr=3e-3, weight_decay=0.1)
    loss, info = replay_steps(step, 50, "cpu", list(net.parameters()))
    np.testing.assert_allclose(float(loss), want["final_train_loss"], rtol=1e-4)
    got_params = net.params()
    for layer, leaves in want_params.items():
        for name, w in leaves.items():
            w, s0 = np.asarray(w), np.asarray(start[layer][name])
            np.testing.assert_allclose(got_params[layer][name], w, atol=1e-4 * np.abs(w - s0).max() + 1e-7, rtol=0,
                                       err_msg=f"{layer}/{name}")
    assert info["replays"] == 0  # the CPU loops


def test_replay_bumps_versions_so_packs_and_plan_programs_refresh():
    """Weights written past their ``_version``, as a graph's replay writes
    them, leave the packs stale; the program's replay bumps the version of
    what it wrote, so the packs and the plan program take the new
    weights."""
    from autonomous_driving_with_diffusion_model_tpu_torch.driving import DiffusionPlanner
    from autonomous_driving_with_diffusion_model_tpu_torch.ops import program

    cfg = cfg_of()
    planner = DiffusionPlanner(cfg, seed=0, device="cpu")
    frame = np.random.default_rng(0).integers(0, 256, (*HW, 3), dtype=np.uint8)
    planner.plan(frame)
    head = next(m for m in planner.model.modules() if isinstance(m, blocks.Conv1dBlock))
    weight = head.block[0].weight
    with torch.no_grad():
        old = head.kernel_params()[0].clone()

    class Replayed:  # a captured graph's stand-in: it writes past the version counter
        def replay(self):
            version = weight._version
            weight.data.mul_(2.0)
            assert weight._version == version
            with torch.no_grad():
                assert torch.equal(head.kernel_params()[0], old)  # stale until the bump

    prog = program.Program({})
    prog.graph, prog.outputs = Replayed(), torch.zeros(())
    generation = planner._program.generation
    program.Programs.replay(prog, list(planner.model.parameters()))
    with torch.no_grad():
        assert torch.equal(head.kernel_params()[0], weight.permute(2, 1, 0))
    planner.plan(frame)
    assert planner._program.generation == generation + 1


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_draws_without_a_dropout_generator_take_the_default(device):
    """Given draws whose ``dropout`` is None under classifier guidance, the
    program draws the dropout masks from the device's default generator, as
    the eager step does (on a card: the eager step, the capture, then
    replays)."""
    if device == "cuda":
        _need_card()
    from autonomous_driving_with_diffusion_model_tpu_torch.train.state import draw_step

    cfg = cfg_of("CLASSIFIER_GUIDANCE")
    a, b = twin_states(cfg, device)
    schedule = make_schedule("squaredcos_cap_v2", 10, device=device)
    step, program = make_train_step(schedule, cfg), TrainProgram(make_train_step(schedule, cfg), device)
    batch = batch_of(device)
    for it in range(N_STEPS + (device == "cuda")):
        draws = draw_step(cfg, B, torch.Generator().manual_seed(it))._replace(dropout=None)
        torch.manual_seed(it)
        m = step(a, batch, draws=draws)
        torch.manual_seed(it)
        n = program(b, batch, draws=draws)
        assert torch.equal(m["loss"], n["loss"]), it
    assert_states_equal(a, b)
    assert (program.programs[program.key].graph is not None) == (device == "cuda")


# ------------------------------------------------------------------ card


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph and the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuDNN's default backward algorithms sum with atomics: two eager steps
    # from one state would differ in their last bits
    torch.backends.cudnn.deterministic = True


@pytest.mark.gpu
@pytest.mark.parametrize("use_cond,bn_mode,remat,groups", CASES)
def test_graph_equals_eager_on_card(use_cond, bn_mode, remat, groups):
    """Four steps: the first eager (and the capture), three replays, each
    bit-identical to the eager step on the twin state; a replay counts the
    launches the eager step counts, as the capture recorded them."""
    _need_card()
    eager, graph, (a, b), program, le, lg = run_turns(cfg_of(use_cond, bn_mode, remat, groups), "cuda", 4)
    for m, n in zip(eager, graph):
        assert torch.equal(m["loss"], n["loss"])
    assert_states_equal(a, b)
    prog = program.programs[program.key]
    assert prog.graph is not None and le == lg and prog.launches == le[-1]
    assert all(le[-1][k] for k in kernels.WRAPPERS) and le[-1]["fused_residual_block.pdl"] == 0  # fresh packs


@pytest.mark.gpu
def test_plan_and_sample_after_graph_steps_use_the_new_weights_on_card():
    """A plan and a sample on the trained model after graph steps equal
    those of a fresh model loaded with the same weights: the replays moved
    the weights' ``_version``, so the packs and the plan's graph were made
    anew."""
    _need_card()
    from autonomous_driving_with_diffusion_model_tpu_torch.driving import DiffusionPlanner
    from autonomous_driving_with_diffusion_model_tpu_torch.diffusion import sampler_from_cfg

    cfg = cfg_of("FREE_GUIDANCE")
    cfg.EVAL.SAMPLE_STEPS = 2
    planner = DiffusionPlanner(cfg, seed=0, device="cuda")
    state = create_train_state(planner.model.requires_grad_(True), cfg)
    schedule = make_schedule("squaredcos_cap_v2", 10, device="cuda")
    program = TrainProgram(make_train_step(schedule, cfg), "cuda")
    frame = np.random.default_rng(0).integers(0, 256, (*HW, 3), dtype=np.uint8)
    target = np.array([0.2, -0.3], np.float32)
    image = batch_of("cuda")["image"][:1]
    init = torch.randn((1, 16, 7), generator=torch.Generator().manual_seed(0)).cuda()

    def sample(model):
        with torch.no_grad():
            return sampler_from_cfg(model.eval(), schedule, cfg)(init, image=image)

    batch = batch_of("cuda")
    program(state, batch, generator=iteration_generators(0, "cuda")[1])  # eager, then the capture
    planner.model.eval()
    planner.plan(frame, target)  # captures the plan on these weights
    sample(planner.model)  # packs them
    for it in (1, 2):
        program(state, batch, generator=iteration_generators(it, "cuda")[1])  # replays
    assert program.programs[program.key].graph is not None
    planner.model.eval()
    fresh = DiffusionPlanner(cfg, seed=0, device="cuda")
    fresh.model.load_state_dict(planner.model.state_dict())
    fresh.init_trajs = planner.init_trajs
    np.testing.assert_array_equal(planner.plan(frame, target), fresh.plan(frame, target))
    torch.testing.assert_close(sample(planner.model), sample(fresh.model), atol=0, rtol=0)


@pytest.mark.gpu
def test_augment_graph_equals_the_eager_body_on_card():
    """The augmentation program (``data/augment.py:AugmentProgram``) on the
    card replays a CUDA graph: bit-identical to the eager body on the same
    draws, call after call on one key, and a new shape is a new key."""
    from autonomous_driving_with_diffusion_model_tpu_torch.data import augment as aug

    _need_card()
    program = aug.AugmentProgram("cuda")
    rng = np.random.default_rng(4)
    for it, n in ((0, 8), (1, 8), (2, 8), (3, 6)):
        images = torch.from_numpy(rng.integers(0, 256, (n, *HW, 3), dtype=np.uint8)).cuda()
        got = program(images, torch.Generator().manual_seed(it), 6.4e8)
        want = aug.augment_batch(images, torch.Generator().manual_seed(it), 6.4e8)
        assert torch.equal(got, want), it
    assert len(program.programs) == 2 and all(p.graph is not None for p in program.programs.values())


@pytest.mark.gpu
def test_host_loader_pins_its_batches_on_card(tmp_path):
    """With ``pin_memory`` the decoder processes' batches come as
    page-locked tensors, frames equal to ``read_png``'s, and upload
    without waiting."""
    from autonomous_driving_with_diffusion_model_tpu_torch.data import Loader, TrajDataset, read_png, write_png

    _need_card()
    rng = np.random.default_rng(0)
    for sub in ("front", "waypoints"):
        (tmp_path / sub).mkdir()
    for i in range(4):
        write_png(str(tmp_path / "front" / f"{i:06d}.png"), rng.integers(0, 256, (*HW, 3), dtype=np.uint8), 4)
        (tmp_path / "waypoints" / f"{i:06d}.txt").write_text("0.1 0.2\n" + "0.5 0 0 0 0 0 0\n" * 16)
    loader = Loader(TrajDataset(str(tmp_path)), batch_size=2, num_workers=2, shuffle=False, pin_memory=True)
    try:
        for bi, batch in enumerate(loader):
            assert all(v.is_pinned() for v in batch.values())
            image = batch["image"].to("cuda", non_blocking=True)
            want = np.stack([read_png(str(tmp_path / "front" / f"{i:06d}.png")) for i in (2 * bi, 2 * bi + 1)])
            np.testing.assert_array_equal(image.cpu().numpy(), want)
    finally:
        loader.close()
