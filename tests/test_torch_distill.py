"""The port's progressive distillation (``diffusion/distill.py``, the
per-row DDIM step, the schedule's tensor timesteps) against the JAX
package's on the CPU: the grids, the implied-x0 target, the per-row DDIM
update against a loop of the scalar step, and one and three distill steps
against JAX's ``make_distill_step`` from the same teacher weights, batch and
draws (derived from JAX's key as JAX's step splits it), under no guidance
and CFG, with the truncated-SNR weight on and off.

Tolerances, as ``tests/test_torch_train.py`` holds the train step: the
loss to 2e-5 relative; the first step's gradients, read from JAX's first
Adam moment (mu_1 = (1 - b1) g), to 1e-4 of each tensor's largest plus 1e-7
w, where w is the largest truncated-SNR weight of the step's rows (1 with
the weight off): float32 rounding noise in a gradient whose exact value is
0 (a conv bias in front of a GroupNorm of one channel per group) grows with
the weight that scales the loss. After three steps every element of the
parameters and of the EMA shadow within Adam's bound (two LRs per update),
and each tensor's update over its elements whose first gradient is not near
0 (below 1e-6 w or 1e-3 of the tensor's largest) to 1e-3 of the update's
norm; the moments to 1e-6 + 1e-4 relative (mu) and 1e-9 + 1e-3 relative
(nu).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from autonomous_driving_with_diffusion_model_tpu.diffusion import (
    StepConfig as JaxStepConfig,
    ddim_step as jax_ddim_step,
    grid_chain as jax_grid_chain,
    halve_grid as jax_halve_grid,
    implied_x0_target as jax_implied_x0,
    initial_grid as jax_initial_grid,
    make_distill_step as jax_make_distill_step,
    make_schedule as jax_make_schedule,
)
from autonomous_driving_with_diffusion_model_tpu.models import build_model as jax_build_model
from autonomous_driving_with_diffusion_model_tpu.utils.config import create_cfg as jax_create_cfg
from autonomous_driving_with_diffusion_model_tpu.utils.constants import GuidanceType as JaxGuidance
from autonomous_driving_with_diffusion_model_tpu_torch.diffusion import (
    DistillDraws,
    StepConfig,
    ddim_step,
    ddim_step_rows,
    grid_chain,
    halve_grid,
    implied_x0_target,
    initial_grid,
    make_distill_step,
    make_schedule,
)
from autonomous_driving_with_diffusion_model_tpu_torch.models import blocks, build_model, from_jax_variables
from autonomous_driving_with_diffusion_model_tpu_torch.utils.config import create_cfg
from autonomous_driving_with_diffusion_model_tpu_torch.utils.constants import GuidanceType

# one intra-op thread per process, as the training test files run
torch.set_num_threads(1)

B = 4
HW = (32, 48)
T = 10
START = 5  # the leading grid [8, 6, 4, 2, 0] -> the student's [8, 4, 0], an odd tail
BETA1 = 0.95
NOISE_GRAD = 1e-6
N_STEPS = 3
LR = 1e-3
FREE_SCALE = 2.0


def port_cfg(use_cond="NO_GUIDANCE", dim_mults=(1, 2)):
    cfg = create_cfg()
    cfg.MODEL.DIM = 8
    cfg.MODEL.DIM_MULTS = dim_mults
    cfg.MODEL.PERCEPTION = "tiny"
    cfg.TRAIN.USE_COND = use_cond
    cfg.TRAIN.TIME_STEPS = T
    cfg.TRAIN.SAMPLE_STEPS = T
    return cfg


def make_batch(seed=1):
    rng = np.random.default_rng(seed)
    return {
        "image": rng.standard_normal((B, *HW, 3)).astype(np.float32),
        "trajs": rng.uniform(-0.6, 0.6, (B, 16, 7)).astype(np.float32),
        "target": rng.standard_normal((B, 2)).astype(np.float32),
    }


def jax_draws(key, n_grid) -> DistillDraws:
    """JAX distill.py's draws: the key split in two, grid indices, then noise."""
    rng_i, rng_n = jax.random.split(key)
    i = np.asarray(jax.random.randint(rng_i, (B,), 0, n_grid))
    noise = np.asarray(jax.random.normal(rng_n, (B, 16, 7), jnp.float32))
    return DistillDraws(torch.from_numpy(i.copy()), torch.from_numpy(noise.copy()))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def jax_run(use_cond, snr_weight):
    """The teacher's variables and N_STEPS jitted JAX distill steps."""
    jcfg = jax_create_cfg()
    jcfg.merge_from_other_cfg(port_cfg(use_cond))
    model = jax_build_model(jcfg)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 7)), img=jnp.zeros((1, *HW, 3)),
                           time=jnp.asarray([1.0]))
    grid = jax_grid_chain(T, START, 1)[0]
    init_state, step = jax_make_distill_step(
        model, jax_make_schedule(num_train_timesteps=T), grid, use_cond=JaxGuidance[use_cond],
        free_scale=FREE_SCALE, lr=LR, warmup=1, snr_weight=snr_weight, decay_steps=N_STEPS)
    step = jax.jit(step)
    state = init_state(variables["params"])
    batch = jax.tree.map(jnp.asarray, make_batch())
    states, losses = [], []
    for it in range(N_STEPS):
        state, metrics = step(state, variables, variables.get("batch_stats", {}), batch, jax.random.PRNGKey(it))
        states.append(_np(state))
        losses.append(float(metrics["loss"]))
    return _np(variables), states, losses


def port_teacher(cfg, variables):
    teacher = build_model(cfg, device="cpu")
    teacher.load_state_dict(from_jax_variables(variables, cfg))
    return teacher.requires_grad_(False)


def port_run(cfg, variables, snr_weight, n_steps=N_STEPS):
    """(state, losses, lrs, the first step's gradients by name)."""
    teacher = port_teacher(cfg, variables)
    init_state, step = make_distill_step(
        make_schedule("squaredcos_cap_v2", T), grid_chain(T, START, 1)[0],
        use_cond=GuidanceType[cfg.TRAIN.USE_COND], free_scale=FREE_SCALE, lr=LR, warmup=1,
        snr_weight=snr_weight, decay_steps=N_STEPS)
    state = init_state(teacher)
    batch = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    losses, lrs, grads = [], [], None
    for it in range(n_steps):
        m = step(state, teacher, batch, draws=jax_draws(jax.random.PRNGKey(it), 3))
        losses.append(float(m["loss"]))
        lrs.append(m["lr"])
        if it == 0:
            grads = {n: p.grad.clone() for n, p in state.student.named_parameters()}
    return state, losses, lrs, grads


def as_port(tree, cfg, variables):
    return from_jax_variables({"params": tree, "batch_stats": variables.get("batch_stats", {})}, cfg)


@pytest.mark.parametrize("use_cond,snr_weight", [("NO_GUIDANCE", False), ("NO_GUIDANCE", True),
                                                 ("FREE_GUIDANCE", False), ("FREE_GUIDANCE", True)])
def test_distill_steps_match_jax(use_cond, snr_weight):
    """One step (loss, gradients) and three (parameters, moments, the EMA
    shadow) against JAX's, from the same teacher, batch and draws."""
    cfg = port_cfg(use_cond)
    variables, jstates, jlosses = jax_run(use_cond, snr_weight)
    state, losses, lrs, grads = port_run(cfg, variables, snr_weight)
    np.testing.assert_allclose(losses, jlosses, rtol=2e-5)
    np.testing.assert_allclose(lrs, [0.0, LR, LR / 2], rtol=1e-6)

    w = 1.0
    if snr_weight:  # the largest weight of the first step's rows
        sched = make_schedule("squaredcos_cap_v2", T)
        t = torch.as_tensor(grid_chain(T, START, 1)[0].ts)[jax_draws(jax.random.PRNGKey(0), 3).i]
        w = float(torch.clamp_min(sched.alpha_prod(t) / (1 - sched.alpha_prod(t)), 1.0).max())
    g_jax = {k: v / (1.0 - BETA1) for k, v in as_port(jstates[0].opt_state[0].mu, cfg, variables).items()}
    assert set(grads) == set(g_jax)
    for name, g in grads.items():
        want = g_jax[name]
        assert (g - want).abs().max() <= 1e-4 * want.abs().max() + 1e-7 * w, name

    final = jstates[-1]
    start = as_port(variables["params"], cfg, variables)
    want_params, shadow = as_port(final.params, cfg, variables), as_port(final.ema.shadow_params, cfg, variables)
    mu, nu = as_port(final.opt_state[0].mu, cfg, variables), as_port(final.opt_state[0].nu, cfg, variables)
    for (name, p), s in zip(state.student.named_parameters(), state.ema.shadow_params):
        noise = g_jax[name].abs() < max(NOISE_GRAD * w, 1e-3 * float(g_jax[name].abs().max()))
        for got, want in ((p.detach(), want_params[name]), (s, shadow[name])):
            assert ((got - want).abs() <= 2 * sum(lrs)).all(), name
            if (~noise).any():
                moved, jax_moved = (got - start[name])[~noise], (want - start[name])[~noise]
                assert (moved - jax_moved).norm() <= 1e-3 * jax_moved.norm() + 1e-6, name
        st = state.optimizer.state[p]
        torch.testing.assert_close(st["exp_avg"], mu[name], atol=1e-6, rtol=1e-4, msg=name)
        torch.testing.assert_close(st["exp_avg_sq"], nu[name], atol=1e-9, rtol=1e-3, msg=name)
    assert state.step == N_STEPS == int(final.step)
    assert state.ema.optimization_step == N_STEPS == int(final.ema.optimization_step)


def test_one_distill_step_matches_jax():
    """After one step (LR 0 at the first update) the student has not moved
    and its EMA shadow is the teacher, in both packages."""
    cfg = port_cfg()
    variables, jstates, jlosses = jax_run("NO_GUIDANCE", False)
    state, losses, _, _ = port_run(cfg, variables, False, n_steps=1)
    np.testing.assert_allclose(losses, jlosses[:1], rtol=2e-5)
    start = as_port(variables["params"], cfg, variables)
    shadow = as_port(jstates[0].ema.shadow_params, cfg, variables)
    for (name, p), s in zip(state.student.named_parameters(), state.ema.shadow_params):
        assert torch.equal(p.detach(), start[name]), name
        torch.testing.assert_close(s, shadow[name], atol=0, rtol=0, msg=name)


@pytest.mark.parametrize("start_steps,stages", [(50, 10), (100, 2), (7, 3), (10, 4)])
def test_grids_match_jax(start_steps, stages):
    for ours, theirs in zip(initial_grid(100, start_steps), jax_initial_grid(100, start_steps)):
        np.testing.assert_array_equal(ours, theirs)
    got, want = grid_chain(100, start_steps, stages), jax_grid_chain(100, start_steps, stages)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    with pytest.raises(ValueError):
        halve_grid(np.asarray([5]), np.asarray([-1]))
    with pytest.raises(ValueError):
        jax_halve_grid(np.asarray([5]), np.asarray([-1]))


def test_implied_target_and_row_step_match_jax():
    """``implied_x0_target`` and the per-row DDIM step against JAX's (its
    ``ddim_step`` vmapped over the rows, as JAX's distill step runs it), with
    terminal (negative) prevs; the per-row step against a loop of the
    port's scalar step, row by row; and the target inverts the step."""
    rng = np.random.default_rng(4)
    n = 8
    x_t = rng.standard_normal((n, 16, 7)).astype(np.float32)
    x_s = rng.standard_normal((n, 16, 7)).astype(np.float32)
    out = rng.uniform(-1.5, 1.5, (n, 16, 7)).astype(np.float32)
    t = np.array([99, 80, 51, 40, 10, 3, 1, 0], np.int64)
    s = np.array([79, 60, 40, -1, -20, 1, 0, -1], np.int64)
    sched, jsched = make_schedule("squaredcos_cap_v2", 100), jax_make_schedule(num_train_timesteps=100)
    tt, ts = torch.from_numpy(t), torch.from_numpy(s)

    got = implied_x0_target(sched, torch.from_numpy(x_t), torch.from_numpy(x_s), tt, ts)
    want = jax_implied_x0(jsched, jnp.asarray(x_t), jnp.asarray(x_s), jnp.asarray(t, jnp.int32),
                          jnp.asarray(s, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(sched.alpha_prod_prev(ts).numpy(),
                                  np.asarray(jsched.alpha_prod_prev(jnp.asarray(s, jnp.int32))))

    for cfg in (StepConfig(prediction_type="sample", clip_sample=True),
                StepConfig(prediction_type="sample", clip_sample=False, thresholding=True, sample_max_value=1.5)):
        rows = ddim_step_rows(sched, cfg, torch.from_numpy(out), tt, ts, torch.from_numpy(x_t))
        jcfg = JaxStepConfig(**cfg._asdict())
        jrows = jax.vmap(lambda mo, a, b, x: jax_ddim_step(jsched, jcfg, mo[None], a, b, x[None])[0][0])(
            jnp.asarray(out), jnp.asarray(t, jnp.int32), jnp.asarray(s, jnp.int32), jnp.asarray(x_t))
        np.testing.assert_allclose(rows.numpy(), np.asarray(jrows), rtol=1e-6, atol=1e-6)
        for r in range(n):
            one, _ = ddim_step(sched, cfg, torch.from_numpy(out[r:r + 1]), int(t[r]), int(s[r]),
                               torch.from_numpy(x_t[r:r + 1]))
            torch.testing.assert_close(rows[r:r + 1], one, atol=0, rtol=0)
    with pytest.raises(ValueError, match="eta"):
        ddim_step_rows(sched, StepConfig(eta=0.5), torch.from_numpy(out), tt, ts, torch.from_numpy(x_t))

    # a student that outputs the target lands on x_s (clip off, |z| unbounded)
    cfg = StepConfig(prediction_type="sample", clip_sample=False)
    back = ddim_step_rows(sched, cfg, got, tt, ts, torch.from_numpy(x_t))
    np.testing.assert_allclose(back.numpy(), x_s, atol=2e-4)


def test_distill_refuses_what_jax_refuses():
    sched, grid = make_schedule("squaredcos_cap_v2", T), grid_chain(T, START, 1)[0]
    with pytest.raises(ValueError, match="x0"):
        make_distill_step(sched, grid, step_cfg=StepConfig(prediction_type="epsilon"))
    with pytest.raises(ValueError, match="CLASSIFIER_GUIDANCE"):
        make_distill_step(sched, grid, use_cond=GuidanceType.CLASSIFIER_GUIDANCE)
    jsched, jgrid = jax_make_schedule(num_train_timesteps=T), jax_grid_chain(T, START, 1)[0]
    with pytest.raises(ValueError, match="x0"):
        jax_make_distill_step(None, jsched, jgrid, step_cfg=JaxStepConfig(prediction_type="epsilon"))
    with pytest.raises(ValueError, match="CLASSIFIER_GUIDANCE"):
        jax_make_distill_step(None, jsched, jgrid, use_cond=JaxGuidance.CLASSIFIER_GUIDANCE)
    # and the step needs its draws
    cfg = port_cfg()
    init_state, step = make_distill_step(sched, grid)
    teacher = build_model(cfg, device="cpu").requires_grad_(False)
    batch = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    with pytest.raises(ValueError, match="draws"):
        step(init_state(teacher), teacher, batch)
    losses = [float(step(init_state(teacher), teacher, batch, generator=torch.Generator().manual_seed(3))["loss"])
              for _ in range(2)]
    assert losses[0] == losses[1]


def _counting(monkeypatch):
    """Count the blocks' kernel calls, with and without a gradient."""
    counts = {"fused_residual_block": [0, 0], "fused_conv1d_gn_mish": [0, 0]}
    for name in counts:
        real = getattr(blocks, name)

        def wrapped(*args, _real=real, _name=name, **kw):
            grad = torch.is_grad_enabled() and any(isinstance(a, torch.Tensor) and a.requires_grad for a in args)
            counts[_name][int(grad)] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(blocks, name, wrapped)
    return counts


@pytest.mark.parametrize("use_cond", ["NO_GUIDANCE", "FREE_GUIDANCE"])
def test_launches_per_step_and_packs(monkeypatch, use_cond):
    """A distill step at the full U-Net depth (DIM_MULTS 1, 2, 4, 8: 16
    residual blocks) calls the residual kernel 32 times without a gradient
    (the teacher's two forwards; 64 under CFG) and 16 with one (the
    student's), the head 2 + 1 (4 + 1), whatever the draws. The student's
    packs follow its weights after every AdamW step; the teacher's are
    built once and never change."""
    cfg = port_cfg(use_cond, dim_mults=(1, 2, 4, 8))
    teacher = build_model(cfg, device="cpu", seed=2).requires_grad_(False)
    sched = make_schedule("squaredcos_cap_v2", T)
    init_state, step = make_distill_step(sched, grid_chain(T, START, 1)[0], use_cond=GuidanceType[use_cond],
                                         lr=LR, warmup=0)
    state = init_state(teacher)
    batch = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    counts = _counting(monkeypatch)
    s_blocks = [m for m in state.student.modules()
                if isinstance(m, (blocks.ResidualTemporalMapBlock, blocks.Conv1dBlock))]
    packs = None
    guided = 2 if use_cond == "FREE_GUIDANCE" else 1
    for it in range(3):
        for c in counts.values():
            c[:] = [0, 0]
        step(state, teacher, batch, generator=torch.Generator().manual_seed(it))
        assert counts == {"fused_residual_block": [32 * guided, 16], "fused_conv1d_gn_mish": [2 * guided, 1]}
        # the modules that launch a kernel: 16 residual blocks and the head
        t_blocks = [m for m in teacher.modules() if "_kernel_params" in m.__dict__]
        assert len(t_blocks) == 17
        now = [tuple(id(a) for a in m._kernel_params[torch.float32][1]) for m in t_blocks]
        assert packs is None or now == packs  # cached once, never rebuilt
        packs = now
        with torch.no_grad():
            for m in s_blocks:  # the serving pack of the student's current weights
                conv = m.blocks[0].block[0] if isinstance(m, blocks.ResidualTemporalMapBlock) else m.block[0]
                torch.testing.assert_close(m.kernel_params()[0], conv.weight.permute(2, 1, 0), atol=0, rtol=0)
    moved = [not torch.equal(a, b) for a, b in zip(state.student.parameters(), teacher.parameters())]
    assert all(moved[-4:])  # the head moved off the teacher
    for m in t_blocks:
        conv = m.blocks[0].block[0] if isinstance(m, blocks.ResidualTemporalMapBlock) else m.block[0]
        torch.testing.assert_close(m._kernel_params[torch.float32][1][0], conv.weight.permute(2, 1, 0),
                                   atol=0, rtol=0)
