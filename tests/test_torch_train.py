"""The port's training step (train/state.py, train/ema.py) against the JAX
package's ``make_train_step`` on the CPU: the same weights (carried by
``from_jax_variables``), batch and draws (derived from JAX's key as JAX
``train/state.py:174-186`` splits it), three steps, in every ``USE_COND``
mode and with ``REMAT``; the EMA and LR schedules, AdamW against optax's
``adamw``, the NaN scrub, dropout, and the kernels' weight packs after an
optimizer step.

Tolerances: the loss to 2e-5 relative (float32 sums in other orders). The
first step's gradient, read from JAX's first Adam moment (mu_1 = (1 -
b1) g), to 1e-4 of each tensor's largest gradient plus 1e-7 (the size of
float32 rounding noise in a gradient whose exact value is 0). Parameters:
Adam moves an element by up to about one LR per update whatever its
gradient, so a gradient's rounding error can move an element whose
gradient is near 0 (below NOISE_GRAD or 1e-3 of the tensor's largest: a
conv bias in front of a GroupNorm of one channel per group and the
attention's key bias, whose exact gradients are 0) anywhere within that.
Every element is held to Adam's bound, two LRs per update, and each
tensor's update (final minus initial) over its other elements to 1e-3 of
the update's norm. Moments to 1e-6 + 1e-4 relative (mu) and 1e-9 + 1e-3
relative (nu). Before step 5000 the EMA decay is 0, so the shadow is the
parameters, to their tolerance.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from autonomous_driving_with_diffusion_model_tpu.diffusion import make_schedule as jax_make_schedule
from autonomous_driving_with_diffusion_model_tpu.models import build_model as jax_build_model
from autonomous_driving_with_diffusion_model_tpu.train import (
    EmaConfig as JaxEmaConfig,
    create_train_state as jax_create_state,
    ema_decay_for_step as jax_ema_decay,
    ema_init as jax_ema_init,
    ema_update as jax_ema_update,
    make_lr_schedule as jax_lr_schedule,
    make_train_step as jax_make_step,
)
from autonomous_driving_with_diffusion_model_tpu.train.state import make_optimizer as jax_make_optimizer
from port_jax_cfg import jax_cfg_of
from autonomous_driving_with_diffusion_model_tpu_torch.diffusion import make_schedule
from autonomous_driving_with_diffusion_model_tpu_torch.models import (
    Conv1dBlock,
    ResidualTemporalMapBlock,
    TransformerEncoderLayer,
    build_model,
    from_jax_variables,
)
from autonomous_driving_with_diffusion_model_tpu_torch.train import (
    EmaConfig,
    StepDraws,
    create_train_state,
    ema_decay_for_step,
    ema_init,
    ema_update,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
)
from autonomous_driving_with_diffusion_model_tpu_torch.utils.config import create_cfg

# one intra-op thread per process: the suite runs in several worker
# processes at once, and torch's default of a thread per core in each makes
# them contend for the cores (these files ran 3.6x as long)
torch.set_num_threads(1)

B = 4
HW = (32, 48)
BETA1 = 0.95
NOISE_GRAD = 1e-6
N_STEPS = 3


def port_cfg(use_cond="NO_GUIDANCE", perception="tiny", **opts):
    cfg = create_cfg()
    cfg.MODEL.DIM = 64 if use_cond == "CLASSIFIER_GUIDANCE" else 8
    cfg.MODEL.DIM_MULTS = (1, 2)  # two levels: both kernels, a down and an up path, half the compile
    cfg.MODEL.PERCEPTION = perception
    cfg.TRAIN.USE_COND = use_cond
    cfg.TRAIN.TIME_STEPS = 10
    cfg.TRAIN.SAMPLE_STEPS = 10
    cfg.TRAIN.LR = 1e-3
    cfg.TRAIN.LR_WARMUP = 1
    cfg.merge_from_list([v for kv in opts.items() for v in kv])
    return cfg


def jax_cfg(cfg):
    return jax_cfg_of(cfg)


def make_batch(seed=1, batch=B):
    rng = np.random.default_rng(seed)
    return {
        "image": rng.standard_normal((batch, *HW, 3)).astype(np.float32),
        "trajs": (rng.standard_normal((batch, 16, 7)) * 0.3).astype(np.float32),
        "target": rng.standard_normal((batch, 2)).astype(np.float32),
    }


def jax_draws(key, cfg, batch=B) -> StepDraws:
    """JAX train/state.py's draws for one step: each micro-batch's key split
    in four (t, noise, the cond drop, dropout)."""
    groups = int(cfg.TRAIN.GRADIENT_ACCUMULATION_STEPS)
    keys = [key] if groups <= 1 else list(jax.random.split(key, groups))
    mb = batch // len(keys)
    ts, noises, keeps = [], [], []
    for k in keys:
        r_t, r_n, r_d, _ = jax.random.split(k, 4)
        ts.append(np.asarray(jax.random.randint(r_t, (mb,), 0, cfg.TRAIN.TIME_STEPS)))
        noises.append(np.asarray(jax.random.normal(r_n, (mb, 16, 7), jnp.float32)))
        keeps.append(bool(jax.random.uniform(r_d, ()) <= cfg.TRAIN.USE_FREE_COND_PROB))
    return StepDraws(torch.from_numpy(np.concatenate(ts)), torch.from_numpy(np.concatenate(noises)),
                     torch.tensor(keeps))


class Deterministic:
    """The JAX model applied with ``deterministic=True`` (no dropout)."""

    def __init__(self, model):
        self.model = model

    def apply(self, *args, **kw):
        return self.model.apply(*args, **dict(kw, deterministic=True))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def jax_run(use_cond="NO_GUIDANCE", perception="tiny", opts=(), dtype="float32", jit=True):
    """Initial variables and N_STEPS JAX steps from PRNGKey(0..), jitted,
    or with ``jit=False`` evaluated op by op (each primitive compiled
    alone: slower, and free of what XLA's fusion does to the sums)."""
    cfg = jax_cfg(port_cfg(use_cond, perception, **dict(opts)))
    model = jax_build_model(cfg, dtype=getattr(jnp, dtype))
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 7)), img=jnp.zeros((1, *HW, 3)),
                           time=jnp.asarray([1.0]))
    state = jax_create_state(model, variables, cfg)
    applied = Deterministic(model) if use_cond == "CLASSIFIER_GUIDANCE" else model
    step = jax_make_step(applied, jax_make_schedule(cfg.TRAIN.NOISE_SCHEDULER.TYPE, cfg.TRAIN.SAMPLE_STEPS), cfg)
    step = jax.jit(step) if jit else step
    batch = jax.tree.map(jnp.asarray, make_batch())
    states, losses, lrs, decays = [], [], [], []
    for i in range(N_STEPS):
        state, metrics = step(state, batch, jax.random.PRNGKey(i))
        states.append(_np(state))
        losses.append(float(metrics["loss"]))
        lrs.append(float(metrics["lr"]))
        decays.append(float(metrics["ema_decay"]))
    return _np(variables), states, losses, lrs, decays


def port_model(cfg, variables):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(from_jax_variables(variables, cfg))
    return model


def no_dropout(model):
    for m in model.modules():
        if isinstance(m, TransformerEncoderLayer):
            m.dropout_rate = 0.0
    return model


def port_run(cfg, variables, n_steps=N_STEPS):
    """(state, losses, lrs, decays, the first step's gradients by name)."""
    model = port_model(cfg, variables)
    if cfg.TRAIN.USE_COND == "CLASSIFIER_GUIDANCE":
        no_dropout(model)
    state = create_train_state(model, cfg)
    step = make_train_step(make_schedule(cfg.TRAIN.NOISE_SCHEDULER.TYPE, cfg.TRAIN.SAMPLE_STEPS), cfg)
    batch = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    losses, lrs, decays, grads = [], [], [], None
    for i in range(n_steps):
        m = step(state, batch, jax_draws(jax.random.PRNGKey(i), cfg))
        losses.append(float(m["loss"]))
        lrs.append(m["lr"])
        decays.append(m["ema_decay"])
        if i == 0:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return state, losses, lrs, decays, grads


def as_port(tree, cfg, jstate):
    """A JAX params-shaped tree (``jstate``'s moments or shadow) in the
    port's torch layout, by name."""
    return from_jax_variables({"params": tree, "batch_stats": jstate.batch_stats}, cfg)


def check_against_jax(cfg, jax_result, port_result, loose=()):
    """``loose``: name prefixes of parameters (and statistics) whose state
    after the steps (update, moments, statistics) is held only to Adam's
    bound, two LRs per update; their first-step gradients are compared as
    every other's."""
    variables, jstates, jlosses, jlrs, jdecays = jax_result
    state, losses, lrs, decays, grads = port_result
    np.testing.assert_allclose(losses, jlosses, rtol=2e-5)
    np.testing.assert_allclose(lrs, jlrs, rtol=1e-7)
    np.testing.assert_allclose(decays, jdecays, atol=0)
    g_jax = {k: v / (1.0 - BETA1) for k, v in as_port(jstates[0].opt_state[0].mu, cfg, jstates[0]).items()}
    tight = lambda name: not name.startswith(tuple(loose)) if loose else True
    for name, g in grads.items():
        want = g_jax[name]
        assert (g - want).abs().max() <= 1e-4 * want.abs().max() + 1e-7, name
    final = jstates[-1]
    want_params = from_jax_variables({"params": final.params, "batch_stats": final.batch_stats}, cfg)
    mu, nu = as_port(final.opt_state[0].mu, cfg, final), as_port(final.opt_state[0].nu, cfg, final)
    shadow = as_port(final.ema.shadow_params, cfg, final)
    lr_sum = sum(jlrs)
    start = from_jax_variables(variables, cfg)
    got_sd = state.model.state_dict()
    for (name, p), s in zip(state.model.named_parameters(), state.ema.shadow_params):
        noise = g_jax[name].abs() < max(NOISE_GRAD, 1e-3 * float(g_jax[name].abs().max()))
        for got, want in ((p.detach(), want_params[name]), (s, shadow[name])):
            # every element within Adam's bound; the update of the elements
            # whose gradient is not near 0 within 1e-3 of its norm
            assert ((got - want).abs() <= 2 * lr_sum).all(), name
            if tight(name) and (~noise).any():
                moved, jax_moved = (got - start[name])[~noise], (want - start[name])[~noise]
                assert (moved - jax_moved).norm() <= 1e-3 * jax_moved.norm() + 1e-6, name
        st = state.optimizer.state[p]
        assert float(st["step"]) == N_STEPS == int(final.opt_state[0].count)
        if tight(name):
            torch.testing.assert_close(st["exp_avg"], mu[name], atol=1e-6, rtol=1e-4, msg=name)
            torch.testing.assert_close(st["exp_avg_sq"], nu[name], atol=1e-9, rtol=1e-3, msg=name)
    for name, want in want_params.items():
        if "running" in name and tight(name):
            torch.testing.assert_close(got_sd[name], want, atol=1e-5, rtol=1e-4, msg=name)
    assert state.step == N_STEPS == int(final.step)
    assert state.ema.optimization_step == N_STEPS == int(final.ema.optimization_step)


@pytest.mark.parametrize(
    "use_cond,remat",
    [("NO_GUIDANCE", False), ("FREE_GUIDANCE", False), ("CLASSIFIER_GUIDANCE", False), ("NO_GUIDANCE", True)],
)
def test_train_steps_match_jax(use_cond, remat):
    """Three steps in each guidance mode (the classifier variant with JAX's
    model applied deterministic=True and the port's dropout rate 0: the
    masks of two generators cannot match) and under REMAT (JAX's REMAT step
    is bit-for-bit its plain step, JAX tests/test_train.py:267)."""
    jax_result = jax_run(use_cond)
    cfg = port_cfg(use_cond, **{"TPU.REMAT": remat})
    check_against_jax(cfg, jax_result, port_run(cfg, jax_result[0]))


def test_first_step_moves_nothing():
    """JAX's LR at the first update is schedule(0) = 0, even with LR_WARMUP
    1: the first step moves no parameter, in either package."""
    variables, jstates, *_ = jax_run("NO_GUIDANCE")
    cfg = port_cfg()
    state, *_ = port_run(cfg, variables, n_steps=1)
    start = from_jax_variables(variables, cfg)
    for name, p in state.model.named_parameters():
        assert torch.equal(p.detach(), start[name]), name


def test_remat_gives_the_same_step():
    """REMAT recomputes the forward in the backward: with BatchNorm in train
    mode and the classifier's dropout drawn from an explicit generator, the
    loss, gradients, parameters and BatchNorm statistics equal the plain
    step's, and the statistics move once."""
    results = []
    for remat in (False, True):
        cfg = port_cfg("CLASSIFIER_GUIDANCE", "resnet18", **{"TPU.REMAT": remat, "TPU.BN_MODE": "train"})
        model = build_model(cfg, device="cpu", seed=3)
        state = create_train_state(model, cfg)
        step = make_train_step(make_schedule("squaredcos_cap_v2", 10), cfg)
        batch = {k: torch.from_numpy(v) for k, v in make_batch().items()}
        m = step(state, batch, generator=torch.Generator().manual_seed(5))
        results.append((float(m["loss"]), {n: p.grad.clone() for n, p in model.named_parameters()},
                        {k: v.clone() for k, v in model.state_dict().items()}))
    (l0, g0, s0), (l1, g1, s1) = results
    assert l0 == l1
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], atol=0, rtol=0, msg=n)
    for k in s0:
        torch.testing.assert_close(s1[k], s0[k], atol=0, rtol=0, msg=k)
    assert int(s1["perception.bn1.num_batches_tracked"]) == 1


def test_step_needs_its_draws():
    cfg = port_cfg()
    state = create_train_state(build_model(cfg, device="cpu"), cfg)
    step = make_train_step(make_schedule("squaredcos_cap_v2", 10), cfg)
    batch = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    with pytest.raises(ValueError, match="draws"):
        step(state, batch)
    # from a generator: the same generator seed gives the same step
    losses = []
    for _ in range(2):
        state = create_train_state(build_model(cfg, device="cpu"), cfg)
        losses.append(float(step(state, batch, generator=torch.Generator().manual_seed(1))["loss"]))
    assert losses[0] == losses[1]


def test_bad_bn_mode_raises():
    cfg = port_cfg(**{"TPU.BN_MODE": "nope"})
    with pytest.raises(ValueError, match="BN_MODE"):
        make_train_step(make_schedule("squaredcos_cap_v2", 10), cfg)


def test_nan_scrub_matches_jax():
    """A NaN or infinite gradient becomes 0 or +-1e5, as JAX's nan_to_num
    does, before AdamW sees it."""
    from autonomous_driving_with_diffusion_model_tpu.train.state import _nan_scrub
    from autonomous_driving_with_diffusion_model_tpu_torch.train.state import _nan_scrub_

    g = np.array([np.nan, np.inf, -np.inf, 1.5, -2.0, 0.0], np.float32)
    want = np.asarray(_nan_scrub({"g": jnp.asarray(g)})["g"])
    got = torch.from_numpy(g.copy())
    _nan_scrub_([got])
    np.testing.assert_array_equal(got.numpy(), want)

    # in the step: a hook poisons one gradient; the update stays finite
    cfg = port_cfg()
    model = build_model(cfg, device="cpu")
    w = model.time_mlp[1].weight
    w.register_hook(lambda grad: torch.full_like(grad, float("nan")).index_fill(0, torch.tensor([0]), float("inf")))
    state = create_train_state(model, cfg)
    step = make_train_step(make_schedule("squaredcos_cap_v2", 10), cfg)
    batch = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    for i in range(2):
        step(state, batch, generator=torch.Generator().manual_seed(i))
    assert torch.isfinite(w).all()
    assert torch.equal(w.grad[0], torch.full_like(w.grad[0], 1e5))
    assert (w.grad[1:] == 0).all()


@pytest.mark.parametrize("steps", [0, 1, 5000, 5001, 5002, 5100, 20000, 1000000])
def test_ema_decay_matches_jax(steps):
    cfg = EmaConfig(decay=0.9999, update_after_step=5000, inv_gamma=1.0, power=0.75)
    want = float(jax_ema_decay(JaxEmaConfig(decay=0.9999, update_after_step=5000, inv_gamma=1.0, power=0.75),
                               jnp.asarray(steps)))
    assert ema_decay_for_step(cfg, steps) == want


def test_ema_update_matches_jax():
    """Increment, then decay, then s - (1 - d)(s - p), from step 5000 on,
    where the decay is not 0."""
    rng = np.random.default_rng(0)
    p0 = [rng.standard_normal((3, 4)).astype(np.float32), rng.standard_normal(5).astype(np.float32)]
    cfg = EmaConfig(update_after_step=2, power=0.75)
    jcfg = JaxEmaConfig(update_after_step=2, power=0.75)
    state, jstate = ema_init([torch.from_numpy(a) for a in p0]), jax_ema_init([jnp.asarray(a) for a in p0])
    for i in range(6):
        p = [rng.standard_normal(a.shape).astype(np.float32) for a in p0]
        decay = ema_update(cfg, state, [torch.from_numpy(a) for a in p])
        jstate = jax_ema_update(jcfg, jstate, [jnp.asarray(a) for a in p])
        assert state.optimization_step == int(jstate.optimization_step) == i + 1
        assert decay == float(jax_ema_decay(jcfg, jstate.optimization_step))
        for s, js in zip(state.shadow_params, jstate.shadow_params):
            np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("warmup", [0, 1, 1000])
def test_lr_schedule_matches_jax(warmup):
    ours, theirs = make_lr_schedule(1e-4, warmup), jax_lr_schedule(1e-4, warmup)
    for step in (0, 1, 2, 500, 999, 1000, 50000):
        assert ours(step) == float(theirs(jnp.asarray(step)))


@pytest.mark.parametrize("lr,warmup,decay", [(1e-3, 3, 10), (2e-4, 0, 7), (1e-3, 20, 8), (5e-4, 1, 1)])
def test_optimizer_matches_optax_adamw(lr, warmup, decay):
    """torch's AdamW under the port's LambdaLR against optax's adamw with
    JAX make_optimizer's schedule, the same gradients fed to both: constant
    after warmup (decay 0) and the cosine branch (decay > 0, as
    distillation uses it), past the decay's end."""
    rng = np.random.default_rng(1)
    p0 = rng.standard_normal((6, 5)).astype(np.float32)
    for decay_steps in (0, decay):
        tx = jax_make_optimizer(lr, warmup, decay_steps)
        jp = jnp.asarray(p0)
        opt_state = tx.init(jp)
        tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        opt, sched = make_optimizer([tp], lr, warmup, decay_steps)
        for i in range(decay + 3):
            g = rng.standard_normal(p0.shape).astype(np.float32)
            updates, opt_state = tx.update(jnp.asarray(g), opt_state, jp)
            jp = optax.apply_updates(jp, updates)
            tp.grad = torch.from_numpy(g)
            opt.step()
            sched.step()
            np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)


def test_dropout_acts_in_training_only():
    """The classifier variant's TransformerEncoderLayer drops at rate 0.1 in
    training mode, from the generator it is given, and not in eval mode.
    Each kept element is scaled by 1 / 0.9."""
    from autonomous_driving_with_diffusion_model_tpu_torch.models.blocks import dropout

    x = torch.ones(200, 500)
    got = dropout(x, 0.1, True, torch.Generator().manual_seed(0))
    dropped = float((got == 0).float().mean())
    # 1e5 Bernoulli(0.1) draws: the standard error is 0.00095
    assert abs(dropped - 0.1) < 0.005
    assert torch.allclose(got[got != 0], torch.full_like(got[got != 0], 1 / 0.9))
    assert torch.equal(got, dropout(x, 0.1, True, torch.Generator().manual_seed(0)))
    assert dropout(x, 0.1, False, None) is x

    layer = TransformerEncoderLayer(64)
    h = torch.randn(4, 15, 64, generator=torch.Generator().manual_seed(1))
    layer.eval()
    assert torch.equal(layer(h, torch.Generator().manual_seed(2)), layer(h))
    layer.train()
    a = layer(h, torch.Generator().manual_seed(2))
    assert torch.equal(a, layer(h, torch.Generator().manual_seed(2)))
    assert not torch.equal(a, layer(h, torch.Generator().manual_seed(3)))


def test_model_train_modes():
    """build_model serves in eval mode; train(bn_mode="frozen") keeps the
    encoder's BatchNorms in eval mode and everything else training."""
    cfg = port_cfg("CLASSIFIER_GUIDANCE", "resnet18")
    model = build_model(cfg, device="cpu")
    assert not any(m.training for m in model.modules())
    model.train(bn_mode="frozen")
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert bns and not any(m.training for m in bns)
    assert all(m.training for m in model.modules() if isinstance(m, TransformerEncoderLayer))
    model.train(bn_mode="train")
    assert all(m.training for m in bns)
    with pytest.raises(ValueError, match="BN_MODE"):
        model.train(bn_mode="nope")
    model.eval()
    assert not any(m.training for m in model.modules())


def test_build_model_computes_float32_on_the_card(monkeypatch):
    """build_model turns TF32 off on the card (PyTorch lets cuDNN round a
    float32 convolution's inputs to TF32 by default), so a float32 model
    trains and serves in float32; for the CPU it changes nothing."""
    from autonomous_driving_with_diffusion_model_tpu_torch.models import temporal_unet
    from autonomous_driving_with_diffusion_model_tpu_torch.utils import use_float32_math

    seen = []
    monkeypatch.setattr(temporal_unet, "use_float32_math", seen.append)
    build_model(port_cfg(), device="cpu")
    assert seen == [torch.device("cpu")]
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        use_float32_math("cpu")
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
        use_float32_math(torch.device("cuda", 0))
        assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("foreach", [False, True])
def test_kernel_packs_follow_optimizer_steps(foreach):
    """The blocks' cached kernel-layout packs (serving) are rebuilt after an
    optimizer step, since its in-place updates bump each parameter's
    version; under autograd the pack is built in the graph, so the
    gradient reaches the torch-layout parameters."""
    torch.manual_seed(0)
    blocks = [ResidualTemporalMapBlock(16, 32, 24), Conv1dBlock(16, 16)]
    for blk in blocks:
        with torch.no_grad():
            before = [a.clone() for a in blk.kernel_params() if a is not None]
        assert blk.kernel_params()[0].requires_grad  # in the graph, not the cache
        opt = torch.optim.AdamW(blk.parameters(), lr=0.1, foreach=foreach)
        x = torch.randn(2, 8, 16)
        out = blk(x, torch.randn(2, 24)) if isinstance(blk, ResidualTemporalMapBlock) else blk(x)
        out.square().mean().backward()
        assert all(p.grad is not None and p.grad.abs().sum() > 0 for p in blk.parameters())
        opt.step()
        with torch.no_grad():
            after = [a for a in blk.kernel_params() if a is not None]
        assert all(not torch.equal(a, b) for a, b in zip(after, before))
        conv = blk.blocks[0].block[0] if isinstance(blk, ResidualTemporalMapBlock) else blk.block[0]
        with torch.no_grad():
            torch.testing.assert_close(after[0], conv.weight.permute(2, 1, 0), atol=0, rtol=0)
