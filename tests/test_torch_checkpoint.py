"""The port's training checkpoints (train/checkpoint.py) against the JAX
package's: a reference ``.pth`` written by JAX's ``export_torch_checkpoint``
resumes in the port, and one written by the port resumes in JAX's
``import_torch_checkpoint``, with equal parameters, BatchNorm statistics,
AdamW moments and counts, EMA and step (exactly: both sides copy float32);
both refuse a ``.pth`` for an encoder other than ResNet-34; the port's own
checkpoint (any encoder) round-trips."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from autonomous_driving_with_diffusion_model_tpu.models import build_model as jax_build_model
from autonomous_driving_with_diffusion_model_tpu.train import (
    create_train_state as jax_create_state,
    export_torch_checkpoint as jax_export,
    import_torch_checkpoint as jax_import,
)
from port_jax_cfg import jax_cfg_of
from autonomous_driving_with_diffusion_model_tpu_torch.diffusion import make_schedule
from autonomous_driving_with_diffusion_model_tpu_torch.models import (
    build_model,
    from_jax_variables,
)
from autonomous_driving_with_diffusion_model_tpu_torch.train import (
    create_train_state,
    export_torch_checkpoint,
    import_torch_checkpoint,
    load_checkpoint,
    make_train_step,
    resume,
    save_checkpoint,
)
from autonomous_driving_with_diffusion_model_tpu_torch.utils.config import create_cfg

# one intra-op thread per process: the suite runs in several worker
# processes at once, and torch's default of a thread per core in each makes
# them contend for the cores (these files ran 3.6x as long)
torch.set_num_threads(1)


def _cfg(perception="resnet34"):
    cfg = create_cfg()
    cfg.MODEL.DIM = 8
    cfg.MODEL.PERCEPTION = perception
    cfg.TRAIN.TIME_STEPS = 10
    cfg.TRAIN.SAMPLE_STEPS = 10
    cfg.TRAIN.LR_WARMUP = 1
    cfg.TRAIN.LR = 1e-3
    return cfg


def _jax_cfg(cfg):
    return jax_cfg_of(cfg)


def _jax_state(cfg, seed=0):
    """A JAX TrainState of the config whose moments, EMA, statistics and
    counts are all set (random, 3 steps taken), without running a step."""
    model = jax_build_model(_jax_cfg(cfg), dtype=jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(seed), jnp.zeros((1, 16, 7)),
                            img=jnp.zeros((1, 32, 48, 3)), time=jnp.asarray([1.0]))
    variables = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), shapes)
    state = jax_create_state(model, variables, _jax_cfg(cfg))
    rng = np.random.default_rng(seed)
    rand = lambda tree, lo=-1.0: jax.tree.map(lambda a: jnp.asarray(rng.uniform(lo, 1.0, a.shape), jnp.float32), tree)
    adam = state.opt_state[0]._replace(count=jnp.asarray(3, jnp.int32), mu=rand(state.params),
                                       nu=rand(state.params, 0.0))
    return state._replace(
        params=rand(state.params),
        batch_stats=rand(state.batch_stats, 0.1),
        opt_state=(adam,) + tuple(state.opt_state[1:]),
        ema=state.ema._replace(shadow_params=rand(state.params), optimization_step=jnp.asarray(3, jnp.int32)),
        step=jnp.asarray(3, jnp.int32),
    )


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_layout(tree, stats, cfg):
    return from_jax_variables({"params": _np(tree), "batch_stats": _np(stats)}, cfg)


def _port_state(cfg, seed=0):
    return create_train_state(build_model(cfg, device="cpu", seed=seed), cfg)


def test_jax_pth_resumes_in_the_port(tmp_path):
    cfg = _cfg()
    jstate = _jax_state(cfg)
    path = str(tmp_path / "jax.pth")
    jax_export(_np(jstate), _jax_cfg(cfg), path)
    state = _port_state(cfg, seed=1)
    import_torch_checkpoint(path, cfg, state)

    want = _port_layout(jstate.params, jstate.batch_stats, cfg)
    mu = _port_layout(jstate.opt_state[0].mu, jstate.batch_stats, cfg)
    nu = _port_layout(jstate.opt_state[0].nu, jstate.batch_stats, cfg)
    shadow = _port_layout(jstate.ema.shadow_params, jstate.batch_stats, cfg)
    sd = state.model.state_dict()
    for name, value in want.items():
        assert torch.equal(sd[name], value), name
    for (name, p), s in zip(state.model.named_parameters(), state.ema.shadow_params):
        st = state.optimizer.state[p]
        assert torch.equal(st["exp_avg"], mu[name]) and torch.equal(st["exp_avg_sq"], nu[name]), name
        assert float(st["step"]) == 3.0
        assert torch.equal(s, shadow[name]), name
    assert state.step == 3 and state.ema.optimization_step == 3
    assert state.scheduler.last_epoch == 3
    lr = float(np.float32(cfg.TRAIN.LR))  # the schedule is float32, as JAX's
    assert state.optimizer.param_groups[0]["lr"] == state.scheduler.get_last_lr()[0] == lr
    # and training goes on from there
    step = make_train_step(make_schedule("squaredcos_cap_v2", 10), cfg)
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.standard_normal((2, 32, 48, 3)).astype(np.float32)),
             "trajs": torch.from_numpy(rng.uniform(-1, 1, (2, 16, 7)).astype(np.float32)),
             "target": torch.zeros(2, 2)}
    m = step(state, batch, generator=torch.Generator().manual_seed(0))
    assert state.step == 4 and np.isfinite(float(m["loss"])) and m["lr"] == lr


def test_port_pth_resumes_in_jax(tmp_path):
    cfg = _cfg()
    state = _port_state(cfg)
    step = make_train_step(make_schedule("squaredcos_cap_v2", 10), cfg)
    rng = np.random.default_rng(1)
    batch = {"image": torch.from_numpy(rng.standard_normal((2, 32, 48, 3)).astype(np.float32)),
             "trajs": torch.from_numpy(rng.uniform(-1, 1, (2, 16, 7)).astype(np.float32)),
             "target": torch.zeros(2, 2)}
    for i in range(2):
        step(state, batch, generator=torch.Generator().manual_seed(i))
    path = str(tmp_path / "port.pth")
    export_torch_checkpoint(state, cfg, path)

    jstate = jax_import(path, _jax_cfg(cfg), _jax_state(cfg, seed=2))
    sd = state.model.state_dict()
    for name, value in _port_layout(jstate.params, jstate.batch_stats, cfg).items():
        assert torch.equal(sd[name], value), name
    mu = _port_layout(jstate.opt_state[0].mu, jstate.batch_stats, cfg)
    nu = _port_layout(jstate.opt_state[0].nu, jstate.batch_stats, cfg)
    shadow = _port_layout(jstate.ema.shadow_params, jstate.batch_stats, cfg)
    for (name, p), s in zip(state.model.named_parameters(), state.ema.shadow_params):
        st = state.optimizer.state[p]
        assert torch.equal(st["exp_avg"], mu[name]) and torch.equal(st["exp_avg_sq"], nu[name]), name
        assert torch.equal(s, shadow[name]), name
    assert int(jstate.step) == 2 and int(jstate.opt_state[0].count) == 2
    assert int(jstate.ema.optimization_step) == 2

    # the reference's own loading: state_dict strict, then AdamW's state
    ckpt = torch.load(path, weights_only=False)
    model = build_model(cfg, device="cpu", seed=3)
    model.load_state_dict(ckpt["state_dict"], strict=True)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.95, 0.999), eps=1e-7)
    opt.load_state_dict(ckpt["optimizer"])
    assert ckpt["lr_scheduler"] == {"last_epoch": 2, "_step_count": 3} and ckpt["iter"] == 2
    assert sorted(ckpt["ema_state_dict"]) == ["decay", "inv_gamma", "min_decay", "optimization_step", "power",
                                               "shadow_params", "update_after_step", "use_ema_warmup"]


def test_pth_needs_resnet34_like_jax(tmp_path):
    cfg = _cfg("tiny")
    state = _port_state(cfg)
    with pytest.raises(ValueError, match="resnet34"):
        export_torch_checkpoint(state, cfg, str(tmp_path / "x.pth"))
    with pytest.raises(ValueError, match="resnet34"):
        jax_export(_np(_jax_state(cfg)), _jax_cfg(cfg), str(tmp_path / "y.pth"))
    export_torch_checkpoint(_port_state(_cfg()), _cfg(), str(tmp_path / "z.pth"))
    with pytest.raises(ValueError, match="resnet34"):
        import_torch_checkpoint(str(tmp_path / "z.pth"), cfg, state)


@pytest.mark.parametrize("perception", ["tiny", "resnet18"])
def test_own_checkpoint_round_trips(tmp_path, perception):
    """The port's own checkpoint, for any encoder, through ``resume``: the
    weights, statistics, optimizer state, EMA, step and LR come back."""
    cfg = _cfg(perception)
    cfg.TPU.BN_MODE = "train"
    state = _port_state(cfg)
    step = make_train_step(make_schedule("squaredcos_cap_v2", 10), cfg)
    batch = {"image": torch.randn(2, 32, 48, 3), "trajs": torch.rand(2, 16, 7) * 2 - 1, "target": torch.zeros(2, 2)}
    for i in range(3):
        step(state, batch, generator=torch.Generator().manual_seed(i))
    path = str(tmp_path / "own.pt")
    save_checkpoint(state, path)
    other = _port_state(cfg, seed=5)
    resume(path, cfg, other)
    for (k, a), (_, b) in zip(state.model.state_dict().items(), other.model.state_dict().items()):
        assert torch.equal(a, b), k
    for p, q in zip(state.model.parameters(), other.model.parameters()):
        sa, sb = state.optimizer.state[p], other.optimizer.state[q]
        assert all(torch.equal(sa[k], sb[k]) for k in ("step", "exp_avg", "exp_avg_sq"))
    assert all(torch.equal(a, b) for a, b in zip(state.ema.shadow_params, other.ema.shadow_params))
    assert (other.step, other.ema.optimization_step) == (3, 3)
    assert other.scheduler.get_last_lr() == state.scheduler.get_last_lr()
    with pytest.raises(ValueError, match="not a checkpoint"):
        torch.save({"x": 1}, str(tmp_path / "bad.pt"))
        load_checkpoint(str(tmp_path / "bad.pt"), other)

