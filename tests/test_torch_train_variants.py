"""Variants of the port's training step against the JAX package's, three
steps each from the same weights, batch and draws: the encoder's BatchNorm
under ``TPU.BN_MODE`` ``train`` (batch statistics, running statistics moved)
and ``frozen`` (running statistics, never moved), gradient accumulation over
two micro-batches, and a bfloat16 model. The tolerances are
``tests/test_torch_train.py``'s unless a test says otherwise.

BatchNorm on batch statistics of a few 32x48 frames: JAX's jitted step on
the CPU loses precision in the encoder's first stage (its gradients there
move by 1.3% in ``conv1`` and 8.6% in ``layer1`` against JAX's own op-by-op
evaluation of the same function; ``ROADMAP.md`` Queue 3). So the step under
``train`` is held to JAX's step evaluated op by op, which the port's first
gradients match within the usual tolerance, the encoder's included.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from autonomous_driving_with_diffusion_model_tpu_torch.diffusion import make_schedule
from autonomous_driving_with_diffusion_model_tpu_torch.models import build_model
from autonomous_driving_with_diffusion_model_tpu_torch.train import create_train_state, make_train_step
from test_torch_train import (
    BETA1,
    as_port,
    check_against_jax,
    jax_draws,
    jax_run,
    make_batch,
    port_cfg,
    port_run,
)

# one intra-op thread per process: the suite runs in several worker
# processes at once, and torch's default of a thread per core in each makes
# them contend for the cores (these files ran 3.6x as long)
torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_matches_jax_op_by_op(dtype):
    """One BatchNorm in training mode (JAX ``resnet.py:59-96``, applied op by
    op) against the port's: the output (normalized in float32 with the
    batch mean and biased variance, returned in the input's dtype), the
    running statistics moved by momentum 0.1 with the unbiased variance,
    and the gradients of the input, gamma and beta."""
    from autonomous_driving_with_diffusion_model_tpu.models.resnet import BatchNorm as JaxBatchNorm
    from autonomous_driving_with_diffusion_model_tpu_torch.models.resnet import _bn

    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 6, 8)) * 2 + 1).astype(np.float32)  # NHWC
    w = rng.standard_normal(x.shape).astype(np.float32)
    gamma, beta = rng.uniform(0.5, 1.5, 8).astype(np.float32), rng.standard_normal(8).astype(np.float32)
    mean0, var0 = rng.standard_normal(8).astype(np.float32), rng.uniform(0.5, 2, 8).astype(np.float32)
    jdt = getattr(jnp, dtype)

    def loss(xx, g, b):
        out, new = JaxBatchNorm(8).apply({"params": {"weight": g, "bias": b},
                                          "batch_stats": {"running_mean": mean0, "running_var": var0}},
                                         xx.astype(jdt), use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * w), (out, new["batch_stats"])

    (_, (want, stats)), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    bn = torch.nn.BatchNorm2d(8).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(gamma))
        bn.bias.copy_(torch.from_numpy(beta))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    tx = torch.from_numpy(x).requires_grad_(True)
    out = _bn(bn, tx.to(getattr(torch, dtype)).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.dtype == getattr(torch, dtype)
    (out.float() * torch.from_numpy(w)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(want, np.float32), **tol)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["running_mean"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["running_var"]), rtol=1e-5, atol=1e-6)
    for got, g in zip((tx.grad, bn.weight.grad, bn.bias.grad), grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(g), **tol)
    assert int(bn.num_batches_tracked) == 1


@pytest.mark.parametrize("bn_mode", ["train", "frozen"])
def test_bn_modes_match_jax(bn_mode):
    """ResNet-18: under "train" the running statistics move and under
    "frozen" (the default) they stay as they were while the parameters
    train (JAX tests/test_train.py:102 test_frozen_bn_mode).

    Under "train" the reference is JAX's step op by op (above). Every
    first-step gradient, the encoder's included, and the first step's
    statistics are held to the usual tolerances. After three steps the
    encoder's updates differ by more than 1e-3 of their norm: the gradients of
    BatchNorm on four frames change sign from step to step, and where they
    cancel in Adam's first moment, its division by the second moment's
    root magnifies their 2e-5 of rounding. So after the steps the encoder
    is held to Adam's bound and the rest of the model to the usual
    tolerances."""
    opts = (("TPU.BN_MODE", bn_mode),)
    jax_result = jax_run("NO_GUIDANCE", "resnet18", opts, jit=bn_mode != "train")
    cfg = port_cfg("NO_GUIDANCE", "resnet18", **dict(opts))
    result = port_run(cfg, jax_result[0])
    check_against_jax(cfg, jax_result, result, loose=("perception.",) if bn_mode == "train" else ())
    state = result[0]
    start = jax_result[0]["batch_stats"]["perception"]["bn1"]["running_mean"]
    moved = not np.array_equal(state.model.perception.bn1.running_mean.numpy(), start)
    assert moved == (bn_mode == "train")
    assert int(state.model.perception.bn1.num_batches_tracked) == (3 if bn_mode == "train" else 0)
    if bn_mode == "train":
        first = jax_result[1][0]
        again = port_run(cfg, jax_result[0], n_steps=1)[0].model.state_dict()
        for name, value in as_port(first.params, cfg, first).items():
            if "running" in name:
                torch.testing.assert_close(again[name], value, rtol=1e-4, atol=1e-6, msg=name)


def test_gradient_accumulation_matches_jax():
    """GRADIENT_ACCUMULATION_STEPS 2: two micro-batches of consecutive rows,
    each with its own draws (JAX splits the step's key in two) and its own
    condition drop, gradients and loss averaged."""
    opts = (("TRAIN.GRADIENT_ACCUMULATION_STEPS", 2),)
    jax_result = jax_run("FREE_GUIDANCE", "tiny", opts)
    cfg = port_cfg("FREE_GUIDANCE", **dict(opts))
    check_against_jax(cfg, jax_result, port_run(cfg, jax_result[0]))


def test_accumulation_carries_batchnorm_statistics():
    """With BatchNorm in train mode, the second micro-batch starts from the
    statistics the first one left, as JAX's scan carries them: two
    micro-batches of one step move them as two forwards in a row do."""
    cfg = port_cfg("NO_GUIDANCE", "resnet18", **{"TRAIN.GRADIENT_ACCUMULATION_STEPS": 2, "TPU.BN_MODE": "train"})
    batch = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    model = build_model(cfg, device="cpu", seed=4)
    reference = build_model(cfg, device="cpu", seed=4).train(bn_mode="train")
    state = create_train_state(model, cfg)
    make_train_step(make_schedule("squaredcos_cap_v2", 10), cfg)(state, batch, jax_draws(jax.random.PRNGKey(0), cfg))
    with torch.no_grad():
        for rows in (slice(0, 2), slice(2, 4)):
            reference.perception(batch["image"][rows])
    want = reference.state_dict()
    for name, value in model.state_dict().items():
        if "running" in name or "num_batches" in name:
            torch.testing.assert_close(value, want[name], rtol=1e-6, atol=1e-7, msg=name)


def test_bf16_step_within_jax_bf16_gap():
    """A bfloat16 model (float32 parameters, a bfloat16 forward) trained from
    the same weights and draws: its losses and its first gradient stay as
    close to JAX's float32 step as JAX's own bfloat16 step does, within 2x
    (two bfloat16 forwards round at other places, so neither is nearer the
    float32 result than the other) and, for the losses, one bf16 ulp."""
    variables, f32_states, f32_losses, _, _ = jax_run("NO_GUIDANCE")
    _, b16_states, b16_losses, _, _ = jax_run("NO_GUIDANCE", dtype="bfloat16")
    cfg = port_cfg(**{"TPU.COMPUTE_DTYPE": "bfloat16"})
    state, losses, _, _, grads = port_run(cfg, variables)
    jax_gap = np.abs(np.subtract(b16_losses, f32_losses)).max()
    port_gap = np.abs(np.subtract(losses, f32_losses)).max()
    assert port_gap <= 2 * jax_gap + 2e-3, (port_gap, jax_gap)  # + one bf16 ulp of a loss near 0.5
    f32 = {k: v / (1 - BETA1) for k, v in as_port(f32_states[0].opt_state[0].mu, cfg, f32_states[0]).items()}
    b16 = {k: v / (1 - BETA1) for k, v in as_port(b16_states[0].opt_state[0].mu, cfg, b16_states[0]).items()}
    err = lambda g: float(torch.sqrt(sum(((g[k] - f32[k]) ** 2).sum() for k in grads))
                          / torch.sqrt(sum((f32[k] ** 2).sum() for k in grads)))
    assert err(grads) <= 2 * err(b16) + 1e-3, (err(grads), err(b16))
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
