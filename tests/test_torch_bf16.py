"""The port's bfloat16 model (``TPU.COMPUTE_DTYPE bfloat16``) against the JAX
package's, on the same weights: float32 parameters, a bfloat16 forward whose
distance from JAX's bfloat16 forward stays within JAX's own bf16-vs-fp32
bound, float32 sampler output, the kernels' packed weights keyed on the
compute dtype, and the stated rounding of GroupNorm's gamma and beta."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from autonomous_driving_with_diffusion_model_tpu.models import build_model as jax_build_model
from autonomous_driving_with_diffusion_model_tpu.models.temporal_unet import TemporalMapUnet as JaxUnet
from port_jax_cfg import jax_cfg_of
from autonomous_driving_with_diffusion_model_tpu_torch import diffusion as tdiff
from autonomous_driving_with_diffusion_model_tpu_torch.models import (
    Conv1dBlock,
    ResidualTemporalMapBlock,
    build_mapping,
    build_model,
    from_jax_variables,
)
from autonomous_driving_with_diffusion_model_tpu.models import torch_convert as jax_torch_convert
from autonomous_driving_with_diffusion_model_tpu_torch.ops import kernels
from autonomous_driving_with_diffusion_model_tpu_torch.utils.config import create_cfg

MODES = ["NO_GUIDANCE", "FREE_GUIDANCE", "CLASSIFIER_GUIDANCE"]
# JAX's own bound on its bf16-vs-fp32 forward (tests/test_bf16.py:31)
JAX_BF16_BOUND = 0.2


def _cfg(mode, dtype="bfloat16"):
    cfg = create_cfg()
    cfg.MODEL.DIM = 64 if mode == "CLASSIFIER_GUIDANCE" else 8
    cfg.MODEL.DIM_MULTS = (1, 2)
    cfg.MODEL.PERCEPTION = "tiny"
    cfg.TRAIN.USE_COND = mode
    cfg.GUIDANCE.USE_COND = mode
    cfg.TPU.COMPUTE_DTYPE = dtype
    return cfg


def _jax_cfg(cfg):
    return jax_cfg_of(cfg)


def _jax_tree(model, cfg):
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    tree = {"params": {}, "batch_stats": {}}
    params_map, stats_map = build_mapping(cfg)
    for entries, col in ((params_map, "params"), (stats_map, "batch_stats")):
        for key, path, tf in entries:
            node = tree[col]
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = jax_torch_convert._FWD[tf](sd[key])
    return tree


@pytest.mark.parametrize("mode", MODES)
def test_bf16_forward_within_jax_bf16_bound(rng, mode):
    cfg = _cfg(mode)
    tm = build_model(cfg, device="cpu", seed=2)
    assert tm.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert all(v.dtype in (torch.float32, torch.int64) for v in tm.state_dict().values())
    tree = _jax_tree(tm, cfg)
    j16 = jax_build_model(_jax_cfg(cfg))
    j32 = jax_build_model(_jax_cfg(_cfg(mode, "float32")))
    x = rng.standard_normal((2, 16, 7)).astype(np.float32)
    img = rng.standard_normal((2, 32, 48, 3)).astype(np.float32)
    t = rng.uniform(0, 99, 2).astype(np.float32)
    cond = rng.standard_normal((2, 2)).astype(np.float32)
    kw_j = dict(cond=jnp.asarray(cond)) if mode == "FREE_GUIDANCE" else {}
    kw_t = dict(cond=torch.from_numpy(cond)) if mode == "FREE_GUIDANCE" else {}
    args = (jnp.asarray(x),)
    kwargs = dict(img=jnp.asarray(img), time=jnp.asarray(t), **kw_j)
    want16 = np.asarray(jax.jit(j16.apply)(tree, *args, **kwargs), np.float32)
    want32 = np.asarray(jax.jit(j32.apply)(tree, *args, **kwargs))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), img=torch.from_numpy(img), time=torch.from_numpy(t), **kw_t)
    assert got.dtype == torch.bfloat16  # as JAX's (tests/test_bf16.py:30)
    got = got.float().numpy()
    jax_gap = np.abs(want16 - want32).max()
    # both round to bf16 at other places (the port's kernels keep the block
    # in fp32 between its two convs): within JAX's own bound, and within
    # the sum of two such roundings of this input
    assert np.abs(got - want16).max() <= min(JAX_BF16_BOUND, 2.0 * jax_gap)
    assert np.abs(got - want32).max() <= min(JAX_BF16_BOUND, 2.0 * jax_gap)


def test_bf16_encode_and_state_head_match_jax(rng):
    cfg = _cfg("CLASSIFIER_GUIDANCE")
    tm = build_model(cfg, device="cpu", seed=3)
    tree = _jax_tree(tm, cfg)
    jm = jax_build_model(_jax_cfg(cfg))
    img = rng.standard_normal((2, 32, 48, 3)).astype(np.float32)
    action = rng.standard_normal((2, 16, 3)).astype(np.float32)
    te = rng.standard_normal((2, 64)).astype(np.float32)
    feat_j = jm.apply(tree, jnp.asarray(img), method=JaxUnet.encode_image)
    state_j = jm.apply(tree, jnp.asarray(action), jnp.asarray(te).astype(jnp.bfloat16), method=JaxUnet.predict_state)
    with torch.no_grad():
        feat_t = tm.encode_image(torch.from_numpy(img))
        state_t = tm.predict_state(torch.from_numpy(action), torch.from_numpy(te).to(torch.bfloat16))
    assert feat_t.dtype == state_t.dtype == torch.bfloat16
    # a few bf16 roundings of O(1) values (2^-8 relative each)
    np.testing.assert_allclose(feat_t.float().numpy(), np.asarray(feat_j, np.float32), atol=0.05, rtol=0.02)
    np.testing.assert_allclose(state_t.float().numpy(), np.asarray(state_j, np.float32), atol=0.1, rtol=0.02)


@pytest.mark.parametrize("scheduler", ["ddim", "ddpm", "dpm"])
def test_bf16_sampler_output_is_float32_and_finite(rng, scheduler):
    cfg = _cfg("FREE_GUIDANCE")
    cfg.EVAL.SCHEDULER = scheduler
    cfg.EVAL.SAMPLE_STEPS = 3
    cfg.GUIDANCE.FREE_SCALE = 7.5
    tm = build_model(cfg, device="cpu")
    sample = tdiff.sampler_from_cfg(tm, tdiff.make_schedule_from_cfg(cfg), cfg)
    x = torch.from_numpy(rng.standard_normal((2, 16, 7)).astype(np.float32))
    img = torch.from_numpy(rng.standard_normal((2, 32, 48, 3)).astype(np.float32))
    out = sample(x, image=img, target=torch.zeros(2, 2), generator=torch.Generator().manual_seed(0))
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    # against the float32 model on the same weights: JAX's bound in meters
    cfg.TPU.COMPUTE_DTYPE = "float32"
    t32 = build_model(cfg, device="cpu")
    t32.load_state_dict(tm.state_dict())
    ref = tdiff.sampler_from_cfg(t32, tdiff.make_schedule_from_cfg(cfg), cfg)(
        x, image=img, target=torch.zeros(2, 2), generator=torch.Generator().manual_seed(0))
    assert float((out - ref).abs().max()) <= JAX_BF16_BOUND * 23.315


def test_packed_weights_key_on_the_compute_dtype(rng):
    """A float32 pack is never reused for a bf16 call, nor the other way."""
    block = ResidualTemporalMapBlock(16, 32, 24).eval()
    x = torch.from_numpy(rng.standard_normal((1, 8, 16)).astype(np.float32))
    t = torch.from_numpy(rng.standard_normal((1, 24)).astype(np.float32))
    with torch.no_grad():
        f32 = block(x, t)
        b16 = block(x.to(torch.bfloat16), t.to(torch.bfloat16))
        assert f32.dtype == torch.float32 and b16.dtype == torch.bfloat16
        assert all(p is None or p.dtype == torch.bfloat16 for p in block.kernel_params(torch.bfloat16))
        assert all(p is None or p.dtype == torch.float32 for p in block.kernel_params(torch.float32))
        fresh = ResidualTemporalMapBlock(16, 32, 24).eval()
        fresh.load_state_dict(block.state_dict())
        torch.testing.assert_close(b16, fresh(x.to(torch.bfloat16), t.to(torch.bfloat16)), atol=0, rtol=0)
        torch.testing.assert_close(f32, block(x, t), atol=0, rtol=0)
        # and a load after both packs refreshes both
        fresh2 = ResidualTemporalMapBlock(16, 32, 24).eval()
        block.load_state_dict(fresh2.state_dict())
        torch.testing.assert_close(block(x.to(torch.bfloat16), t.to(torch.bfloat16)),
                                   fresh2(x.to(torch.bfloat16), t.to(torch.bfloat16)), atol=0, rtol=0)


@pytest.mark.parametrize("which", ["head", "residual"])
def test_gamma_beta_rounding_to_bf16_is_bounded(rng, which):
    """The kernels take gamma/beta in x's dtype, so a bf16 model hands them
    rounded to bf16 (JAX keeps them fp32): at most 2 bf16 ulps of the
    output's largest value, for trained-like gamma ~ N(1, 0.2), beta ~ N(0, 0.2)."""
    c = 32
    mod = Conv1dBlock(16, c) if which == "head" else ResidualTemporalMapBlock(16, c, 24)
    norms = [m for m in mod.modules() if isinstance(m, torch.nn.GroupNorm)]
    with torch.no_grad():
        for n in norms:
            n.weight.copy_(torch.from_numpy(rng.normal(1.0, 0.2, c).astype(np.float32)))
            n.bias.copy_(torch.from_numpy(rng.normal(0.0, 0.2, c).astype(np.float32)))
    bf = torch.bfloat16
    x = torch.from_numpy(rng.standard_normal((2, 16, 16)).astype(np.float32)).to(bf)
    packed = list(mod.kernel_params(bf))
    exact = list(packed)
    # gamma/beta positions in the packs: (w, b, g, be) and (w1, b1, g1, be1, tw, tb, w2, b2, g2, be2, ...)
    idx = (2, 3) if which == "head" else (2, 3, 8, 9)
    f32 = [p for p in mod.kernel_params(torch.float32)]
    for i in idx:
        exact[i] = f32[i]
    with torch.no_grad():
        if which == "head":
            got = kernels.conv1d_gn_mish_plain(x, *packed).float()
            want = kernels.conv1d_gn_mish_plain(x, *exact).float()
        else:
            t = torch.from_numpy(rng.standard_normal((2, 24)).astype(np.float32)).to(bf)
            got = kernels.residual_block_plain(x, t, *packed).float()
            want = kernels.residual_block_plain(x, t, *exact).float()
    ulp = 2.0 ** (np.floor(np.log2(float(want.abs().max()))) - 7)
    assert float((got - want).abs().max()) <= 2 * ulp
    assert any(float((p - e).abs().max()) > 0 for p, e in zip(packed, exact))


def test_bf16_cfg_student_plans_no_farther_from_fp32_than_jax(rng):
    """A CFG student's plans in bfloat16 (``GUIDANCE.FREE_SCALE`` 1.0, the
    distilled 2-step grid, one conditional forward a step; trained-like
    GroupNorm affines) stay as close to the float32 plans as the JAX
    planner's bfloat16 plans do, within 2x, on the same weights, frames and
    init draws: the port's bf16 deployment adds no error of its own to the
    plans (the control dims included) that a closed loop could turn into
    drift."""
    from autonomous_driving_with_diffusion_model_tpu.driving.plan import DiffusionPlanner as JaxPlanner
    from autonomous_driving_with_diffusion_model_tpu_torch.driving import DiffusionPlanner

    def cfg_of(dtype):
        cfg = _cfg("FREE_GUIDANCE", dtype)
        cfg.MODEL.DIM = 32
        cfg.TRAIN.IMAGE_HEIGHT, cfg.TRAIN.IMAGE_WIDTH = 32, 48
        cfg.EVAL.SCHEDULER = "ddim"
        cfg.TPU.SAMPLE_TIMESTEPS = [98, 34]
        cfg.GUIDANCE.FREE_SCALE = 1.0
        return cfg

    port32 = DiffusionPlanner(cfg_of("float32"), device="cpu")
    port16 = DiffusionPlanner(cfg_of("bfloat16"), device="cpu")
    with torch.no_grad():
        for m in port32.model.modules():
            if isinstance(m, torch.nn.GroupNorm):
                m.weight.copy_(torch.from_numpy(rng.normal(1.0, 0.3, m.weight.shape).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rng.normal(0.0, 0.3, m.bias.shape).astype(np.float32)))
    port16.model.load_state_dict(port32.model.state_dict())
    tree = _jax_tree(port32.model, cfg_of("float32"))
    jax16 = JaxPlanner(_jax_cfg(cfg_of("bfloat16")))
    jax16.variables = tree
    err = {"port": [], "jax": []}
    for _ in range(6):
        init = rng.standard_normal((1, 16, 7)).astype(np.float32)
        port32.init_trajs = port16.init_trajs = torch.from_numpy(init)
        jax16.init_trajs = jnp.asarray(init)
        frame = rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
        target = rng.uniform(-0.5, 0.5, 2).astype(np.float32)
        want = port32.plan(frame, target)
        err["port"].append(port16.plan(frame, target) - want)
        err["jax"].append(np.asarray(jax16.plan(frame, target)) - want)
    rms = {k: float(np.sqrt(np.mean(np.square(v)))) for k, v in err.items()}
    assert 0 < rms["port"] <= 2 * rms["jax"], rms
    assert np.abs(err["port"]).max() <= 2 * np.abs(err["jax"]).max(), rms
