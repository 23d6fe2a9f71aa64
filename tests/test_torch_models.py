"""The port's models against the JAX package's: the weight carry
(``from_jax_variables`` == ``variables_to_torch_state_dict``), the U-Net
forward in all three guidance variants, with and without attention, the
ResNet family's encoders, and reference ``.pth`` loading with the EMA-shadow
overwrite."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from autonomous_driving_with_diffusion_model_tpu.models import build_model as jax_build_model
from autonomous_driving_with_diffusion_model_tpu.models.temporal_unet import (
    TemporalMapUnet as JaxUnet,
)
from autonomous_driving_with_diffusion_model_tpu.models import torch_convert as jax_torch_convert
from autonomous_driving_with_diffusion_model_tpu.models.torch_convert import (
    load_torch_checkpoint as jax_load_torch_checkpoint,
    torch_state_dict_to_variables,
    variables_to_torch_state_dict,
)
from autonomous_driving_with_diffusion_model_tpu.utils.config import create_cfg as jax_create_cfg
from autonomous_driving_with_diffusion_model_tpu_torch.models import (
    build_mapping,
    build_model,
    from_jax_variables,
    load_torch_checkpoint,
)
from autonomous_driving_with_diffusion_model_tpu_torch.utils.config import create_cfg

MODES = ["NO_GUIDANCE", "FREE_GUIDANCE", "CLASSIFIER_GUIDANCE"]
# float32 on the CPU on both sides; the U-Net chains ~40 ops whose sums run
# in another order (the JAX package's own golden tests use 2e-4 / 1e-4)
FWD_TOL = dict(atol=2e-5, rtol=1e-4)


def _cfg(mode, perception="tiny", dim=None, attention=False):
    cfg = create_cfg()
    cfg.MODEL.USE_ATTN = attention
    cfg.MODEL.DIM = dim or (64 if mode == "CLASSIFIER_GUIDANCE" else 8)
    cfg.MODEL.DIM_MULTS = (1, 2)
    cfg.MODEL.PERCEPTION = perception
    cfg.TRAIN.USE_COND = mode
    cfg.GUIDANCE.USE_COND = mode
    return cfg


def _jax_cfg(cfg):
    jcfg = jax_create_cfg()
    jcfg.merge_from_other_cfg(cfg)
    return jcfg


def _jax_tree(model, cfg):
    """The port model's weights as a JAX variables tree, through the port's
    mapping and the JAX package's own torch -> flax transforms."""
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


def _random_bn_stats(model, rng):
    """Random BN running statistics, so eval-mode BN is tested with real values."""
    for mod in model.modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, mod.num_features).astype(np.float32)))
            mod.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, mod.num_features).astype(np.float32)))


@pytest.mark.parametrize("mode", MODES)
def test_from_jax_variables_equals_jax_export(mode):
    """Exact, key for key, on a resnet34 tree; then a strict load. The JAX
    tree is the port's random init in JAX layout (no JAX init needed)."""
    cfg = _cfg(mode, "resnet34")
    model = build_model(cfg, device="cpu")
    tree = torch_state_dict_to_variables(model.state_dict(), _jax_cfg(cfg))
    want = variables_to_torch_state_dict(tree, _jax_cfg(cfg))
    got = from_jax_variables(tree, cfg)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == (torch.int64 if k.endswith("num_batches_tracked") else torch.float32)
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    fresh = build_model(cfg, device="cpu", seed=1)
    fresh.load_state_dict(got, strict=True)
    # parameters are registered in the reference order the EMA list follows
    assert [k for k, _ in fresh.named_parameters()] == [k for k, _, _ in build_mapping(cfg)[0]]


def _carry(cfg, seed=5):
    """(cfg, the JAX model, a random tree, the port model loaded from that
    tree through from_jax_variables)."""
    tree = _jax_tree(build_model(cfg, device="cpu", seed=seed), cfg)
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(from_jax_variables(tree, cfg), strict=True)
    return cfg, jax_build_model(_jax_cfg(cfg)), tree, tm


@pytest.fixture(scope="module")
def carried():
    """Per mode: the carry of _carry."""
    return {mode: _carry(_cfg(mode)) for mode in MODES}


def _inputs(rng, B):
    return (
        rng.standard_normal((B, 16, 7)).astype(np.float32),
        rng.standard_normal((B, 32, 48, 3)).astype(np.float32),
        rng.uniform(0, 99, B).astype(np.float32),
    )


def _jax_init_tree(jm, cfg):
    """The JAX model's own variable tree (shapes only: no compile)."""
    x = jnp.zeros((1, cfg.MODEL.HORIZON, cfg.MODEL.TRANSITION_DIM), jnp.float32)
    img = jnp.zeros((1, 64, 96, 3), jnp.float32)
    return jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, img=img, time=jnp.ones((1,))))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), tuple(v.shape)


@pytest.mark.parametrize("mode", MODES)
def test_attention_carry_and_forward_match_jax(rng, mode):
    """MODEL.USE_ATTN: every attention weight maps onto the JAX tree, and
    the forward agrees at FWD_TOL."""
    cfg, jm, variables, tm = _carry(_cfg(mode, attention=True))
    want_paths = dict(_leaves(_jax_init_tree(jm, cfg)["params"]))
    assert dict(_leaves(variables["params"])).keys() == want_paths.keys()
    for path, shape in _leaves(variables["params"]):
        assert shape == want_paths[path], path
    assert any("attn" in k for k in tm.state_dict())
    _check_forward(rng, mode, jm, variables, tm)


@pytest.mark.parametrize("mode", MODES)
def test_unet_forward_matches_jax(carried, rng, mode):
    _check_forward(rng, mode, *carried[mode][1:])


def _check_forward(rng, mode, jm, variables, tm):
    x, img, t = _inputs(rng, 2)
    kw_j, kw_t = {}, {}
    if mode == "FREE_GUIDANCE":
        # the dual-batch form: 2B trajectories and targets, B images and times
        x = np.concatenate([x, x])
        cond = rng.standard_normal((4, 2)).astype(np.float32)
        kw_j, kw_t = dict(cond=jnp.asarray(cond)), dict(cond=torch.from_numpy(cond))
    want = jax.jit(jm.apply)(variables, jnp.asarray(x), img=jnp.asarray(img), time=jnp.asarray(t), **kw_j)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), img=torch.from_numpy(img), time=torch.from_numpy(t), **kw_t)
    assert tuple(got.shape) == (x.shape[0], 16, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_encode_image_and_hoisted_feature_match_jax(carried, rng):
    cfg, jm, variables, tm = carried["NO_GUIDANCE"]
    x, img, t = _inputs(rng, 2)
    feat_j = jax.jit(lambda v, i: jm.apply(v, i, method=JaxUnet.encode_image))(variables, jnp.asarray(img))
    with torch.no_grad():
        feat_t = tm.encode_image(torch.from_numpy(img))
        np.testing.assert_allclose(feat_t.numpy(), np.asarray(feat_j), **FWD_TOL)
        want = jax.jit(jm.apply)(variables, jnp.asarray(x), time=jnp.asarray(t), img_feature=feat_j)
        got = tm(torch.from_numpy(x), time=torch.from_numpy(t), img_feature=feat_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_classifier_action_time_and_predict_state_match_jax(carried, rng):
    cfg, jm, variables, tm = carried["CLASSIFIER_GUIDANCE"]
    x, img, t = _inputs(rng, 2)
    action_j, te_j = jax.jit(lambda v, *a: jm.apply(v, *a, return_action_and_time_only=True))(
        variables, jnp.asarray(x), jnp.asarray(img), jnp.asarray(t)
    )
    state_j = jax.jit(lambda v, a, e: jm.apply(v, a, e, method=JaxUnet.predict_state))(variables, action_j, te_j)
    with torch.no_grad():
        action_t, te_t = tm(
            torch.from_numpy(x), img=torch.from_numpy(img), time=torch.from_numpy(t),
            return_action_and_time_only=True,
        )
        state_t = tm.predict_state(action_t, te_t)
    assert tuple(action_t.shape) == (2, 16, 3) and tuple(state_t.shape) == (2, 16, 4)
    np.testing.assert_allclose(action_t.numpy(), np.asarray(action_j), **FWD_TOL)
    np.testing.assert_allclose(te_t.numpy(), np.asarray(te_j), **FWD_TOL)
    np.testing.assert_allclose(state_t.numpy(), np.asarray(state_j), **FWD_TOL)
    assert np.all(state_t.numpy()[:, 0] == 0.0)


def test_resnet34_encode_matches_jax(rng):
    _check_encode(rng, "resnet34")


@pytest.mark.parametrize("perception", ["resnet18", "resnet50", "resnext50_32x4d", "wide_resnet50_2"])
def test_resnet_family_encode_matches_jax(rng, perception):
    _check_encode(rng, perception)


def _check_encode(rng, perception):
    """One encode at a small image, with random BN running stats."""
    cfg = _cfg("NO_GUIDANCE", perception)
    tm = build_model(cfg, device="cpu")
    _random_bn_stats(tm, rng)
    tree = _jax_tree(tm, cfg)
    jm = jax_build_model(_jax_cfg(cfg))
    img = rng.standard_normal((2, 64, 96, 3)).astype(np.float32)
    want = jax.jit(lambda v, i: jm.apply(v, i, method=JaxUnet.encode_image))(tree, jnp.asarray(img))
    with torch.no_grad():
        got = tm.encode_image(torch.from_numpy(img))
    # up to 53 convolutions deep, sums of up to 4608 products
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("perception", ["resnet101", "resnet152"])
def test_deep_resnet_mapping_matches_jax_tree(perception):
    """resnet101/152 repeat resnet50's block: their mapping equals the JAX
    encoder's variables path for path and shape for shape, and the carry
    loads strictly."""
    cfg = _cfg("NO_GUIDANCE", perception)
    tm = build_model(cfg, device="cpu")
    jtree = _jax_init_tree(jax_build_model(_jax_cfg(cfg)), cfg)
    tree = _jax_tree(tm, cfg)
    for col in ("params", "batch_stats"):
        got, want = dict(_leaves(tree[col])), dict(_leaves(jtree[col]))
        assert got == want, col
    params_map, stats_map = build_mapping(cfg)
    assert [k for k, _ in tm.named_parameters()] == [k for k, _, _ in params_map]
    assert len(stats_map) == 2 * sum(1 for m in tm.modules() if isinstance(m, torch.nn.BatchNorm2d))
    build_model(cfg, device="cpu", seed=1).load_state_dict(from_jax_variables(tree, cfg), strict=True)


def test_pth_needs_resnet34_like_jax(tmp_path):
    cfg = _cfg("NO_GUIDANCE", "resnet18")
    path = tmp_path / "r18.pth"
    torch.save({"state_dict": build_model(cfg, device="cpu").state_dict()}, path)
    for load in (load_torch_checkpoint, lambda p, c: jax_load_torch_checkpoint(p, _jax_cfg(c))):
        with pytest.raises(ValueError, match="resnet34"):
            load(str(path), cfg)


def test_kernel_layout_copies_follow_load_state_dict(rng):
    """The blocks keep kernel-layout copies of their weights; a load after a
    forward must refresh them, so the reloaded model equals a fresh one."""
    cfg = _cfg("NO_GUIDANCE")
    x, img, t = (torch.from_numpy(a) for a in _inputs(rng, 1))
    stale = build_model(cfg, device="cpu", seed=0)
    donor = build_model(cfg, device="cpu", seed=7)
    with torch.no_grad():
        stale(x, img=img, time=t)  # packs seed-0 weights
        stale.load_state_dict(donor.state_dict(), strict=True)
        torch.testing.assert_close(stale(x, img=img, time=t), donor(x, img=img, time=t), atol=0, rtol=0)


@pytest.mark.parametrize("use_ema", [True, False])
def test_pth_loading_with_ema_matches_jax(tmp_path, rng, use_ema):
    """A reference-format .pth written here: state_dict + EMA shadow list in
    parameter order, loaded by both packages."""
    cfg = _cfg("FREE_GUIDANCE", "resnet34")
    model = build_model(cfg, device="cpu")
    sd = model.state_dict()
    shadow = [p.detach() + torch.from_numpy(rng.normal(0, 0.01, p.shape).astype(np.float32))
              for p in model.parameters()]
    path = tmp_path / "ckpt.pth"
    torch.save({"state_dict": sd, "ema_state_dict": {"shadow_params": shadow}, "iter": 7}, path)

    want = variables_to_torch_state_dict(
        jax_load_torch_checkpoint(str(path), _jax_cfg(cfg), use_ema=use_ema), _jax_cfg(cfg)
    )
    got = load_torch_checkpoint(str(path), cfg, use_ema=use_ema)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)
    fresh = build_model(cfg, device="cpu", seed=3)
    fresh.load_state_dict(got, strict=True)
    first = next(fresh.parameters())
    expect = shadow[0] if use_ema else sd["perception.conv1.weight"]
    assert torch.equal(first, expect)
