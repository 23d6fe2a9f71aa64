"""The port's DDIM sampler against the JAX package's ``make_sampler`` (same
weights, same injected ``init_trajs`` and ``noise_seq``), and against the
committed torch-oracle golden packs (tests/goldens, as tests/test_goldens.py
reads them), loaded through ``from_jax_variables``."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from autonomous_driving_with_diffusion_model_tpu import diffusion as jdiff
from autonomous_driving_with_diffusion_model_tpu.models import build_model as jax_build_model
from autonomous_driving_with_diffusion_model_tpu.models import torch_convert as jax_torch_convert
from autonomous_driving_with_diffusion_model_tpu.utils.config import create_cfg as jax_create_cfg
from autonomous_driving_with_diffusion_model_tpu.utils.constants import GuidanceType as JG
from autonomous_driving_with_diffusion_model_tpu_torch import diffusion as tdiff
from autonomous_driving_with_diffusion_model_tpu_torch.models import (
    build_mapping,
    build_model,
    from_jax_variables,
)
from autonomous_driving_with_diffusion_model_tpu_torch.utils.config import create_cfg
from autonomous_driving_with_diffusion_model_tpu_torch.utils.constants import MAGIC_NUM, GuidanceType

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
# outputs in meters: float32 step math on both sides, x 23.3 m, with CFG
# amplifying U-Net differences by up to 2 * free_scale
PLAN_TOL = dict(atol=5e-3, rtol=1e-4)


def _cfg(mode, dim=None, mults=(1, 2)):
    cfg = create_cfg()
    cfg.MODEL.DIM = dim or (64 if mode == "CLASSIFIER_GUIDANCE" else 8)
    cfg.MODEL.DIM_MULTS = mults
    cfg.MODEL.PERCEPTION = "tiny"
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


@pytest.fixture(scope="module")
def models():
    out = {}
    for mode in ("NO_GUIDANCE", "FREE_GUIDANCE", "CLASSIFIER_GUIDANCE"):
        cfg = _cfg(mode)
        tm = build_model(cfg, device="cpu", seed=2)
        out[mode] = (jax_build_model(_jax_cfg(cfg)), _jax_tree(tm, cfg), tm)
    return out


STEP = dict(prediction_type="sample", clip_sample=True, thresholding=True)
CASES = {
    "ddim_no_guidance": dict(mode="NO_GUIDANCE"),
    "hoisting_off": dict(mode="NO_GUIDANCE", hoist_perception=False),
    "custom_grid": dict(mode="NO_GUIDANCE", timesteps=(90, 61, 30, 4)),
    "eta_with_noise_seq": dict(mode="NO_GUIDANCE", eta=0.5),
    "cfg_dual_batch": dict(mode="FREE_GUIDANCE", free_scale=7.5),
    "cfg_dual_batch_hoisting_off": dict(mode="FREE_GUIDANCE", free_scale=7.5, hoist_perception=False),
    "cfg_free_scale_1": dict(mode="FREE_GUIDANCE", free_scale=1.0),
    "classifier": dict(mode="CLASSIFIER_GUIDANCE", classifier_scale=15.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sampler_matches_jax(models, rng, name):
    case = dict(CASES[name])
    mode = case.pop("mode")
    eta = case.pop("eta", 0.0)
    jm, tree, tm = models[mode]
    B, steps = 2, 3
    kw = dict(num_steps=steps, free_scale=case.pop("free_scale", 1.0), **case)
    if mode == "CLASSIFIER_GUIDANCE":
        kw["loss_list"] = [["TargetGuidance", []]]
    n_steps = len(kw.get("timesteps") or ()) or steps
    init = rng.standard_normal((B, 16, 7)).astype(np.float32)
    img = rng.standard_normal((B, 32, 48, 3)).astype(np.float32)
    target = (rng.standard_normal((B, 2)) * 0.3).astype(np.float32)
    noise = rng.standard_normal((n_steps, B, 16, 7)).astype(np.float32) if eta else None
    guided = mode != "NO_GUIDANCE"

    jcfg = jdiff.SamplerConfig(guidance=JG[mode], step=jdiff.StepConfig(eta=eta, **STEP), **kw)
    jsample = jax.jit(jdiff.make_sampler(jm, jdiff.make_schedule("squaredcos_cap_v2", 100), jcfg))
    want = jsample(
        tree, jnp.asarray(init), image=jnp.asarray(img),
        target=jnp.asarray(target) if guided else None,
        noise_seq=None if noise is None else jnp.asarray(noise),
    )
    tcfg = tdiff.SamplerConfig(guidance=GuidanceType[mode], step=tdiff.StepConfig(eta=eta, **STEP), **kw)
    tsample = tdiff.make_sampler(tm, tdiff.make_schedule("squaredcos_cap_v2", 100), tcfg)
    got = tsample(
        torch.from_numpy(init), image=torch.from_numpy(img),
        target=torch.from_numpy(target) if guided else None,
        noise_seq=None if noise is None else torch.from_numpy(noise),
    )
    assert tuple(got.shape) == (B, 16, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PLAN_TOL)


@pytest.mark.parametrize("scheduler", ["ddpm", "dpm"])
def test_later_slice_schedulers_raise(models, scheduler):
    tm = models["NO_GUIDANCE"][2]
    cfg = tdiff.SamplerConfig(scheduler=scheduler)
    with pytest.raises(NotImplementedError, match="later slice"):
        tdiff.make_sampler(tm, tdiff.make_schedule(), cfg)
    with pytest.raises(NotImplementedError, match="later slice"):
        tdiff.make_sampler(tm, tdiff.make_schedule(), tdiff.SamplerConfig(inpainting=True))


# ------------------------------------------------------------------ goldens


def _pack(mode):
    return np.load(os.path.join(GOLDEN_DIR, f"sampling_{mode}.npz"))


def _golden_model(mode, pack, mults=(1, 2, 4, 8)):
    """The port model with the pack's weights, carried through
    from_jax_variables; weights the pack lacks (the perception encoder; all
    but state_pred for the classifier pack) stay random."""
    cfg = _cfg(mode.upper(), dim=int(pack["meta_dim"]), mults=mults)
    tree = _jax_tree(build_model(cfg, device="cpu"), cfg)
    n = 0
    for key in pack.files:
        if key.startswith("param:"):
            node = tree["params"]
            *parents, leaf = key[len("param:"):].split("/")
            for p in parents:
                node = node[p]
            assert node[leaf].shape == pack[key].shape, key
            node[leaf] = pack[key]
            n += 1
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(from_jax_variables(tree, cfg), strict=True)
    return tm, n


def _step_cfg():
    return tdiff.StepConfig(**STEP)


@pytest.mark.parametrize("mode", ["no_guidance", "free_guidance", "classifier_guidance"])
def test_ddim_chain_matches_golden(mode):
    """The port's DDIM step on the recorded (guided) model outputs."""
    pack = _pack(mode)
    schedule = tdiff.make_schedule("squaredcos_cap_v2", 100)
    key = "step_guided" if "step_guided" in pack.files else "step_outputs"
    trajs = torch.from_numpy(pack["init"].copy())
    trajs[:, 0, :3] = 0.0
    for i, (t, prev_t) in enumerate(zip(pack["ts"], pack["prev_ts"])):
        trajs, _ = tdiff.ddim_step(
            schedule, _step_cfg(), torch.from_numpy(pack[key][i]), int(t), int(prev_t), trajs
        )
        trajs[:, 0, :3] = 0.0
        np.testing.assert_allclose(trajs.numpy(), pack["step_trajs"][i], atol=2e-5, rtol=1e-5)


def test_unet_forward_matches_golden():
    pack = _pack("no_guidance")
    tm, n = _golden_model("no_guidance", pack)
    assert n == sum(1 for k in pack.files if k.startswith("param:"))
    feat = torch.from_numpy(pack["img_feature"])
    with torch.no_grad():
        for i, t in enumerate(pack["ts"]):
            x = pack["init"].copy() if i == 0 else pack["step_trajs"][i - 1]
            if i == 0:
                x[:, 0, :3] = 0.0
            out = tm(torch.from_numpy(x), time=torch.tensor([float(t)]), img_feature=feat)
            np.testing.assert_allclose(out.numpy(), pack["step_outputs"][i], atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("mode", ["no_guidance", "free_guidance"])
def test_sampler_matches_golden(mode):
    pack = _pack(mode)
    tm, _ = _golden_model(mode, pack)
    cfg = tdiff.SamplerConfig(
        guidance=GuidanceType[mode.upper()], num_steps=len(pack["ts"]), step=_step_cfg(),
        free_scale=float(pack["meta_free_scale"]) if mode == "free_guidance" else 1.0,
    )
    sample = tdiff.make_sampler(tm, tdiff.make_schedule("squaredcos_cap_v2", 100), cfg)
    kw = dict(target=torch.from_numpy(pack["target"])) if mode == "free_guidance" else {}
    got = sample(torch.from_numpy(pack["init"]), img_feature=torch.from_numpy(pack["img_feature"]), **kw)
    np.testing.assert_allclose(got.numpy(), pack["expected"], atol=5e-3, rtol=1e-3)


def test_classifier_guidance_transform_matches_golden():
    """predict_state + the autograd guidance transform against the recorded
    (action, time_embed) -> guided-output pairs (all the classifier pack holds)."""
    pack = _pack("classifier_guidance")
    tm, _ = _golden_model("classifier_guidance", pack, mults=(1, 2))
    tm.requires_grad_(False)
    schedule = tdiff.make_schedule("squaredcos_cap_v2", 100)
    for i, (t, prev_t) in enumerate(zip(pack["ts"], pack["prev_ts"])):
        action = torch.from_numpy(pack["step_actions"][i])
        te = torch.from_numpy(pack["step_time_embeds"][i])
        with torch.no_grad():
            output = torch.cat([tm.predict_state(action, te), action], dim=-1)
        guide = tdiff.make_guidance_fn(
            [["TargetGuidance", []]], float(pack["meta_classifier_scale"]), 1,
            lambda a, te=te: tm.predict_state(a, te),
        )
        grad_scale = torch.exp(0.5 * tdiff.ddim_variance(schedule, int(t), int(prev_t)))
        got = guide(output, action, torch.from_numpy(pack["target"]), grad_scale)
        np.testing.assert_allclose(got.numpy(), pack["step_guided"][i], atol=5e-4, rtol=1e-3)
    final = np.clip(pack["step_trajs"][-1], -1.0, 1.0)
    final[..., :2] *= MAGIC_NUM
    np.testing.assert_allclose(final, pack["expected"], atol=2e-5)
