"""The port's samplers (DDIM, DDPM, DPM-Solver++ 2M, inpainting) against the
JAX package's ``make_sampler`` (same weights, same injected ``init_trajs``
and ``noise_seq``), its step functions against the JAX ones, and both
against the committed torch-oracle golden packs (tests/goldens, as
tests/test_goldens.py reads them), loaded through ``from_jax_variables``."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from autonomous_driving_with_diffusion_model_tpu import diffusion as jdiff
from autonomous_driving_with_diffusion_model_tpu.models import build_model as jax_build_model
from autonomous_driving_with_diffusion_model_tpu.models import torch_convert as jax_torch_convert
from port_jax_cfg import jax_cfg_of
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
    return jax_cfg_of(cfg)


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
    "ddpm_no_guidance": dict(mode="NO_GUIDANCE", scheduler="ddpm"),
    "ddpm_cfg_dual_batch": dict(mode="FREE_GUIDANCE", scheduler="ddpm", free_scale=7.5),
    "ddpm_classifier": dict(mode="CLASSIFIER_GUIDANCE", scheduler="ddpm", classifier_scale=15.0),
    "ddpm_scaled_linear": dict(mode="NO_GUIDANCE", scheduler="ddpm", schedule="scaled_linear"),
    "ddim_scaled_linear": dict(mode="NO_GUIDANCE", schedule="scaled_linear"),
    "dpm_no_guidance": dict(mode="NO_GUIDANCE", scheduler="dpm"),
    "dpm_cfg_dual_batch": dict(mode="FREE_GUIDANCE", scheduler="dpm", free_scale=7.5),
    "dpm_classifier": dict(mode="CLASSIFIER_GUIDANCE", scheduler="dpm", classifier_scale=15.0),
    "dpm_custom_grid": dict(mode="NO_GUIDANCE", scheduler="dpm", timesteps=(80, 41, 12)),
    "dpm_no_threshold": dict(mode="NO_GUIDANCE", scheduler="dpm", step=dict(thresholding=False)),
    "inpaint_ddim": dict(mode="NO_GUIDANCE", inpainting=True),
    "inpaint_ddpm": dict(mode="NO_GUIDANCE", scheduler="ddpm", inpainting=True),
}


def _inpaint_target(B):
    """A known region: waypoints 1-4 (the first 4 after the anchor) at x = 0.5."""
    traj = np.zeros((B, 16, 7), np.float32)
    traj[..., 0] = 0.5
    mask = np.zeros((B, 16, 7), np.float32)
    mask[:, 1:5] = 1.0
    return traj, mask


@pytest.mark.parametrize("name", sorted(CASES))
def test_sampler_matches_jax(models, rng, name):
    case = dict(CASES[name])
    mode = case.pop("mode")
    eta = case.pop("eta", 0.0)
    schedule_type = case.pop("schedule", "squaredcos_cap_v2")
    step = dict(STEP, **case.pop("step", {}))
    jm, tree, tm = models[mode]
    B, steps = 2, 3
    kw = dict(num_steps=steps, free_scale=case.pop("free_scale", 1.0), **case)
    if mode == "CLASSIFIER_GUIDANCE":
        kw["loss_list"] = [["TargetGuidance", []]]
    n_steps = len(kw.get("timesteps") or ()) or steps
    init = rng.standard_normal((B, 16, 7)).astype(np.float32)
    img = rng.standard_normal((B, 32, 48, 3)).astype(np.float32)
    target = (rng.standard_normal((B, 2)) * 0.3).astype(np.float32)
    needs_noise = eta or kw.get("scheduler") == "ddpm" or kw.get("inpainting")
    noise = rng.standard_normal((n_steps, B, 16, 7)).astype(np.float32) if needs_noise else None
    known = _inpaint_target(B) if kw.get("inpainting") else (None, None)
    guided = mode != "NO_GUIDANCE"

    jcfg = jdiff.SamplerConfig(guidance=JG[mode], step=jdiff.StepConfig(eta=eta, **step), **kw)
    jsample = jax.jit(jdiff.make_sampler(jm, jdiff.make_schedule(schedule_type, 100), jcfg))
    j = lambda a: None if a is None else jnp.asarray(a)
    want = jsample(
        tree, jnp.asarray(init), image=jnp.asarray(img), target=j(target) if guided else None,
        noise_seq=j(noise), target_traj=j(known[0]), target_mask=j(known[1]),
    )
    tcfg = tdiff.SamplerConfig(guidance=GuidanceType[mode], step=tdiff.StepConfig(eta=eta, **step), **kw)
    tsample = tdiff.make_sampler(tm, tdiff.make_schedule(schedule_type, 100), tcfg)
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = tsample(
        torch.from_numpy(init), image=torch.from_numpy(img), target=t(target) if guided else None,
        noise_seq=t(noise), target_traj=t(known[0]), target_mask=t(known[1]),
    )
    assert tuple(got.shape) == (B, 16, 7) and got.dtype == torch.float32
    assert tsample.num_steps == n_steps and tsample.needs_noise == bool(needs_noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PLAN_TOL)
    if kw.get("inpainting"):
        # the known region is pinned at the last step (prev_t < 0: no noise),
        # as JAX tests/test_routes_inpaint.py:78-80 checks
        np.testing.assert_allclose(got.numpy()[:, 1:5, 0], 0.5 * MAGIC_NUM, atol=1e-5)


def test_for_training_eval_matches_jax(models, rng):
    """train.evaluate's sampler: DDPM over TRAIN.TIME_STEPS, clip without
    thresholding, no conditioning, no meters scaling."""
    jm, tree, tm = models["NO_GUIDANCE"]
    cfg = _cfg("NO_GUIDANCE")
    cfg.TRAIN.TIME_STEPS = 4
    init = rng.standard_normal((2, 16, 7)).astype(np.float32)
    img = rng.standard_normal((2, 32, 48, 3)).astype(np.float32)
    noise = rng.standard_normal((4, 2, 16, 7)).astype(np.float32)
    schedule_j, schedule_t = jdiff.make_schedule_from_cfg(_jax_cfg(cfg)), tdiff.make_schedule_from_cfg(cfg)
    jsample = jax.jit(jdiff.sampler_from_cfg(jm, schedule_j, _jax_cfg(cfg), for_training_eval=True))
    want = jsample(tree, jnp.asarray(init), image=jnp.asarray(img), noise_seq=jnp.asarray(noise))
    tsample = tdiff.sampler_from_cfg(tm, schedule_t, cfg, for_training_eval=True)
    got = tsample(torch.from_numpy(init), image=torch.from_numpy(img), noise_seq=torch.from_numpy(noise))
    assert tsample.num_steps == 4 and tsample.needs_noise
    assert float(got.abs().max()) <= 1.0  # no meters scaling
    # normalized units: PLAN_TOL's 5e-3 m over the 23.3 m scale
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2.5e-4, rtol=1e-4)


@pytest.mark.parametrize("scheduler", ["ddpm", "inpaint_ddim"])
def test_step_noise_is_drawn_before_the_loop(models, rng, scheduler):
    """Without noise_seq the sampler draws all S steps' noise at once, as
    (S, B, H, D), from the caller's generator: the same plan as that tensor
    injected."""
    tm = models["NO_GUIDANCE"][2]
    inpainting = scheduler == "inpaint_ddim"
    cfg = tdiff.SamplerConfig(scheduler="ddim" if inpainting else scheduler, num_steps=3,
                              step=tdiff.StepConfig(**STEP), inpainting=inpainting)
    sample = tdiff.make_sampler(tm, tdiff.make_schedule(), cfg)
    init = torch.from_numpy(rng.standard_normal((2, 16, 7)).astype(np.float32))
    img = torch.from_numpy(rng.standard_normal((2, 32, 48, 3)).astype(np.float32))
    known = dict(zip(("target_traj", "target_mask"), map(torch.from_numpy, _inpaint_target(2)))) if inpainting else {}
    got = sample(init, image=img, generator=torch.Generator().manual_seed(4), **known)
    noise = torch.randn((3, 2, 16, 7), generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(got, sample(init, image=img, noise_seq=noise, **known), atol=0, rtol=0)
    with pytest.raises(ValueError, match="step noise"):
        sample(init, image=img, **known)


def test_refusals_match_jax(models):
    """The configurations the JAX package refuses, refused alike."""
    tm = models["NO_GUIDANCE"][2]
    bad = [
        dict(scheduler="dpm", inpainting=True),
        dict(scheduler="dpm", step=tdiff.StepConfig(eta=0.5)),
        dict(guidance=GuidanceType.FREE_GUIDANCE, inpainting=True),
        dict(scheduler="euler"),
    ]
    for kw in bad:
        with pytest.raises(ValueError):
            tdiff.make_sampler(tm, tdiff.make_schedule(), tdiff.SamplerConfig(**kw))


# ------------------------------------------------------------------ steps

STEP_FNS = ["ddpm_step", "ddim_step_clipped_eps", "inpaint_blend_ddpm", "inpaint_blend_ddim_strict",
            "inpaint_blend_ddim_textbook"]


@pytest.mark.parametrize("pred", ["sample", "epsilon", "v_prediction"])
@pytest.mark.parametrize("fn", STEP_FNS)
def test_step_functions_match_jax(rng, fn, pred):
    """One step at every (t, prev_t) kind: interior, prev_t < 0, t = 0."""
    step_j = jdiff.StepConfig(prediction_type=pred, thresholding=True)
    step_t = tdiff.StepConfig(prediction_type=pred, thresholding=True)
    name, kw = fn, {}
    if fn == "ddim_step_clipped_eps":
        name, kw = "ddim_step", dict(use_clipped_model_output=True)
    elif fn.startswith("inpaint_blend_ddim"):
        name, kw = "inpaint_blend_ddim", dict(strict_reference=fn.endswith("strict"))
    if name.startswith("inpaint"):
        traj, mask = _inpaint_target(2)
        kw_j = dict(kw, target_traj=jnp.asarray(traj), target_mask=jnp.asarray(mask))
        kw_t = dict(kw, target_traj=torch.from_numpy(traj), target_mask=torch.from_numpy(mask))
    else:
        kw_j = kw_t = kw
    sj, st = jdiff.make_schedule("squaredcos_cap_v2", 100), tdiff.make_schedule("squaredcos_cap_v2", 100)
    for t, prev_t in ((60, 30), (10, -1), (0, -1)):
        out, x, noise = (rng.standard_normal((2, 16, 7)).astype(np.float32) for _ in range(3))
        want = getattr(jdiff, name)(sj, step_j, jnp.asarray(out), jnp.asarray(t), jnp.asarray(prev_t),
                                    jnp.asarray(x), jnp.asarray(noise), **kw_j)
        got = getattr(tdiff, name)(st, step_t, torch.from_numpy(out), t, prev_t, torch.from_numpy(x),
                                   torch.from_numpy(noise), **kw_t)
        for g, w in zip(got, want):
            # float32 on both sides; epsilon divides by sqrt(alpha_prod) down to 0.04
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=1e-5, err_msg=f"t={t}")


@pytest.mark.parametrize("t,prev_t", [(60, 30), (10, -1), (0, -1), (99, 89)])
def test_variances_match_jax(t, prev_t):
    for kind in ("squaredcos_cap_v2", "linear", "scaled_linear"):
        sj, st = jdiff.make_schedule(kind, 100), tdiff.make_schedule(kind, 100)
        np.testing.assert_array_equal(st.betas.numpy(), np.asarray(sj.betas))
        np.testing.assert_array_equal(st.alphas_cumprod.numpy(), np.asarray(sj.alphas_cumprod))
        for fn in ("ddpm_variance", "ddim_variance"):
            want = getattr(jdiff, fn)(sj, jnp.asarray(t), jnp.asarray(prev_t))
            np.testing.assert_allclose(float(getattr(tdiff, fn)(st, t, prev_t)), float(want), rtol=1e-6, err_msg=fn)


def test_add_noise_matches_jax(rng):
    x0, noise = (rng.standard_normal((5, 16, 7)).astype(np.float32) for _ in range(2))
    t = np.array([0, 17, 50, 98, 99])
    for kind in ("squaredcos_cap_v2", "scaled_linear"):
        want = jdiff.add_noise(jdiff.make_schedule(kind, 100), jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
        got = tdiff.add_noise(tdiff.make_schedule(kind, 100), torch.from_numpy(x0), torch.from_numpy(noise),
                              torch.from_numpy(t))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


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


def _chain_noise(pack, step_fn, **kw):
    """The port's step on the recorded model outputs and step noise."""
    schedule = tdiff.make_schedule("squaredcos_cap_v2", 100)
    trajs = torch.from_numpy(pack["init"].copy())
    trajs[:, 0, :3] = 0.0
    for i, (t, prev_t) in enumerate(zip(pack["ts"], pack["prev_ts"])):
        trajs, _ = step_fn(schedule, _step_cfg(), torch.from_numpy(pack["step_outputs"][i]), int(t), int(prev_t),
                           trajs, torch.from_numpy(pack["noise_seq"][i]), **kw)
        trajs[:, 0, :3] = 0.0
        np.testing.assert_allclose(trajs.numpy(), pack["step_trajs"][i], atol=2e-5, rtol=1e-5, err_msg=f"step {i}")
    final = np.clip(trajs.numpy(), -1.0, 1.0)
    final[..., :2] *= MAGIC_NUM
    np.testing.assert_allclose(final, pack["expected"], atol=2e-5, rtol=1e-5)


def _known(pack):
    return dict(target_traj=torch.from_numpy(pack["target_traj"]), target_mask=torch.from_numpy(pack["target_mask"]))


@pytest.mark.parametrize("mode", ["ddpm", "inpaint_ddim"])
def test_noise_chain_matches_golden(mode):
    """DDPM and inpainting DDIM steps on the recorded outputs and noise
    (tests/test_goldens.py:166-216's tolerances)."""
    pack = _pack(mode)
    if mode == "ddpm":
        _chain_noise(pack, tdiff.ddpm_step)
    else:
        _chain_noise(pack, tdiff.inpaint_blend_ddim, **_known(pack))


@pytest.mark.parametrize("mode", ["ddpm", "inpaint_ddim"])
def test_noise_sampler_matches_golden(mode):
    """The whole sampler with the pack's weights and noise
    (tests/test_goldens.py:187-232's tolerances)."""
    pack = _pack(mode)
    tm, _ = _golden_model("no_guidance", pack)
    inpaint = mode == "inpaint_ddim"
    cfg = tdiff.SamplerConfig(scheduler="ddim" if inpaint else "ddpm", num_steps=len(pack["ts"]),
                              step=_step_cfg(), inpainting=inpaint)
    sample = tdiff.make_sampler(tm, tdiff.make_schedule("squaredcos_cap_v2", 100), cfg)
    got = sample(torch.from_numpy(pack["init"]), img_feature=torch.from_numpy(pack["img_feature"]),
                 noise_seq=torch.from_numpy(pack["noise_seq"]), **(_known(pack) if inpaint else {}))
    np.testing.assert_allclose(got.numpy(), pack["expected"], atol=5e-3, rtol=1e-3)
