"""RDT-1B on the port (``MODEL.ARCH`` ``rdt``): the DiT's forward with a
masked instruction, SigLIP's tower and the image preprocessing, whole plans
through ``DiffusionPlanner`` over a padded two-frame history, and the
DPM-Solver++ grid without a lambda clip, each held on the CPU to
``perfbench/reference/rdt.py`` (plain PyTorch, float32, independent of the
port) or to diffusers' formulas, at a small size on seeded random weights;
the parameter count of the published sizes; the reference's planted faults
(the language mask dropped, the alternation swapped) beyond the tolerance;
the plan's cached cross-attention keys and values against the uncached
forward, made once a plan, and against a cache with its parities swapped; the
family's refusals. On a card (``gpu``): a bfloat16 plan's graph against
its eager body, and the ``plan`` span's attention counts.
``python -m pytest tests/test_torch_rdt.py -m gpu --noconftest`` runs the
card's part without JAX.
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.reference import rdt as ref_rdt  # noqa: E402
from perfbench.weights_rdt import make_state_dict  # noqa: E402

from autonomous_driving_with_diffusion_model_tpu_torch.diffusion.dpm import dpm_coeffs, dpm_timesteps  # noqa: E402
from autonomous_driving_with_diffusion_model_tpu_torch.diffusion.schedule import make_schedule  # noqa: E402
from autonomous_driving_with_diffusion_model_tpu_torch.models import build_model  # noqa: E402
from autonomous_driving_with_diffusion_model_tpu_torch.models.siglip import square_resize  # noqa: E402
from autonomous_driving_with_diffusion_model_tpu_torch.ops import kernels  # noqa: E402
from autonomous_driving_with_diffusion_model_tpu_torch.utils.config import create_cfg  # noqa: E402

torch.set_num_threads(1)  # several test processes share the cores

HW = (32, 64)
# hidden 64, depth 4, 4 heads, a 2-layer 32-wide tower on 56x56 images, chunk 8, state 16
SMALL = {"MODEL": {"ARCH": "rdt", "HORIZON": 8, "N_OBS_STEPS": 2,
                   "RDT": {"HIDDEN": 64, "DEPTH": 4, "HEADS": 4, "STATE_DIM": 16, "LANG_DIM": 48, "LANG_SLOTS": 8,
                           "MAX_LANG_LEN": 12, "ACTION_SLOTS": [0, 1, 2, 3, 4, 5, 6], "TARGET_SLOTS": [8, 9],
                           "VISION_WIDTH": 32, "VISION_DEPTH": 2, "VISION_HEADS": 2, "VISION_MLP": 60,
                           "IMAGE_SIZE": 56, "PATCH": 14}},
         "TRAIN": {"SAMPLE_STEPS": 1000, "IMAGE_HEIGHT": HW[0], "IMAGE_WIDTH": HW[1],
                   "NOISE_SCHEDULER": {"TYPE": "squaredcos_cap_v2", "PRED_TYPE": "sample"}},
         "EVAL": {"SCHEDULER": "dpm", "SAMPLE_STEPS": 5, "THRESHOLDING": False},
         "TPU": {"FIXED_INIT_NOISE": False}}
PUBLISHED = {"MODEL": {"ARCH": "rdt", "HORIZON": 64, "N_OBS_STEPS": 2}, "TRAIN": SMALL["TRAIN"],
             "EVAL": SMALL["EVAL"], "TPU": {"COMPUTE_DTYPE": "bfloat16"}}
TOL = 1e-5  # float32 against float32: sums in another order


def _cfg(tree=SMALL, **tpu):
    cfg = create_cfg()
    cfg.merge_from_other_cfg(tree)
    cfg.merge_from_other_cfg({"TPU": tpu})
    return cfg


def _plain(cfg):
    from perfbench.core import plain

    return plain(cfg)


def _pair(seed=3, dtype="float32", device="cpu"):
    """(the port's model, the reference, the configuration as plain dicts)
    sharing one state dict of the benchmark's weights."""
    cfg = _cfg(COMPUTE_DTYPE=dtype)
    d = _plain(cfg)
    ref = ref_rdt.build_reference(d["MODEL"])
    sd = make_state_dict(ref.state_dict(), seed, "cpu")
    ref.load_state_dict(sd, strict=True)
    port = build_model(cfg, device=device)
    port.load_state_dict(sd, strict=True)
    return port, ref, d, cfg


def _instruction(rng, d, valid):
    r = d["MODEL"]["RDT"]
    return (rng.standard_normal((r["LANG_SLOTS"], r["LANG_DIM"])).astype(np.float32),
            np.arange(r["LANG_SLOTS"]) < valid)


def test_dit_forward_with_a_masked_instruction_matches_the_reference():
    port, ref, d, _ = _pair()
    g = torch.Generator().manual_seed(0)
    n = lambda *s: torch.randn(*s, generator=g)
    x, lang, img = n(2, 9, 64), n(2, 8, 64), n(2, 96, 64)
    mask = torch.arange(8)[None] < torch.tensor([[5], [8]])
    t, freq = torch.tensor([999.0, 400.0]), torch.tensor([10.0, 10.0])
    with torch.no_grad():
        got = port.model(x, freq, t, lang, img, mask[:, None, None, :])
        want = ref.model(x, freq, t, lang, img, mask)
        unmasked = ref.model(x, freq, t, lang, img, torch.ones_like(mask))
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    assert (got[0] - unmasked[0]).abs().max() > 1e3 * TOL  # the padding is hidden where the mask says
    torch.testing.assert_close(got[1], unmasked[1], atol=TOL, rtol=TOL)


def test_vision_tower_and_preprocessing_match_the_reference():
    port, ref, *_ = _pair(5)
    frames = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (3, *HW, 3), dtype=np.uint8))
    got_img = square_resize(frames, 56)
    want_img = ref_rdt.preprocess(frames, 56)
    torch.testing.assert_close(got_img, want_img.permute(0, 2, 3, 1), atol=1e-6, rtol=0)
    with torch.no_grad():
        got, want = port.vision(got_img), ref.vision(want_img)
    assert got.shape == (3, 16, 32)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


def _plans(planner, frames, targets):
    draws, draw = [], planner._draw
    planner._draw = lambda shape: draws.append(draw(shape)) or draws[-1]
    got = [planner.plan_hypotheses(f, t) for f, t in zip(frames, targets)]
    return got, torch.stack([a for a, _ in draws])


def _reference_plans(ref, d, frames, targets, init, lang, variant="sound"):
    hist = [[0, 0], [0, 1], [1, 2]]  # the first request padded with a copy of itself
    n = len(hist)
    tokens, mask = (torch.from_numpy(a) for a in lang)
    return ref_rdt.plan_batch(ref, d, torch.from_numpy(np.stack([frames[h] for h in hist])),
                              torch.from_numpy(np.stack([targets[h] for h in hist])), init,
                              tokens.expand(n, -1, -1), mask.expand(n, -1), variant)


@pytest.fixture(scope="module")
def planned():
    """Three closed-loop requests through the planner under one instruction:
    the planner's plans and draws, and what the reference needs."""
    from autonomous_driving_with_diffusion_model_tpu_torch.driving.plan import DiffusionPlanner

    _, ref, d, cfg = _pair(7)
    planner = DiffusionPlanner(cfg, seed=5, device="cpu")
    planner.model.load_state_dict(ref.state_dict(), strict=True)
    rng = np.random.default_rng(11)
    lang = _instruction(rng, d, 5)
    planner.reset_history(instruction=lang)
    frames = rng.integers(0, 256, (3, *HW, 3), dtype=np.uint8)
    targets = rng.uniform(-1, 1, (3, 2)).astype(np.float32)
    kernels.reset_launch_counts()
    got, init = _plans(planner, frames, targets)
    counts = kernels.launch_counts()
    return dict(planner=planner, ref=ref, d=d, lang=lang, frames=frames, targets=targets, got=got, init=init,
                counts=counts)


def _gap(got, want):
    return float(np.abs(np.stack([g[0] for g in got]) - want[0].numpy()).max()) / ref_rdt.MAGIC_NUM


def test_plans_over_a_padded_history_match_the_reference(planned):
    p = planned
    want = _reference_plans(p["ref"], p["d"], p["frames"], p["targets"], p["init"], p["lang"])
    assert _gap(p["got"], want) < TOL
    assert [g[1] for g in p["got"]] == want[2].tolist() == [0, 0, 0]
    assert p["got"][0][0].shape == (1, 8, 7)


def test_attention_is_counted(planned):
    """Each plan: the tower's 2 layers and, in each of 5 steps, 4 self- and 4
    cross-attention calls; the cross-attention reads 8 instruction keys in
    even blocks and 2 x 3 x 16 image keys in odd ones."""
    counts = planned["counts"]
    assert counts["attention"] == 3 * (2 + 5 * 8)
    assert counts["attention.cross_keys"] == 3 * 5 * (2 * 8 + 2 * 96)


def test_cross_keys_and_values_are_made_once_a_plan(planned):
    """Each plan projects the 8 instruction tokens in the 2 even blocks and
    the 96 image tokens in the 2 odd ones to keys and values once, not in
    each of its 5 steps."""
    assert planned["counts"]["attention.cross_kv"] == 3 * (2 * 8 + 2 * 96)


def _conditions(seed=3):
    """The port's model and a plan's conditions under an instruction of 5
    valid tokens in 8."""
    port, _, d, _ = _pair(seed)
    rng = np.random.default_rng(seed)
    tokens, mask = (torch.from_numpy(a) for a in _instruction(rng, d, 5))
    frames = torch.from_numpy(rng.integers(0, 256, (2, *HW, 3), dtype=np.uint8))
    with torch.no_grad():
        cond = port.encode_obs(frames, torch.tensor([[0.3, -0.4]]), tokens, mask)
    return port, cond


def test_cached_keys_and_values_give_the_uncached_forward_exactly():
    """The runner's x0 from the plan's cached keys and values equals, bit
    for bit, its x0 from the conditions alone at every t, under a masked
    instruction; the cache is made once (one pass of the conditions'
    tokens) and the cached steps project nothing. A cache of the image
    tokens in the even blocks and of the instruction in the odd ones (no
    mask, so that both fit either block) gives another x0: the cache
    carries the alternation."""
    port, cond = _conditions()
    m, g = port.model, torch.Generator().manual_seed(1)
    kernels.reset_launch_counts()
    with torch.no_grad():
        cached = port.condition_kv(cond)
        assert kernels.launch_counts()["attention.cross_kv"] == 2 * 8 + 2 * 96
        assert len(cached.kv) == 4 and all(k.is_contiguous() and v.is_contiguous() for k, v in cached.kv)
        assert [k.shape for k, _ in cached.kv] == [(1, 4, 8, 16), (1, 4, 96, 16)] * 2
        for t in (999.0, 599.0, 200.0, 0.0):
            x, time = torch.randn(1, 8, 16, generator=g), torch.tensor([t])
            before = kernels.launch_counts()["attention.cross_kv"]
            got = port(x, time, cached)
            assert kernels.launch_counts()["attention.cross_kv"] == before
            want = port(x, time, cond)
            assert kernels.launch_counts()["attention.cross_kv"] == before + 2 * 8 + 2 * 96
            assert torch.equal(got, want), t
        conds = ((cond.lang, m.lang_cond_pos_embed[:, :8]), (cond.img, m.img_cond_pos_embed))
        swapped = tuple(b.cross_attn.keys_values(*conds[1 - i % 2]) for i, b in enumerate(m.blocks))
        sound = port(x, time, cached._replace(lang_mask=None))
        assert (port(x, time, cached._replace(lang_mask=None, kv=swapped)) - sound).abs().max() > 1e3 * TOL


@pytest.mark.parametrize("variant", ["mask_ignored", "alternation_swapped", "t_off_by_one"])
def test_planted_faults_are_beyond_the_tolerance(planned, variant):
    """The reference with a fault planted: far from the port's plans."""
    p = planned
    ref = ref_rdt.build_reference(p["d"]["MODEL"])
    ref.load_state_dict(p["ref"].state_dict(), strict=True)
    want = _reference_plans(ref, p["d"], p["frames"], p["targets"], p["init"], p["lang"], variant)
    assert _gap(p["got"], want) > 1e3 * TOL


def test_second_request_keeps_the_history_and_a_reset_starts_over(planned):
    p = planned
    planner = p["planner"]
    before = [f for f, _ in planner._history]
    np.testing.assert_array_equal(before[0], p["frames"][1])
    np.testing.assert_array_equal(before[1], p["frames"][2])
    planner.reset_history()
    assert not planner._history and planner._instruction is not None


def _diffusers_dpm(ac: np.ndarray, steps: int):
    """diffusers' DPMSolverMultistepScheduler.set_timesteps and its
    dpmsolver++ updates' coefficients, transcribed in float64: the linspace
    grid with lambda_min_clipped -inf; sigma = sqrt((1 - a) / a), alpha_t =
    1 / sqrt(sigma^2 + 1), sigma_t = sigma alpha_t, lambda = log alpha_t -
    log sigma_t, the final sigma 0; first order at the first and the last
    step (lower_order_final), else the 2M midpoint with r0 = h_0 / h."""
    lam_all = 0.5 * (np.log(ac) - np.log1p(-ac))
    clipped = int(np.searchsorted(np.flip(lam_all), -np.inf))
    last = len(ac) - clipped
    ts = np.linspace(0, last - 1, steps + 1).round()[::-1][:-1].copy().astype(np.int64)
    sig = np.sqrt((1 - ac[ts]) / ac[ts])
    sig = np.append(sig, 0.0)
    alpha = 1.0 / np.sqrt(sig ** 2 + 1.0)
    sigma = sig * alpha
    with np.errstate(divide="ignore"):
        lam = np.log(alpha) - np.log(sigma)
    ratio, phi, inv_r = [], [], []
    for i in range(steps):
        h = lam[i + 1] - lam[i]
        ratio.append(sigma[i + 1] / sigma[i])
        phi.append(alpha[i + 1] * math.expm1(-h))
        inv_r.append(0.0 if i in (0, steps - 1) else h / (lam[i] - lam[i - 1]))
    return ts, np.array(ratio), np.array(phi), np.array(inv_r)


def test_dpm_grid_without_a_lambda_clip_matches_diffusers():
    sched = make_schedule("squaredcos_cap_v2", 1000)
    ts = dpm_timesteps(sched, 5, -np.inf)
    assert ts.tolist() == [999, 799, 599, 400, 200]
    assert dpm_timesteps(sched, 5).tolist() != ts.tolist()  # the reference's -5.1 trims the grid
    ac = sched.alphas_cumprod.numpy().astype(np.float64)
    want_ts, ratio, phi, inv_r = _diffusers_dpm(ac, 5)
    assert want_ts.tolist() == ts.tolist()
    got = dpm_coeffs(sched, ts, np.concatenate([ts[1:], [-1]]))
    np.testing.assert_allclose(got.sigma_ratio.numpy(), ratio, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got.phi.numpy(), phi, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got.inv_r.numpy(), inv_r, rtol=1e-6, atol=1e-9)
    rts, alpha, sigma, lam = ref_rdt.dpm_grid(1000, 5)
    assert rts.tolist() == ts.tolist() and sigma[-1] == 0.0 and alpha[-1] == 1.0


def _published_parameters():
    """configs/base.yaml's widths by formula, per module."""
    d, depth, lang, img, state, out = 2048, 28, 4096, 1152, 256, 128
    lin = lambda i, o: i * o + o
    block = lin(d, 3 * d) + lin(d, d) + 2 * 64 + lin(d, d) + lin(d, 2 * d) + lin(d, d) + 2 * 64 + 2 * lin(d, d) + 3 * d
    dit = (2 * (lin(256, d) + lin(d, d)) + (64 + 3) * d + 1024 * d + 2 * 3 * 729 * d + depth * block + d
           + lin(d, d) + lin(d, out))
    w, mlp = 1152, 4304
    layer = 2 * 2 * w + 4 * lin(w, w) + lin(w, mlp) + lin(mlp, w)
    vision = 3 * 14 * 14 * w + w + 729 * w + 27 * layer + 2 * w
    return {"model": dit, "lang_adaptor": lin(lang, d) + lin(d, d), "img_adaptor": lin(img, d) + lin(d, d),
            "state_adaptor": lin(state, d) + 2 * lin(d, d), "vision": vision}


def test_published_sizes_count_the_papers_parameters():
    """Built on the meta device at configs/base.yaml's and SigLIP's widths:
    every module's parameters as the formula gives them (about 1.23 billion
    in the DiT and adaptors, 0.41 billion in the tower)."""
    from autonomous_driving_with_diffusion_model_tpu_torch.models.rdt import RDTRunner

    with torch.device("meta"):
        model = RDTRunner(_cfg(PUBLISHED))
    got = {name: sum(p.numel() for p in mod.parameters()) for name, mod in model.named_children()}
    print(got)
    assert got == _published_parameters()
    assert 1.2e9 < sum(v for k, v in got.items() if k != "vision") < 1.25e9 and 0.41e9 < got["vision"] < 0.42e9
    ref = ref_rdt.build_reference(_plain(_cfg(PUBLISHED))["MODEL"], "meta")
    assert {k: v.shape for k, v in ref.state_dict().items()} == {k: v.shape for k, v in model.state_dict().items()}


def test_the_model_made_on_meta_holds_what_one_made_in_place_holds():
    """``build_model`` makes RDT on the meta device and draws it where it
    lives from the seed's generator alone: every parameter and buffer as a
    model made in place and drawn from the same generator holds them, every
    RMSNorm's gain 1."""
    from autonomous_driving_with_diffusion_model_tpu_torch.models.rdt import RDTRunner, RmsNorm
    from autonomous_driving_with_diffusion_model_tpu_torch.models.temporal_unet import init_parameters

    got = build_model(_cfg(), device="cpu", seed=5)
    want = RDTRunner(_cfg())
    gen = torch.Generator().manual_seed(5)
    init_parameters(want, gen)
    want.init_rest(gen)
    tensors = lambda m: {**dict(m.named_parameters()), **dict(m.named_buffers())}  # noqa: E731
    assert tensors(got).keys() == tensors(want).keys()
    for name, t in tensors(got).items():
        assert torch.equal(t, tensors(want)[name]), name
    norms = [m.weight for m in got.modules() if isinstance(m, RmsNorm)]
    assert norms and all(bool((w == 1).all()) for w in norms)
    assert got.action_mask.sum() == 9 and got.target_slots.tolist() == [8, 9]


def test_the_family_refuses_what_it_does_not_serve(tmp_path):
    from autonomous_driving_with_diffusion_model_tpu_torch.driving.plan import DiffusionPlanner

    with pytest.raises(ValueError, match="rdt"):
        build_model(_cfg(NUM_HYPOTHESES=2), device="cpu")
    cfg = _cfg()
    cfg.merge_from_other_cfg({"GUIDANCE": {"USE_COND": "FREE_GUIDANCE"}})
    with pytest.raises(ValueError, match="rdt"):
        build_model(cfg, device="cpu")
    planner = DiffusionPlanner(_cfg(), device="cpu")
    frame = np.zeros((*HW, 3), np.uint8)
    with pytest.raises(ValueError, match="instruction"):
        planner.plan_hypotheses(frame, np.zeros(2, np.float32))
    with pytest.raises(ValueError, match="instruction"):
        planner.reset_history(instruction=(np.zeros((8, 48), np.float32), np.zeros(8, bool)))
    from autonomous_driving_with_diffusion_model_tpu_torch import distill
    from autonomous_driving_with_diffusion_model_tpu_torch.train import cli

    with pytest.raises(NotImplementedError, match="rdt"):
        cli.main(cli.parse_args(["--device", "cpu", "--max-iter", "1", "--opts", "MODEL.ARCH", "rdt",
                                 "PROJECT_DIR", str(tmp_path / "run")]))
    with pytest.raises(NotImplementedError, match="rdt"):
        distill.main(distill.parse_args(["--device", "cpu", "--checkpoint", str(tmp_path / "t.pt"),
                                         "--workdir", str(tmp_path / "d"), "--opts", "MODEL.ARCH", "rdt"]))
    assert not (tmp_path / "run").exists() and not (tmp_path / "d").exists()


# ---------------------------------------------------------------- the card


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the plan's CUDA graph has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
def test_cuda_bfloat16_plan_graph_matches_its_eager_body_and_counts_attention():
    """A small bfloat16 plan on the card: each plan one replay of a captured
    graph, equal to the eager body on the same inputs; the ``plan`` span
    carries the replay's attention calls, cross-attention keys and the
    condition tokens projected to them, once a plan."""
    _need_card()
    from autonomous_driving_with_diffusion_model_tpu_torch.driving.plan import DiffusionPlanner
    from autonomous_driving_with_diffusion_model_tpu_torch.utils import profiling

    cfg = _cfg(COMPUTE_DTYPE="bfloat16")
    planner = DiffusionPlanner(cfg, seed=2, device="cuda")
    assert next(planner.model.parameters()).dtype == torch.bfloat16
    rng = np.random.default_rng(4)
    planner.reset_history(instruction=_instruction(rng, _plain(cfg), 6))
    profiling.reset()
    profiling.enable()
    try:
        for _ in range(3):
            f, t = rng.integers(0, 256, (*HW, 3), dtype=np.uint8), rng.uniform(-1, 1, 2).astype(np.float32)
            planner.plan_hypotheses(f, t)
    finally:
        profiling.enable(False)
    prog = planner._program.programs[planner._program.key]
    assert prog.graph is not None
    replayed = prog.graph.replay() or tuple(o.clone() for o in prog.outputs)
    eager = planner._plan(*prog.inputs)
    torch.testing.assert_close(replayed[0], eager[0], atol=0, rtol=0)
    spans = [s for s in profiling.report()["spans"] if s["name"] == "plan"]
    assert spans[-1]["attrs"]["rdt.attention"] == 2 + 5 * 8
    assert spans[-1]["attrs"]["rdt.cross_keys"] == 5 * (2 * 8 + 2 * 96)
    assert spans[-1]["attrs"]["rdt.cross_kv"] == 2 * 8 + 2 * 96
    rep = profiling.report()
    assert any("plan.encode" in r["spans"] and "plan.denoise" in r["spans"] for r in rep["device_spans"])
