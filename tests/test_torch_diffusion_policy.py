"""Diffusion Policy's CNN planner on the port (``MODEL.ARCH``
``conditional_unet1d``): the FiLM residual block, the ResNet-18-GroupNorm
keypoint encoder, the U-Net's forward, a DDPM plan over a padded two-frame
history through ``DiffusionPlanner`` and the FiLM block's ``Recompute``
gradient, each held on the CPU to ``tests/plain_diffusion_policy.py`` (plain
PyTorch, independent of the port) at a small size on seeded random
weights; the family is opt-in, serving only (the train and distill CLIs
refuse it). On a card (``gpu``): the FiLM launch at each of the 12 block
geometries of the published widths and the 512-wide head against their
plain versions, the FiLM gradient, and a plan's launches by capture.
``python -m pytest tests/test_torch_diffusion_policy.py -m gpu --noconftest``
runs the card's part without JAX.
"""

import numpy as np
import pytest
import torch

import plain_diffusion_policy as plain
from autonomous_driving_with_diffusion_model_tpu_torch.models import build_model
from autonomous_driving_with_diffusion_model_tpu_torch.models.conditional_unet1d import (ConditionalResidualBlock1D,
                                                                                         ConditionalUnet1D)
from autonomous_driving_with_diffusion_model_tpu_torch.models.temporal_unet import TemporalMapUnet
from autonomous_driving_with_diffusion_model_tpu_torch.ops import kernels
from autonomous_driving_with_diffusion_model_tpu_torch.utils.config import create_cfg

torch.set_num_threads(1)  # several test processes share the cores

HW = (32, 64)
DP_OPTS = ["MODEL.ARCH", "conditional_unet1d", "MODEL.DIM", "16", "MODEL.DIM_MULTS", "[1, 2, 4]",
           "MODEL.PERCEPTION", "resnet18_gn_keypoints", "EVAL.SCHEDULER", "ddpm",
           "TRAIN.NOISE_SCHEDULER.PRED_TYPE", "epsilon", "EVAL.THRESHOLDING", "False",
           "TPU.FIXED_INIT_NOISE", "False", "TRAIN.IMAGE_HEIGHT", str(HW[0]), "TRAIN.IMAGE_WIDTH", str(HW[1]),
           "MODEL.STEP_EMBED_DIM", "128", "MODEL.N_OBS_STEPS", "2", "MODEL.OBS_FEATURE_DIM", "64",
           "MODEL.NUM_KEYPOINTS", "32"]
# every block of the published widths (DIM 512, DIM_MULTS (1, 2, 4)): (L, Cin, C)
DP_BLOCKS = [(16, 7, 512), (16, 512, 512), (8, 512, 1024), (8, 1024, 1024), (4, 1024, 2048), (4, 2048, 2048),
             (4, 2048, 2048), (4, 2048, 2048), (4, 4096, 1024), (4, 1024, 1024), (8, 2048, 512), (8, 512, 512)]
COND_DIM = 128 + 2 * (64 + 2)


def _cfg(*more):
    cfg = create_cfg()
    cfg.merge_from_list(DP_OPTS + list(more))
    return cfg


def _seeded(model, seed):
    """Weights for ``model`` from ``seed``: its initializer's, with every
    norm's gamma in [0.5, 1] and beta in [-0.1, 0.1] (not the identity)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.GroupNorm):
                mod.weight.copy_(0.5 + 0.5 * torch.rand(mod.weight.shape, generator=g))
                mod.bias.copy_(0.2 * torch.rand(mod.bias.shape, generator=g) - 0.1)
    return model.state_dict()


def _pair(seed=3):
    """The port's model and the reference, one state dict."""
    cfg = _cfg()
    model = build_model(cfg, device="cpu", seed=seed)
    ref = plain.build_reference(dict(cfg.MODEL), "cpu")
    ref.load_state_dict(_seeded(model, seed), strict=True)
    return cfg, model, ref


def test_arch_defaults_to_the_reference_family():
    """The new keys default to the reference's family and its agents'
    thresholding; an unknown family is refused."""
    cfg = create_cfg()
    assert cfg.MODEL.ARCH == "temporal_map_unet" and cfg.EVAL.THRESHOLDING is True
    cfg.merge_from_list(["MODEL.DIM", "8", "MODEL.PERCEPTION", "tiny"])
    assert isinstance(build_model(cfg, device="cpu"), TemporalMapUnet)
    cfg.MODEL.ARCH = "unet2"
    with pytest.raises(ValueError, match="MODEL.ARCH"):
        build_model(cfg, device="cpu")


def test_published_widths_count_the_papers_parameters():
    """251.5M in the U-Net (95.8% in its 12 residual blocks) and 11.2M in
    the encoder, on the meta device."""
    with torch.device("meta"):
        m = ConditionalUnet1D(7, 512, (1, 2, 4))
    enc = sum(p.numel() for p in m.perception.parameters())
    unet = sum(p.numel() for p in m.parameters()) - enc
    blocks = [b for b in m.modules() if isinstance(b, ConditionalResidualBlock1D)]
    assert len(blocks) == 12 and [(b.blocks[0].block[0].in_channels, b.blocks[0].block[0].out_channels)
                                  for b in blocks] == [(cin, c) for _, cin, c in DP_BLOCKS]
    assert unet == 251_529_863 and enc == 11_197_088
    assert 0.957 < sum(p.numel() for b in blocks for p in b.parameters()) / unet < 0.959


def test_film_block_matches_the_reference():
    """One FiLM block (the kernel's plain version on the CPU) against the
    reference's module. Tolerance: float32 rounding of the same sums in
    another order (channels-last convolutions)."""
    torch.manual_seed(0)
    port = ConditionalResidualBlock1D(24, 32, 20)
    ref = plain.ConditionalResidualBlock1D(24, 32, 20)
    ref.load_state_dict(_seeded(port, 5), strict=True)
    x, cond = torch.randn(3, 8, 24), torch.randn(3, 20)
    with torch.no_grad():
        got = port(x, cond)
        want = ref(x.transpose(1, 2), cond).transpose(1, 2)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=2e-6)


def test_encoder_matches_the_reference():
    """Both frames' features (the trunk, the keypoints' spatial softmax, the
    linear layer) and the observation vector. Tolerance: float32 rounding
    through 18 GroupNorm layers."""
    cfg, model, ref = _pair()
    rng = np.random.default_rng(1)
    frames = torch.from_numpy(rng.integers(0, 256, (2, *HW, 3), dtype=np.uint8))
    targets = torch.from_numpy(rng.uniform(-1, 1, (2, 2)).astype(np.float32))
    with torch.no_grad():
        got = model.encode_obs(frames.float() / 255.0, targets)
        want = ref.encode(frames[None], targets[None])
    assert got.shape == (1, 2 * 66)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_forward_matches_the_reference():
    """The U-Net's forward at K = 3 rows from one observation vector.
    Tolerance: float32 rounding through 12 blocks."""
    cfg, model, ref = _pair()
    g = torch.Generator().manual_seed(2)
    x, obs = torch.randn(3, 16, 7, generator=g), torch.randn(3, 132, generator=g)
    t = torch.tensor([99.0, 50.0, 0.0])
    with torch.no_grad():
        got = model(x, time=t, img_feature=obs)
        want = ref(x, t, obs)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_ddpm_plan_over_a_padded_history_matches_the_reference():
    """Three closed-loop requests through ``DiffusionPlanner`` (DDPM-100,
    epsilon, clipping, fresh init and step noise each plan): the first plan's
    history is the first request twice, then (r0, r1), (r1, r2). The
    reference recomputes each from its history and the planner's draws.
    Tolerance: float32 rounding over 100 steps, which the clip and the
    posterior's contraction keep small."""
    from autonomous_driving_with_diffusion_model_tpu_torch.driving.plan import DiffusionPlanner

    cfg = _cfg("EVAL.SAMPLE_STEPS", "100", "TPU.NUM_HYPOTHESES", "2")
    planner = DiffusionPlanner(cfg, seed=0, device="cpu")
    ref = plain.build_reference(dict(cfg.MODEL), "cpu")
    ref.load_state_dict(_seeded(planner.model, 4), strict=True)
    draws, draw = [], planner._draw
    planner._draw = lambda shape: draws.append(draw(shape)) or draws[-1]
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, (3, *HW, 3), dtype=np.uint8)
    targets = rng.uniform(-1, 1, (3, 2)).astype(np.float32)
    got = [planner.plan_hypotheses(f, t) for f, t in zip(frames, targets)]
    hist = [(0, 0), (0, 1), (1, 2)]
    fr = torch.from_numpy(np.stack([frames[list(h)] for h in hist]))
    tg = torch.from_numpy(np.stack([targets[list(h)] for h in hist]))
    init = torch.stack([d[0] for d in draws])
    noise = torch.stack([d[1] for d in draws])
    assert noise.shape == (3, 100, 2, 16, 7)
    want, scores, best = plain.plan_batch(ref, cfg, fr, tg, init, noise)
    got_t = np.stack([g[0] for g in got])
    assert np.abs(got_t - want.numpy()).max() / plain.MAGIC_NUM < 1e-4
    assert [g[1] for g in got] == best.tolist()
    # the history starts again after reset_history: the program's frame
    # input holds the request twice
    planner.reset_history()
    planner.plan_hypotheses(frames[1], targets[1])
    frame_in = planner._program.programs[planner._program.key].inputs[1]
    assert (frame_in.numpy() == frames[[1, 1]]).all()


def test_film_recompute_gradient_matches_the_reference():
    """``Recompute`` over the FiLM block (launch and plain version both the
    plain one on the CPU): its gradients of x, the conditioning and the
    FiLM projection against autograd of the reference module."""
    torch.manual_seed(1)
    port = ConditionalResidualBlock1D(12, 16, 10)
    ref = plain.ConditionalResidualBlock1D(12, 16, 10)
    ref.load_state_dict(_seeded(port, 6), strict=True)
    x = torch.randn(2, 8, 12, requires_grad=True)
    cond = torch.randn(2, 10, requires_grad=True)
    params = [a.detach().clone().requires_grad_(True) for a in port.kernel_params()]
    out = kernels.Recompute.apply(kernels.residual_block_plain, kernels.residual_block_plain, {}, x, cond, *params)
    w = torch.randn(out.shape)
    gx, gc, gtw = torch.autograd.grad((out * w).sum(), [x, cond, params[4]])
    xr = x.detach().clone().requires_grad_(True)
    cr = cond.detach().clone().requires_grad_(True)
    lin = ref.cond_encoder[1]
    out_r = ref(xr.transpose(1, 2), cr).transpose(1, 2)
    rx, rc, rw = torch.autograd.grad((out_r * w).sum(), [xr, cr, lin.weight])
    # float32 rounding of the backward's sums
    for a, b in ((gx, rx), (gc, rc), (gtw, rw.t())):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_planner_refuses_guidance_and_per_step_encoding():
    from autonomous_driving_with_diffusion_model_tpu_torch.driving.plan import DiffusionPlanner

    for more in (["GUIDANCE.USE_COND", "FREE_GUIDANCE"], ["TPU.HOIST_PERCEPTION", "False"]):
        with pytest.raises(ValueError, match="conditional_unet1d"):
            DiffusionPlanner(_cfg(*more), device="cpu")


def test_train_cli_refuses_the_family(tmp_path):
    from autonomous_driving_with_diffusion_model_tpu_torch.train import cli

    with pytest.raises(NotImplementedError, match="conditional_unet1d"):
        cli.main(cli.parse_args(["--device", "cpu", "--max-iter", "1", "--opts", *DP_OPTS,
                                 "PROJECT_DIR", str(tmp_path / "run")]))
    assert not (tmp_path / "run").exists()


def test_distill_cli_refuses_the_family(tmp_path):
    from autonomous_driving_with_diffusion_model_tpu_torch import distill

    with pytest.raises(NotImplementedError, match="conditional_unet1d"):
        distill.main(distill.parse_args(["--device", "cpu", "--checkpoint", str(tmp_path / "t.pt"),
                                         "--workdir", str(tmp_path / "d"), "--opts", *DP_OPTS]))
    assert not (tmp_path / "d").exists()


# ---------------------------------------------------------------- the card


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _film_args(rng, B, L, cin, c, e, device):
    u = lambda shape, fan: torch.from_numpy((rng.uniform(-1, 1, shape) / np.sqrt(fan)).astype(np.float32))
    n = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    res = cin != c
    args = [n(B, L, cin), n(B, e), u((5, cin, c), 5 * cin), u((c,), 5 * cin), 1 + 0.1 * n(c), 0.1 * n(c),
            u((e, 2 * c), e), u((2 * c,), e), u((5, c, c), 5 * c), u((c,), 5 * c), 1 + 0.1 * n(c), 0.1 * n(c),
            u((1, cin, c), cin) if res else None, u((c,), cin) if res else None]
    return [None if a is None else a.to(device) for a in args]


@pytest.mark.gpu
@pytest.mark.parametrize("L,cin,c", sorted(set(DP_BLOCKS)))
def test_cuda_film_block_matches_plain_at_published_widths(L, cin, c):
    """B = 1, E = 260: the FiLM launch and its residual launch, on whichever
    path each takes, against the plain version. Tolerance: the existing
    kernels' float32 one, sums in another order than cuDNN's."""
    _need_card()
    args = _film_args(np.random.default_rng(L * cin + c), 1, L, cin, c, COND_DIM, "cuda")
    before = kernels.launch_counts()
    with torch.no_grad():
        got = kernels.fused_residual_block(*args)
        want = kernels.residual_block_plain(*args)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after[kernels.FILM] == before[kernels.FILM] + 1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_cuda_head_at_the_published_width():
    """The 512-wide head at L = 16 (staged input channels) against its
    plain version."""
    _need_card()
    rng = np.random.default_rng(9)
    args = [torch.from_numpy(a).cuda() for a in (
        rng.standard_normal((1, 16, 512)).astype(np.float32),
        (rng.uniform(-1, 1, (5, 512, 512)) / np.sqrt(5 * 512)).astype(np.float32),
        (rng.uniform(-1, 1, 512) / np.sqrt(5 * 512)).astype(np.float32),
        (1 + 0.1 * rng.standard_normal(512)).astype(np.float32), (0.1 * rng.standard_normal(512)).astype(np.float32))]
    with torch.no_grad():
        got = kernels.fused_conv1d_gn_mish(*args)
    torch.testing.assert_close(got, kernels.conv1d_gn_mish_plain(*args), atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_cuda_film_recompute_gradient():
    """The FiLM call under autograd on the card: the kernel's forward, the
    plain version's gradient, against autograd of the plain version."""
    _need_card()
    args = _film_args(np.random.default_rng(4), 2, 8, 64, 128, 36, "cuda")
    leaves = [None if a is None else a.requires_grad_(True) for a in args]
    out = kernels.fused_residual_block(*leaves)
    assert "Recompute" in type(out.grad_fn).__name__
    live = [a for a in leaves if a is not None]
    got = torch.autograd.grad(out.square().sum(), live)
    want = torch.autograd.grad(kernels.residual_block_plain(*leaves).square().sum(), live)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_cuda_plan_launches_film_blocks_by_capture():
    """A small DDPM plan on the card: one replay a plan whose capture counts
    12 FiLM calls a step and the head once; its plans match the CPU's."""
    _need_card()
    from autonomous_driving_with_diffusion_model_tpu_torch.driving.plan import DiffusionPlanner

    cfg = _cfg("EVAL.SAMPLE_STEPS", "10")
    gpu, cpu = DiffusionPlanner(cfg, device="cuda"), DiffusionPlanner(cfg, device="cpu")
    cpu.model.load_state_dict(_seeded(gpu.model, 8))
    rng = np.random.default_rng(3)
    for _ in range(3):
        f, t = rng.integers(0, 256, (*HW, 3), dtype=np.uint8), rng.uniform(-1, 1, 2).astype(np.float32)
        a, b = gpu.plan_hypotheses(f, t)[0], cpu.plan_hypotheses(f, t)[0]
        np.testing.assert_allclose(a, b, atol=1e-3 * plain.MAGIC_NUM)
    prog = gpu._program.programs[gpu._program.key]
    assert prog.launches["fused_residual_block"] == 120 and prog.launches[kernels.FILM] == 120
    assert prog.launches["fused_conv1d_gn_mish"] == 10
