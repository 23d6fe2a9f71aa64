"""The plan as one program (``driving/program.py``): the planner's input
buffers, program keys and weights invalidation on the CPU, held against the
JAX planner with the injected noise of ``tests/test_torch_plan.py``; and, on
a card only, the CUDA graph against the eager ``_plan`` it captures.

JAX is imported inside the tests that compare with it, so that the ``gpu``
tests also run on a machine without JAX:
``python -m pytest tests/test_torch_plan_program.py -m gpu --noconftest``.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from autonomous_driving_with_diffusion_model_tpu_torch.driving import DiffusionPlanner
from autonomous_driving_with_diffusion_model_tpu_torch.models import build_model
from autonomous_driving_with_diffusion_model_tpu_torch.ops import kernels
from autonomous_driving_with_diffusion_model_tpu_torch.utils.config import create_cfg

# meters: float32 on both sides, x 23.3 m, CFG amplifying by up to 2 * 7.5
# (tests/test_torch_plan.py's TOL)
TOL = dict(atol=5e-3, rtol=1e-4)
TARGETS = [np.array([0.3, 0.1], np.float32), np.array([-0.2, 0.4], np.float32), np.array([0.05, -0.3], np.float32)]
HW = (32, 48)


def _cfg(mode, k=1, scheduler="ddim", fixed_noise=True, dtype="float32"):
    cfg = create_cfg()
    cfg.EVAL.SCHEDULER = scheduler
    cfg.MODEL.DIM = 64 if mode == "CLASSIFIER_GUIDANCE" else 8
    cfg.MODEL.DIM_MULTS = (1, 2)
    cfg.TRAIN.USE_COND = mode
    cfg.GUIDANCE.USE_COND = mode
    cfg.EVAL.SAMPLE_STEPS = 2
    cfg.TRAIN.IMAGE_HEIGHT, cfg.TRAIN.IMAGE_WIDTH = HW
    cfg.TPU.NUM_HYPOTHESES = k
    cfg.TPU.FIXED_INIT_NOISE = fixed_noise
    cfg.TPU.COMPUTE_DTYPE = dtype
    if mode == "FREE_GUIDANCE":
        cfg.GUIDANCE.FREE_SCALE = 7.5
    if mode == "CLASSIFIER_GUIDANCE":
        cfg.GUIDANCE.CLASSIFIER_SCALE = 15.0
        cfg.GUIDANCE.LOSS_LIST = [["TargetGuidance", []]]
    return cfg


def _frames(n, hw=HW, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3), dtype=np.uint8)


def _jax_planner(cfg, port, tmp_path, name="weights.pth"):
    """The JAX planner on the port planner's weights (a reference .pth both load)."""
    from autonomous_driving_with_diffusion_model_tpu.driving.plan import DiffusionPlanner as JaxPlanner
    from port_jax_cfg import jax_cfg_of

    path = tmp_path / name
    torch.save({"state_dict": port.model.state_dict()}, path)
    jcfg = jax_cfg_of(cfg)
    return JaxPlanner(jcfg, checkpoint=str(path))


def _jax_draws(jp, shape, steps):
    """The init and step noise the JAX planner draws for its next plan with
    TPU.FIXED_INIT_NOISE off (JAX plan.py:plan_begin, sampler.py:158-164)."""
    import jax
    import jax.numpy as jnp

    _, sub = jax.random.split(jp._noise_key)
    init = np.array(jax.random.normal(sub, shape, jnp.float32))
    return torch.from_numpy(init), torch.from_numpy(np.array(jax.random.normal(sub, (steps,) + shape, jnp.float32)))


@pytest.mark.parametrize("mode,k,scheduler,fixed", [
    ("NO_GUIDANCE", 1, "ddim", True),
    ("FREE_GUIDANCE", 4, "ddim", True),
    ("CLASSIFIER_GUIDANCE", 2, "ddim", True),
    ("NO_GUIDANCE", 2, "ddpm", False),
])
def test_buffers_follow_every_plan(tmp_path, mode, k, scheduler, fixed):
    """Three plans from one planner, its frame, target and init trajectories
    changed between them (with TPU.FIXED_INIT_NOISE off, the init and step
    noise drawn per plan): each equals the JAX planner's plan for those
    inputs, from one program whose buffers every plan refreshes."""
    import jax.numpy as jnp

    cfg = _cfg(mode, k, scheduler, fixed)
    port = DiffusionPlanner(cfg, seed=0, device="cpu")
    jp = _jax_planner(cfg, port, tmp_path)
    shape = (k, cfg.MODEL.HORIZON, cfg.MODEL.TRANSITION_DIM)
    rng = np.random.default_rng(1)
    frames = _frames(3)
    for i in range(3):
        if fixed:
            init = rng.standard_normal(shape).astype(np.float32)
            port.init_trajs, jp.init_trajs = torch.from_numpy(init), jnp.asarray(init)
        else:
            draws = _jax_draws(jp, shape, port._sample.num_steps)
            port._draw = lambda _shape, d=draws: d
        target = None if mode == "NO_GUIDANCE" else TARGETS[i]
        want, want_best = jp.plan_hypotheses(frames[i], target)
        got, got_best = port.plan_hypotheses(frames[i], target)
        np.testing.assert_allclose(got, want, **TOL, err_msg=f"plan {i}")
        assert got_best == want_best
    assert len(port._program.programs) == 1


def test_weights_loaded_after_a_plan_give_their_plan(tmp_path):
    """New weights after the first plan: the program's key changes, the old
    weights' program is dropped, and the plan is the new weights' plan."""
    cfg = _cfg("FREE_GUIDANCE", 2)
    port = DiffusionPlanner(cfg, seed=0, device="cpu")
    frame = _frames(1)[0]
    first = port.plan_hypotheses(frame, TARGETS[0])[0]
    key = port._program.key
    port.model.load_state_dict(build_model(cfg, device="cpu", seed=1).state_dict())
    jp = _jax_planner(cfg, port, tmp_path, "new.pth")
    port.init_trajs = torch.from_numpy(np.array(jp.init_trajs))
    got, got_best = port.plan_hypotheses(frame, TARGETS[0])
    assert port._program.key != key and port._program.key[:-1] == key[:-1]
    assert list(port._program.programs) == [port._program.key]
    want, want_best = jp.plan_hypotheses(frame, TARGETS[0])
    np.testing.assert_allclose(got, want, **TOL)
    assert got_best == want_best and not np.allclose(got, first)


def test_a_handle_keeps_its_value_across_a_second_plan():
    planner = DiffusionPlanner(_cfg("NO_GUIDANCE", 2), device="cpu")
    frames = _frames(2)
    first = planner.plan_begin(frames[0])
    want = [t.clone() for t in first]
    second = planner.plan_begin(frames[1])
    for a, b in zip(first, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.equal(first[0], second[0])
    np.testing.assert_array_equal(planner.plan_fetch(first), planner.plan(frames[0]))


def test_a_new_frame_shape_is_a_new_program():
    planner = DiffusionPlanner(_cfg("NO_GUIDANCE", 1), device="cpu")
    a = planner.plan(_frames(1)[0])
    planner.plan(_frames(1, (40, 64))[0])
    assert sorted(k[0] for k in planner._program.programs) == [(32, 48, 3), (40, 64, 3)]
    np.testing.assert_array_equal(planner.plan(_frames(1)[0]), a)


# ------------------------------------------------------------------ card only


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph and the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _assert_replay_counts(eager_launches):
    """The launches a replay counts: the eager body's calls of each wrapper
    and launches on each path; every one-wave, streamed and folded launch of
    the graph with PDL (its capture found every pack cached), the eager
    body's only where it did."""
    got = kernels.launch_counts()
    one_wave, streamed, folded = ("fused_residual_block." + p for p in ("one_wave", "streamed", "folded"))
    for k in kernels.WRAPPERS + (one_wave, streamed, folded):
        assert got[k] == eager_launches[k]
    assert all(eager_launches[k] for k in kernels.WRAPPERS)
    assert got["fused_residual_block.pdl"] == got[one_wave] + got[streamed] + got[folded] >= eager_launches[
        "fused_residual_block.pdl"]
    return got


def _eager(planner, frame, target):
    """The eager body on the plan's inputs, with the launches it counts."""
    tgt = np.zeros((1, 2), np.float32) if target is None else target.reshape(1, 2)
    kernels.reset_launch_counts()
    trajs, best = planner._plan(planner.init_trajs, torch.from_numpy(frame).cuda(), torch.from_numpy(tgt).cuda(),
                                planner.step_noise)
    return trajs.cpu().numpy(), int(best), kernels.launch_counts()


@pytest.mark.gpu
@pytest.mark.parametrize("mode,k,scheduler,dtype", [
    ("NO_GUIDANCE", 1, "ddim", "float32"),
    ("FREE_GUIDANCE", 4, "ddim", "float32"),
    ("CLASSIFIER_GUIDANCE", 2, "ddim", "float32"),
    ("NO_GUIDANCE", 2, "ddpm", "float32"),
    ("FREE_GUIDANCE", 2, "dpm", "bfloat16"),
    ("CLASSIFIER_GUIDANCE", 1, "ddim", "bfloat16"),
])
def test_graph_equals_eager_on_card(mode, k, scheduler, dtype):
    """Each plan replays the captured graph and equals the eager body on the
    same inputs (1e-5 m in float32; bfloat16 within the 1 m of
    chip_smoke.py's BF16_PLAN_TOL); a replay counts the launches the eager
    body counts."""
    _need_card()
    planner = DiffusionPlanner(_cfg(mode, k, scheduler, dtype=dtype), seed=0, device="cuda")
    frames = _frames(3)
    for i, frame in enumerate(frames):
        target = None if mode == "NO_GUIDANCE" else TARGETS[i]
        want, want_best, eager_launches = _eager(planner, frame, target)
        kernels.reset_launch_counts()
        got, best = planner.plan_hypotheses(frame, target)
        replay_launches = _assert_replay_counts(eager_launches)
        np.testing.assert_allclose(got, want, atol=1e-5 if dtype == "float32" else 1.0, rtol=0)
        if dtype == "float32":
            assert best == want_best
    prog = planner._program.programs[planner._program.key]
    assert len(planner._program.programs) == 1 and prog.graph is not None and prog.launches == replay_launches


@pytest.mark.gpu
def test_cfg_student_key_on_card():
    """The key every CFG student replays (``learnability.student_cfg``):
    ``GUIDANCE.FREE_SCALE`` 1.0, a distilled 2-step ``TPU.SAMPLE_TIMESTEPS``
    grid, bfloat16. The graph's plan equals the eager body's bit for bit,
    counts its launches, and stays within chip_smoke.py's bf16 bound (1 m
    at scale 1) of the CPU planner's plan from the same weights and draw."""
    _need_card()
    cfg = _cfg("FREE_GUIDANCE", dtype="bfloat16")
    cfg.GUIDANCE.FREE_SCALE = 1.0
    cfg.TPU.SAMPLE_TIMESTEPS = [98, 34]
    planner = DiffusionPlanner(cfg, seed=0, device="cuda")
    cpu = DiffusionPlanner(cfg, seed=0, device="cpu")
    cpu.init_trajs = planner.init_trajs.cpu()
    for frame, target in zip(_frames(3), TARGETS):
        want, want_best, eager_launches = _eager(planner, frame, target)
        kernels.reset_launch_counts()
        got, best = planner.plan_hypotheses(frame, target)
        _assert_replay_counts(eager_launches)
        assert eager_launches["fused_conv1d_gn_mish"] == 2  # one head a step
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, cpu.plan_hypotheses(frame, target)[0], atol=1.0, rtol=0)
    assert len(planner._program.programs) == 1


@pytest.mark.gpu
def test_new_frame_shape_captures_anew_on_card():
    _need_card()
    planner = DiffusionPlanner(_cfg("FREE_GUIDANCE", 2), seed=0, device="cuda")
    for hw in (HW, (40, 64), HW):
        frame = _frames(1, hw)[0]
        np.testing.assert_allclose(planner.plan_hypotheses(frame, TARGETS[0])[0],
                                   _eager(planner, frame, TARGETS[0])[0], atol=1e-5, rtol=0)
    assert sorted(k[0] for k in planner._program.programs) == [(32, 48, 3), (40, 64, 3)]


@pytest.mark.gpu
def test_stale_weights_capture_anew_on_card():
    """Weights loaded after a capture: the next plan captures again and
    gives the new weights' plan, never the old graph's."""
    _need_card()
    cfg = _cfg("CLASSIFIER_GUIDANCE", 1)
    planner = DiffusionPlanner(cfg, seed=0, device="cuda")
    frame = _frames(1)[0]
    old = planner.plan_hypotheses(frame, TARGETS[0])[0]
    graph = planner._program.programs[planner._program.key].graph
    planner.model.load_state_dict(build_model(cfg, device="cpu", seed=1).state_dict())
    got = planner.plan_hypotheses(frame, TARGETS[0])[0]
    assert planner._program.programs[planner._program.key].graph is not graph
    np.testing.assert_allclose(got, _eager(planner, frame, TARGETS[0])[0], atol=1e-5, rtol=0)
    assert not np.allclose(got, old)


@pytest.mark.gpu
def test_capture_on_a_worker_thread_on_card():
    """A pipelined agent's worker thread captures the first plan; a replay
    on the main thread gives the same plan, bit for bit."""
    _need_card()
    planner = DiffusionPlanner(_cfg("CLASSIFIER_GUIDANCE", 1), seed=0, device="cuda")
    frame = _frames(1)[0]
    with ThreadPoolExecutor(max_workers=1) as pool:
        worker = pool.submit(planner.plan_hypotheses, frame, TARGETS[0]).result()[0]
        again = pool.submit(planner.plan_hypotheses, frame, TARGETS[0]).result()[0]
    np.testing.assert_array_equal(planner.plan_hypotheses(frame, TARGETS[0])[0], worker)
    np.testing.assert_array_equal(again, worker)
    assert len(planner._program.programs) == 1
