"""The programs' spans and counters (``utils/profiling.py`` in
``driving/plan.py``, ``driving/program.py``, ``train/program.py``,
``train/state.py`` and ``data/augment.py``).

On the CPU: a planner, a train program and the augmentation program record
their host spans, nested by parent and request, and their counters, with no
device spans (no graph is captured there), and tracing leaves their results
as they are.

On a card only (``gpu``): a plan replay's device spans add up to its
first-to-last marker span, which CUDA events around the replay confirm; the
kernel nodes counted at capture are the kernels the profiler sees in a
replay, less the markers; the train graph's spans add up to its replay;
tracing adds no synchronize; a recapture is counted; and the spans' ranges
on the device add nothing to the benchmark's busy time. This file does not
import JAX: ``python -m pytest tests/test_torch_tracing.py -m gpu
--noconftest``.
"""

import warnings

import numpy as np
import pytest
import torch

from autonomous_driving_with_diffusion_model_tpu_torch.data import AugmentProgram
from autonomous_driving_with_diffusion_model_tpu_torch.diffusion import make_schedule
from autonomous_driving_with_diffusion_model_tpu_torch.driving import DiffusionPlanner
from autonomous_driving_with_diffusion_model_tpu_torch.models import build_model
from autonomous_driving_with_diffusion_model_tpu_torch.train import create_train_state, make_train_step
from autonomous_driving_with_diffusion_model_tpu_torch.train.cli import iteration_generators
from autonomous_driving_with_diffusion_model_tpu_torch.train.program import TrainProgram
from autonomous_driving_with_diffusion_model_tpu_torch.utils import profiling
from autonomous_driving_with_diffusion_model_tpu_torch.utils.config import create_cfg

HW = (32, 48)
PLAN_SPANS = ["plan.weights_key", "plan.inputs", "plan.replay", "plan.outputs"]


@pytest.fixture(autouse=True)
def clean():
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


def plan_cfg(mode="FREE_GUIDANCE", k=1, dim=8, hw=HW, steps=2, perception="tiny", mults=(1, 2)):
    cfg = create_cfg()
    cfg.MODEL.DIM = dim
    cfg.MODEL.DIM_MULTS = mults
    cfg.MODEL.PERCEPTION = perception
    cfg.TRAIN.USE_COND = cfg.GUIDANCE.USE_COND = mode
    cfg.GUIDANCE.FREE_SCALE = 7.5
    cfg.EVAL.SAMPLE_STEPS = steps
    cfg.TRAIN.IMAGE_HEIGHT, cfg.TRAIN.IMAGE_WIDTH = hw
    cfg.TPU.NUM_HYPOTHESES = k
    return cfg


def train_cfg(groups=1, dim=8, hw=HW, perception="tiny", mults=(1, 2)):
    cfg = plan_cfg("NO_GUIDANCE", dim=dim, hw=hw, perception=perception, mults=mults)
    cfg.TRAIN.TIME_STEPS = cfg.TRAIN.SAMPLE_STEPS = 10
    cfg.TRAIN.LR_WARMUP = 1
    cfg.TRAIN.GRADIENT_ACCUMULATION_STEPS = groups
    return cfg


def frames(n, hw=HW, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3), dtype=np.uint8)


def batch_of(device, batch=4, hw=HW, seed=1):
    rng = np.random.default_rng(seed)
    return {"image": torch.from_numpy(rng.standard_normal((batch, *hw, 3)).astype(np.float32)).to(device),
            "trajs": torch.from_numpy((rng.standard_normal((batch, 16, 7)) * 0.3).astype(np.float32)).to(device),
            "target": torch.from_numpy(rng.standard_normal((batch, 2)).astype(np.float32)).to(device)}


def by_request(spans, name):
    return {s["request"]: s for s in spans if s["name"] == name}


# ------------------------------------------------------------------ CPU


def test_planner_records_its_host_spans_on_the_cpu():
    planner = DiffusionPlanner(plan_cfg(), device="cpu")
    target = np.array([0.2, -0.1], np.float32)
    planner.plan(frames(1)[0], target)  # untraced
    profiling.enable()
    for f in frames(2, seed=1):
        planner.plan(f, target)
    rep = profiling.report()
    roots = by_request(rep["spans"], "plan")
    assert sorted(roots) == [1, 2]
    for request, root in roots.items():
        assert root["parent"] is None
        assert root["attrs"]["launches"] == {} and "frame (32, 48, 3)" in root["attrs"]["key"]
        children = [s for s in rep["spans"] if s["parent"] == root["id"]]
        assert [s["name"] for s in children] == PLAN_SPANS  # no build: the CPU captures nothing
        assert all(s["request"] == request for s in children)
        assert by_request(rep["spans"], "plan.fetch")[request]["parent"] is None
    assert rep["device_spans"] == [] and rep["graphs"] == []
    assert rep["counters"] == {"weights_generations.plan": {"count": 1, "seconds": 0.0},
                               "weights_walks.plan": {"count": 1, "seconds": 0.0}}


def test_new_weights_are_a_new_generation_on_the_cpu():
    cfg = plan_cfg()
    planner = DiffusionPlanner(cfg, device="cpu")
    planner.plan(frames(1)[0])
    planner.model.load_state_dict(build_model(cfg, device="cpu", seed=1).state_dict())
    planner.plan(frames(1)[0])
    planner.plan(frames(1)[0])
    assert profiling.report()["counters"]["weights_generations.plan"]["count"] == 2


def test_tracing_leaves_the_plan_as_it_is():
    cfg = plan_cfg(k=2)
    off, on = DiffusionPlanner(cfg, device="cpu"), DiffusionPlanner(cfg, device="cpu")
    target = np.array([0.3, 0.1], np.float32)
    want = [off.plan_hypotheses(f, target) for f in frames(2)]
    profiling.enable()
    got = [on.plan_hypotheses(f, target) for f in frames(2)]
    for (a, i), (b, j) in zip(want, got):
        np.testing.assert_array_equal(a, b)
        assert i == j
    assert len(by_request(profiling.report()["spans"], "plan")) == 2


def test_train_program_records_its_host_spans_on_the_cpu():
    cfg = train_cfg()
    state = create_train_state(build_model(cfg, device="cpu", seed=0), cfg)
    program = TrainProgram(make_train_step(make_schedule("squaredcos_cap_v2", 10), cfg), "cpu")
    batch = batch_of("cpu")
    program(state, batch, generator=iteration_generators(0, "cpu")[1])  # untraced
    profiling.enable()
    for it in (1, 2):
        program(state, batch, generator=iteration_generators(it, "cpu")[1])
    rep = profiling.report()
    roots = by_request(rep["spans"], "step")
    assert sorted(roots) == [1, 2]  # the state's step count
    for request, root in roots.items():
        children = [s["name"] for s in rep["spans"] if s["parent"] == root["id"]]
        assert children == ["step.state_key", "step.replay", "step.state_key"]
    assert rep["device_spans"] == [] and rep["graphs"] == [] and rep["counters"] == {}


def test_augment_program_records_its_host_spans_on_the_cpu():
    program = AugmentProgram("cpu")
    images = torch.from_numpy(frames(2))
    want = program(images, torch.Generator().manual_seed(3), 0)
    profiling.enable()
    again = AugmentProgram("cpu")(images, torch.Generator().manual_seed(3), 0)
    torch.testing.assert_close(again, want, atol=0, rtol=0)
    rep = profiling.report()
    (root,) = [s for s in rep["spans"] if s["name"] == "augment"]
    assert root["request"] == 0
    assert [s["name"] for s in rep["spans"] if s["parent"] == root["id"]] == ["augment.draws", "augment.replay"]
    assert rep["device_spans"] == [] and rep["graphs"] == []


# ------------------------------------------------------------------ card only


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph and its markers have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _timed_replays(prog, n, name):
    """``n`` replays of ``prog``'s graph, each inside a root span of its own
    request and between CUDA events on the stream: the events' ms."""
    profiling.enable()
    pairs = []
    for i in range(n):
        with profiling.span(name, request=i):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            prog.graph.replay()
            e1.record()
            prog.spans.replayed()
            pairs.append((e0, e1))
    torch.cuda.synchronize()
    profiling.enable(False)
    return [e0.elapsed_time(e1) for e0, e1 in pairs]


@pytest.mark.gpu
def test_plan_device_spans_add_up_to_the_replay_on_card():
    """At the width of the CFG cell (ResNet-34 at 256x900, DDIM-10, dual
    batch): encode + denoise + score is the first-to-last marker span, and
    that is within 2% of CUDA events around the replay."""
    _need_card()
    cfg = plan_cfg(dim=64, hw=(256, 900), steps=10, perception="resnet34", mults=(1, 2, 4, 8))
    planner = DiffusionPlanner(cfg, seed=0, device="cuda")
    planner.plan(frames(1, (256, 900))[0], np.array([0.2, 0.1], np.float32))
    prog = planner._program.programs[planner._program.key]
    events_ms = _timed_replays(prog, 8, "plan")
    rep = profiling.report()
    (graph,) = [g for g in rep["graphs"] if g["id"] == prog.spans.id]
    assert graph["spans"] == ["plan.encode", "plan.denoise", "plan.score"] and graph["markers"] == 4
    assert graph["attrs"] == {"steps": 10} and graph["kernels"]["plan.denoise"] > 0
    spans = [r for r in rep["device_spans"] if r["graph_id"] == prog.spans.id]
    assert [r["request"] for r in spans] == list(range(8))
    for r, ms in zip(spans, events_ms):
        assert sum(r["spans"].values()) == pytest.approx(r["replay_ms"], rel=1e-9)
        assert all(v > 0 for v in r["spans"].values())
        assert r["replay_ms"] == pytest.approx(ms, rel=0.02)


@pytest.mark.gpu
def test_kernel_nodes_counted_at_capture_are_the_profiler_kernels_on_card():
    """One replay under the profiler: its kernels, less the markers, are the
    kernel nodes the capture counted (a profile that lost records, which a
    large graph's can, is taken again, three times at most)."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile

    planner = DiffusionPlanner(plan_cfg(k=2), seed=0, device="cuda")
    planner.plan(frames(1)[0], np.array([0.2, 0.1], np.float32))
    prog = planner._program.programs[planner._program.key]
    graph = prog.spans.describe()
    assert graph["kernel_nodes"] == sum(graph["kernels"].values()) > 0
    counted = []
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prog.graph.replay()
            torch.cuda.synchronize()
        # a graph's copy nodes run as memcpy32_* kernels, which are not kernel nodes
        counted.append(sum(1 for ev in prof.events()
                           if ev.device_type == torch.autograd.DeviceType.CUDA
                           and not getattr(ev, "is_user_annotation", False)
                           and "memcpy" not in ev.name.lower() and "memset" not in ev.name.lower()))
        if counted[-1] - graph["markers"] == graph["kernel_nodes"]:
            break
    assert counted[-1] - graph["markers"] == graph["kernel_nodes"], counted


@pytest.mark.gpu
def test_train_graph_spans_add_up_to_the_replay_on_card():
    """Two micro-batches at 256x900 with ResNet-34: forward, backward and the
    optimizer (6 markers), summed by name, are the replay, within 2% of
    CUDA events around it."""
    _need_card()
    cfg = train_cfg(groups=2, dim=64, hw=(256, 900), perception="resnet34", mults=(1, 2, 4, 8))
    state = create_train_state(build_model(cfg, device="cuda", seed=0), cfg)
    program = TrainProgram(make_train_step(make_schedule("squaredcos_cap_v2", 10, device="cuda"), cfg), "cuda")
    batch = batch_of("cuda", hw=(256, 900))
    for it in range(2):
        program(state, batch, generator=iteration_generators(it, "cuda")[1])
    prog = program.captured()
    events_ms = _timed_replays(prog, 4, "step")
    rep = profiling.report()
    graph = prog.spans.describe()
    assert graph["markers"] == 6 and graph["spans"] == ["step.forward", "step.backward"] * 2 + ["step.optimizer"]
    spans = [r for r in rep["device_spans"] if r["graph_id"] == prog.spans.id]
    assert len(spans) == 4
    for r, ms in zip(spans, events_ms):
        assert set(r["spans"]) == {"step.forward", "step.backward", "step.optimizer"}
        assert sum(r["spans"].values()) == pytest.approx(r["replay_ms"], rel=1e-9)
        assert r["replay_ms"] == pytest.approx(ms, rel=0.02)


@pytest.mark.gpu
def test_augment_graph_is_one_device_span_on_card():
    _need_card()
    program = AugmentProgram("cuda")
    images = torch.from_numpy(frames(8, (256, 900))).cuda()
    program(images, torch.Generator().manual_seed(0), 0)
    prog = program.programs[program.key]
    events_ms = _timed_replays(prog, 4, "augment")
    spans = [r for r in profiling.report()["device_spans"] if r["graph"] == "augment"]
    assert prog.spans.describe()["markers"] == 2 and len(spans) == 4
    for r, ms in zip(spans, events_ms):
        assert r["spans"]["augment"] == pytest.approx(ms, rel=0.05)


def _sync_warnings(run) -> int:
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


@pytest.mark.gpu
def test_tracing_adds_no_synchronize_on_card():
    """``plan_begin`` alone and a train step warn as often under
    ``set_sync_debug_mode("warn")`` with tracing on as with it off."""
    _need_card()
    planner = DiffusionPlanner(plan_cfg(), seed=0, device="cuda")
    frame, target = frames(1)[0], np.array([0.2, 0.1], np.float32)
    planner.plan(frame, target)
    cfg = train_cfg()
    state = create_train_state(build_model(cfg, device="cuda", seed=0), cfg)
    program = TrainProgram(make_train_step(make_schedule("squaredcos_cap_v2", 10, device="cuda"), cfg), "cuda")
    batch = batch_of("cuda")
    its = iter(range(100))
    step = lambda: program(state, batch, generator=iteration_generators(next(its), "cuda")[1])
    step()
    step()
    counts = {}
    for on in (False, True, False):
        profiling.enable(on)
        counts.setdefault(on, []).append((_sync_warnings(lambda: planner.plan_begin(frame, target)),
                                          _sync_warnings(step)))
    assert counts[True][0] == counts[False][0] == counts[False][1]
    assert profiling.report()["device_spans"]  # the traced replays were recorded


@pytest.mark.gpu
def test_a_recapture_is_counted_on_card():
    _need_card()
    cfg = plan_cfg()
    planner = DiffusionPlanner(cfg, seed=0, device="cuda")
    frame = frames(1)[0]
    planner.plan(frame)
    planner.plan(frame)
    first = profiling.report()["counters"]
    assert first["captures.plan"]["count"] == 1 and first["captures.plan"]["seconds"] > 0
    assert first["weights_generations.plan"]["count"] == 1
    planner.model.load_state_dict(build_model(cfg, device="cpu", seed=1).state_dict())
    planner.plan(frame)
    counters = profiling.report()["counters"]
    assert counters["captures.plan"]["count"] == 2 and counters["weights_generations.plan"]["count"] == 2


@pytest.mark.gpu
def test_span_ranges_add_nothing_to_the_benchmarks_busy_time_on_card(monkeypatch):
    """In a stretch profiled as ``perfbench/trace.py:profile`` profiles it,
    the spans' ``record_function`` ranges show on the device as user
    annotations; the benchmark drops those, so its device events are the
    kernels, copies and fills alone, while its host events name the gaps
    after the spans."""
    _need_card()
    import torch.profiler as tp

    from perfbench import trace

    planner = DiffusionPlanner(plan_cfg(), seed=0, device="cuda")
    frame = frames(1)[0]
    planner.plan(frame)
    seen, real = {}, tp.profile

    class Kept(real):
        def __enter__(self):
            seen["prof"] = self
            return super().__enter__()

    reduced, real_reduce = {}, trace.reduce_events

    def keep(events, *a, **k):
        reduced["events"] = events
        return real_reduce(events, *a, **k)

    monkeypatch.setattr(tp, "profile", Kept)
    monkeypatch.setattr(trace, "reduce_events", keep)

    def run():
        for _ in range(3):
            planner.plan(frame)
        return 3

    out = trace.profile(run, torch.device("cuda"))
    names = {"plan", "plan.replay", "plan.inputs", "plan.outputs", "plan.weights_key"}
    raw = [ev for ev in seen["prof"].events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    assert any(getattr(ev, "is_user_annotation", False) and ev.name in names for ev in raw)
    device = [e for e in reduced["events"] if e.device]
    assert device and not any(e.name in names for e in device)
    assert {e.name for e in reduced["events"] if not e.device} >= {"plan", "plan.replay"}
    annotations = [trace.Event(True, ev.name, float(ev.time_range.start), float(ev.time_range.end))
                   for ev in raw if getattr(ev, "is_user_annotation", False)]
    assert real_reduce(reduced["events"] + annotations)["busy_s"] >= out["busy_s"] > 0
