"""The readers of the program's spans and counters
(``perfbench/metrics/*``, source ``program_span`` or ``program_counter``)
on a synthetic ``profiling.report()``: each gives the median over the
traced plans or steps, and None where the report holds nothing for it,
where the cell is of the other kind, or where the program has no
``report`` (a program without spans)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

import perfbench_helpers  # noqa: F401
from perfbench import core

from autonomous_driving_with_diffusion_model_tpu_torch.utils import profiling


def _reader(name):
    return core._load_module(core.PB / "metrics" / f"{name}.py", "perfbench_metric_test_" + name.replace(".", "_"))


def _replay(graph, gid, request, spans):
    return {"graph": graph, "graph_id": gid, "replay": request, "request": request, "spans": spans,
            "replay_ms": sum(spans.values())}


PLAN = [{"plan.encode": 2.0, "plan.denoise": d, "plan.score": 0.5} for d in (8.0, 9.0, 30.0)]
STEP = [{"step.forward": f, "step.backward": 2 * f, "step.optimizer": 5.0} for f in (40.0, 41.0, 39.0)]
REPORT = {
    "spans": [{"id": i, "parent": None, "request": i, "name": "plan.weights_key", "start_ns": 1000 * i,
               "end_ns": 1000 * i + ns, "thread": 1, "attrs": {}} for i, ns in enumerate((2_000_000, 1_000_000,
                                                                                          1_500_000))]
    + [{"id": 9, "parent": None, "request": 0, "name": "plan.inputs", "start_ns": 0, "end_ns": 10**9,
        "thread": 1, "attrs": {}}],
    "device_spans": [_replay("plan", 1, i, s) for i, s in enumerate(PLAN)]
    + [_replay("plan", 2, 3, {"plan.encode": 2.0, "plan.denoise": 12.0, "plan.score": 0.5})]
    + [_replay("step", 3, i, s) for i, s in enumerate(STEP)]
    + [_replay("augment", 4, i, {"augment": a}) for i, a in enumerate((15.0, 16.0, 14.0, 18.0))],
    "graphs": [{"id": 1, "name": "plan", "markers": 4, "spans": ["plan.encode", "plan.denoise", "plan.score"],
                "kernels": {"plan.encode": 80, "plan.denoise": 9000, "plan.score": 5}, "kernel_nodes": 9085,
                "attrs": {"steps": 100}},
               {"id": 2, "name": "plan", "markers": 4, "spans": ["plan.encode", "plan.denoise", "plan.score"],
                "kernels": {"plan.encode": 80, "plan.denoise": 8800, "plan.score": 5}, "kernel_nodes": 8885,
                "attrs": {"steps": 100}}],
    "counters": {"captures.plan": {"count": 2, "seconds": 3.0}},
}
EMPTY = {"spans": [], "device_spans": [], "graphs": [], "counters": {}}

# reader -> (cell kind, its median on REPORT)
WANT = {
    "replay_ms.plan": ("plan", 13.0),  # 10.5, 11.5, 14.5 and 32.5
    "encoder_ms.plan": ("plan", 2.0),
    "denoise_ms.plan": ("plan", 10.5),  # 8, 9, 12 and 30
    "weights_key_ms.plan": ("plan", 1.5),
    "step_kernels.plan": ("plan", 90.0),  # 90, 90, 90 and 88 kernels a step
    "forward_ms.train": ("train", 40.0),
    "backward_ms.train": ("train", 80.0),
    "optimizer_ms.train": ("train", 5.0),
    "augment_device_ms.train": ("train", 15.5),
}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_gives_the_median(monkeypatch, name):
    kind, want = WANT[name]
    monkeypatch.setattr(profiling, "report", lambda: REPORT)
    assert _reader(name).read(SimpleNamespace(kind=kind)) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_finds_nothing_to_read(monkeypatch, name):
    kind, _ = WANT[name]
    other = "train" if kind == "plan" else "plan"
    monkeypatch.setattr(profiling, "report", lambda: REPORT)
    assert _reader(name).read(SimpleNamespace(kind=other)) is None
    monkeypatch.setattr(profiling, "report", lambda: EMPTY)
    assert _reader(name).read(SimpleNamespace(kind=kind)) is None
    monkeypatch.delattr(profiling, "report")
    assert _reader(name).read(SimpleNamespace(kind=kind)) is None


def test_the_manifest_lists_each_reader_where_it_reads():
    per_layer = {m["name"]: m for m in core.json.loads((core.ROOT / "BENCHMARK.json").read_text())["per_layer"]}
    for name, (kind, _) in WANT.items():
        m = per_layer[name]
        assert m["source"] in ("program_span", "program_counter")
        if kind == "plan":
            assert m["workloads"] == ["default-plan", "free_guidance-plan", "free_guidance-plan-k8"]
            assert m["moves"] == "plan_p50_ms"
        else:
            assert m["workloads"] == ["default-train"] and m["moves"] == "train_samples_per_s"
