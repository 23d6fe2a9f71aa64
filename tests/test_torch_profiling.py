"""The port's tracing module (``utils/profiling.py``) on the CPU: off, a span
is one shared no-op; on (a profiler session or ``enable()``) spans nest by
parent and request, sit in the profiler's events and in ``trace``'s Chrome
trace, and fill a bounded ring; counters count; ``report`` and ``reset``
give and clear plain data. Device spans need a card
(``tests/test_torch_tracing.py``)."""

import json
import tracemalloc

import pytest
import torch

from autonomous_driving_with_diffusion_model_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def clean():
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(False)
    profiling.reset()


def test_off_records_nothing_and_allocates_nothing_per_span(monkeypatch):
    assert not profiling.on()
    a, b = profiling.span("a"), profiling.span("b", request=3, key="k")
    assert a is b and not a  # one shared no-op, read as false
    with a as sp:
        sp.set(x=1)

    def made(*args):
        raise AssertionError("a span object was made with tracing off")

    monkeypatch.setattr(profiling, "_Span", made)
    mine = [tracemalloc.Filter(True, profiling.__file__)]
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot().filter_traces(mine)
        for _ in range(1000):
            with profiling.span("plan.inputs"):
                pass
        after = tracemalloc.take_snapshot().filter_traces(mine)
    finally:
        tracemalloc.stop()
    assert sum(stat.size_diff for stat in after.compare_to(before, "lineno")) <= 0
    assert profiling.report() == {"spans": [], "device_spans": [], "graphs": [], "counters": {}}


def test_a_profiler_session_turns_tracing_on_and_holds_the_spans():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert profiling.on()
        with profiling.span("adm.outer", request=7):
            with profiling.span("adm.inner"):
                torch.ones(4) @ torch.ones(4)
    assert not profiling.on()
    names = {ev.name for ev in prof.events()}
    assert {"adm.outer", "adm.inner"} <= names
    assert [s["name"] for s in profiling.report()["spans"]] == ["adm.inner", "adm.outer"]


def test_span_names_a_span_in_the_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("adm_span_under_test"):
            torch.ones(4) @ torch.ones(4)
    with open(tmp_path / "trace.json") as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert "adm_span_under_test" in names


def test_parents_and_requests_nest():
    profiling.enable()
    with profiling.span("plan", request=4) as root:
        with profiling.span("plan.inputs"):
            assert profiling.current_request() == 4
        with profiling.span("plan.replay", tag="x") as rep:
            with profiling.span("plan.deeper", request=9):
                pass
        root.set(key="k")
    with profiling.span("plan.fetch"):
        assert profiling.current_request() is None
    spans = {s["name"]: s for s in profiling.report()["spans"]}
    assert spans["plan"]["parent"] is None and spans["plan"]["attrs"] == {"key": "k"}
    for child in ("plan.inputs", "plan.replay"):
        assert spans[child]["parent"] == root.id and spans[child]["request"] == 4
    assert spans["plan.deeper"]["parent"] == rep.id and spans["plan.deeper"]["request"] == 9
    assert spans["plan.replay"]["attrs"] == {"tag": "x"}
    assert spans["plan.fetch"]["parent"] is None and spans["plan.fetch"]["request"] is None
    for s in spans.values():
        assert 0 < s["start_ns"] <= s["end_ns"]
    assert spans["plan"]["start_ns"] <= spans["plan.inputs"]["start_ns"] <= spans["plan.replay"]["end_ns"] \
        <= spans["plan"]["end_ns"]


def test_the_ring_stays_bounded():
    profiling.enable()
    for i in range(profiling.RING_SPANS + 10):
        with profiling.span("s", request=i):
            pass
    spans = profiling.report()["spans"]
    assert len(spans) == profiling.RING_SPANS
    assert spans[0]["request"] == 10 and spans[-1]["request"] == profiling.RING_SPANS + 9


def test_counters_count_on_and_off_and_reset_clears():
    profiling.count("captures.plan", 1, 1.5)
    profiling.count("captures.plan", 2, 0.25)
    profiling.count("weights_generations.plan")
    got = profiling.reset()["counters"]
    assert got == {"captures.plan": {"count": 3, "seconds": 1.75},
                   "weights_generations.plan": {"count": 1, "seconds": 0.0}}
    assert profiling.report()["counters"] == {}


def test_enable_turns_tracing_on_without_a_profiler():
    profiling.enable()
    assert profiling.on()
    with profiling.span("adm.enabled") as sp:
        assert sp
    profiling.enable(False)
    with profiling.span("adm.disabled"):
        pass
    assert [s["name"] for s in profiling.report()["spans"]] == ["adm.enabled"]


def test_markers_outside_a_capture_do_nothing():
    """The bodies mark their device spans in eager runs and on the CPU too:
    there the markers are no-ops."""
    profiling.mark("plan.encode", steps=3)
    profiling.mark_end()
    with profiling.capture(None):
        profiling.mark("plan.denoise")
        profiling.mark_end()
    assert profiling.report()["graphs"] == []
