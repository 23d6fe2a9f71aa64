"""The port's ``utils/profiling.py`` against the JAX package's: ``device_timer``
calls the function as often, returns the same structure, and chains the
same way (on CPU tensors, which are ready when the call returns); ``annotate``
names a span in ``trace``'s Chrome trace."""

import json

import numpy as np
import pytest
import torch

from autonomous_driving_with_diffusion_model_tpu.utils import profiling as jax_profiling
from autonomous_driving_with_diffusion_model_tpu_torch.utils import profiling


def _counted(make):
    calls = []

    def fn(x, scale=1.0):
        calls.append(float(np.asarray(x).sum()))
        return make(x) * scale

    return fn, calls


@pytest.mark.parametrize("iters,warmup", [(5, 2), (1, 0), (7, 3)])
def test_per_call_timing_matches_jax_counts(iters, warmup):
    fn, calls = _counted(lambda x: x + 1)
    mean, samples = profiling.device_timer(fn, torch.ones(3), iters=iters, warmup=warmup, scale=2.0)
    jfn, jcalls = _counted(lambda x: x + 1)
    jmean, jsamples = jax_profiling.device_timer(jfn, np.ones(3, np.float32), iters=iters, warmup=warmup, scale=2.0)
    assert len(calls) == len(jcalls) == 1 + warmup + iters
    assert isinstance(samples, list) and len(samples) == len(jsamples) == iters
    assert all(s >= 0 for s in samples) and mean == pytest.approx(sum(samples) / iters)


def test_chained_timing_feeds_each_output_to_the_next_call():
    """With ``chain``, call i + 1 takes what chain made of call i's output:
    the same sequence of inputs in both packages, one total returned."""
    chain = lambda out, args: (out,)
    fn, calls = _counted(lambda x: x * 2)
    mean, total = profiling.device_timer(fn, torch.ones(2), iters=4, warmup=1, chain=chain)
    jfn, jcalls = _counted(lambda x: x * 2)
    jax_profiling.device_timer(jfn, np.ones(2, np.float32), iters=4, warmup=1, chain=chain)
    # 2 warm calls on the initial input, then 4 chained: 2, 4, 8, 16 per element
    assert calls == jcalls == [2.0, 2.0, 4.0, 8.0, 16.0, 32.0]
    assert isinstance(total, float) and mean == pytest.approx(total / 4)


def test_outputs_of_any_structure_are_synchronized():
    """Dicts, tuples and non-tensors pass through (nothing to wait for on the CPU)."""
    mean, samples = profiling.device_timer(lambda: {"a": (torch.zeros(1), [torch.ones(1)]), "b": 3}, iters=2,
                                           warmup=0)
    assert len(samples) == 2


def test_annotate_names_a_span_in_the_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("adm_span_under_test"):
            torch.ones(4) @ torch.ones(4)
    with open(tmp_path / "trace.json") as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert "adm_span_under_test" in names
