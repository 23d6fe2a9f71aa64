"""The control comes out not correct, on the card at the cell's own size.

The control is the plain reference computed in TF32 (the precision below
the configurations' float32 with TF32 off) in the program's place; for the
training cell also the reference with its loss taken over half of each
batch. One seed a cell; ``perfbench/calibrate.py`` reads a dozen and more
(``PERF.md`` gives the readings the limits were set from). On a machine
without a card the tests skip.
"""

from __future__ import annotations

import pytest

import perfbench_helpers  # noqa: F401
from perfbench import calibrate, check, core

SEED = 2**31 + 4242


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["default-plan", "free_guidance-plan", "free_guidance-plan-k8"])
def test_plan_control_fails_and_program_passes(workload):
    _card()
    cell = core.load_cell(workload)
    r = calibrate.plan_readings(cell, [SEED], 1, 1.0, "cuda:0")
    assert all(row["ok"] for row in check.judge(r["sound"][0], cell.limits)), r
    assert not all(row["ok"] for row in check.judge(r["control"][0], cell.limits)), r


@pytest.mark.gpu
def test_train_control_and_half_batch_fail_and_program_passes():
    _card()
    cell = core.load_cell("default-train")
    r = calibrate.train_readings(cell, [SEED], 1, 1.0, "cuda:0")
    assert all(row["ok"] for row in check.judge(r["sound"][0], cell.limits)), r
    for fault in ("control", "half_batch"):
        assert not all(row["ok"] for row in check.judge(r[fault][0], cell.limits)), (fault, r)
