"""Work counted from shapes, against counts made by hand."""

from __future__ import annotations

import pytest

import perfbench_helpers  # noqa: F401
from perfbench import core, work

MODEL = {"HORIZON": 16, "TRANSITION_DIM": 7, "DIM": 64, "DIM_MULTS": [1, 2, 4, 8], "USE_ATTN": False,
         "PERCEPTION": "resnet34"}


def test_residual_block_count_by_hand():
    """The U-Net's first residual block at batch 1: x (1, 16, 7) -> 64
    channels, conditioning width 128, a 1x1 residual projection."""
    calls = work.residual_block_work(MODEL, 1)
    assert len(calls) == 16
    B, L, cin, C, E = 1, 16, 7, 64, 128
    conv1 = L * 5 * cin * C  # multiply-adds
    conv2 = L * 5 * C * C
    cond = E * C
    res = L * cin * C
    ops = 2 * B * (conv1 + conv2 + cond + res)
    assert ops == 757_760
    weights = 5 * cin * C + C + C + C + E * C + C + 5 * C * C + C + C + C + cin * C + C
    nbytes = 4 * (B * L * cin + B * E + weights + B * L * C)
    assert calls[0] == (ops, nbytes)


def test_encoder_first_convolution_by_hand():
    counts = work.forward_flops(MODEL, False, (256, 900), 1)
    # 7x7 stride 2 pad 3: 256x900 -> 128x450, 64 channels out of 3
    assert counts["first_conv"] == 2 * 64 * 128 * 450 * 3 * 7 * 7
    assert 33e9 < counts["encoder"] < 35e9  # ResNet-34 at 900x256, multiply-adds x 2


def test_plan_work_of_the_cells():
    rates = work.card_rates("NVIDIA H100 80GB HBM3")
    default = work.plan_work(core.plain(core.build_cfg(core.load_cell("default-plan").config)), rates)
    k8 = work.plan_work(core.plain(core.build_cfg(core.load_cell("free_guidance-plan-k8").config)), rates)
    assert default["forwards"] == 100 and k8["forwards"] == 10
    # one forward's 16 residual blocks at batch 1 are bound by their bytes: 0.0184 ms
    assert default["residual_bound_s"] / 100 == pytest.approx(1.8395e-5, rel=1e-3)
    assert k8["flops"] > default["flops"] - 100 * work.forward_flops(MODEL, False, (256, 900), 1)["unet"]


def test_card_rates_by_name():
    assert work.card_rates("NVIDIA H100 80GB HBM3")["fp32_flops"] == 67e12
    assert work.card_rates("NVIDIA H100 PCIe")["bytes_s"] == 2.0e12
    assert work.card_rates("NVIDIA H100 NVL")["bf16_flops"] == 835e12


def test_train_step_flops():
    cfg = core.plain(core.build_cfg(core.load_cell("default-train").config))
    f = work.forward_flops(cfg["MODEL"], False, (256, 900), 32)
    assert work.train_step_flops(cfg) == 3 * (f["encoder"] + f["unet"]) - f["first_conv"]
