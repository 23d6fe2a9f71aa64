"""The ``rdt_1b-plan`` cell's pieces on the CPU: the work count at the
published sizes against a hand count of one RDT block and one SigLIP layer,
the weights' kinds, the cell's files found by name, the two roofline
readers with nothing to read, and whole runs of the cell at a small size,
sound and with a fault planted in what the program is held to."""

from __future__ import annotations

import importlib.util
import time
from types import SimpleNamespace

import pytest
import torch

import perfbench_helpers  # noqa: F401
from perfbench import core, work, work_rdt
from perfbench import run as run_module
from perfbench.reference import rdt as ref_rdt
from perfbench.weights_rdt import kind, make_state_dict

CELL = "rdt_1b-plan"
# hidden 64, depth 4, 4 heads, a 2-layer 32-wide tower on 56x56 images, chunk 8, state 16, float32
SMALL = {"MODEL.HORIZON": 8, "MODEL.RDT.HIDDEN": 64, "MODEL.RDT.DEPTH": 4, "MODEL.RDT.HEADS": 4,
         "MODEL.RDT.STATE_DIM": 16, "MODEL.RDT.LANG_DIM": 48, "MODEL.RDT.MAX_LANG_LEN": 40,
         "MODEL.RDT.ACTION_SLOTS": (0, 1, 2, 3, 4, 5, 6), "MODEL.RDT.TARGET_SLOTS": (8, 9),
         "MODEL.RDT.VISION_WIDTH": 32, "MODEL.RDT.VISION_DEPTH": 2, "MODEL.RDT.VISION_HEADS": 2,
         "MODEL.RDT.VISION_MLP": 60, "MODEL.RDT.IMAGE_SIZE": 56, "TRAIN.IMAGE_HEIGHT": 32, "TRAIN.IMAGE_WIDTH": 64,
         "TPU.COMPUTE_DTYPE": "float32"}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _published():
    return core.plain(core.build_cfg(core.load_cell(CELL).config))


def test_work_counts_one_block_and_one_layer_by_hand():
    """One RDT block at 67 tokens reading 4,374 image keys, one SigLIP layer
    over 6 images of 729 tokens, and the plan's totals, at the published
    sizes."""
    d = _published()
    r = d["MODEL"]["RDT"]
    n, L, D = 67, 4374, 2048
    block = work_rdt.rdt_block(r, n, L)
    flops = 2 * n * D * 3 * D + 2 * 2 * 32 * n * n * 64 + 2 * n * D * D + 2 * n * D * D + 2 * 2 * 32 * n * L * 64 \
        + 2 * n * D * D + 2 * 2 * n * D * D
    assert sum(f for _, f, _ in block) == flops
    weights = (D * 3 * D + 3 * D) + (D * D + D) * 5  # qkv, proj, cross q and proj, fc1, fc2
    assert sum(b for _, _, b in block) >= 2 * weights  # bfloat16 weights read once, activations beside
    layer = work_rdt.siglip_layer(r, 6)
    m, w = 6 * 729, 1152
    assert sum(f for _, f, _ in layer) == 2 * m * w * w * 4 + 2 * m * w * 4304 * 2 + 2 * 2 * 6 * 16 * 729 * 729 * 72
    w_out = work_rdt.plan_work(d, work.card_rates("NVIDIA H100 80GB HBM3"))
    kv = 14 * 2 * (32 + L) * D * 2 * D  # each condition's keys and values, once a plan
    assert w_out["dit_flops"] > 5 * 28 * 0.9 * flops / 2 + kv
    assert 4.0e12 < w_out["vision_flops"] < 4.1e12 and 1.8e12 < w_out["dit_flops"] < 1.9e12
    assert w_out["flops"] == w_out["vision_flops"] + w_out["dit_flops"] and w_out["forwards"] == 5
    # the 5 forwards' block weights (1.9 GB each in bfloat16, the keys' and values' left out) and the
    # 4,374 image keys' and values' reads bound the denoising by bytes
    assert 5 * 28 * 2 * weights < w_out["dit_bytes"] < 16e9
    assert 4e-3 < w_out["vision_bound_s"] < 5e-3 and 5e-3 < w_out["dit_bound_s"] < 6e-3


def test_weights_are_bfloat16_values_of_their_kinds():
    d = core.plain(core.build_cfg(core.load_cell(CELL).config, SMALL))
    template = ref_rdt.build_reference(d["MODEL"], "meta").state_dict()
    sd = make_state_dict(template, 2**31 + 3, "cpu")
    assert set(sd) == set(template)
    for name, v in sd.items():
        assert torch.equal(v, v.to(torch.bfloat16).to(torch.float32)), name
    assert kind("model.blocks.0.attn.q_norm.weight", (16,)) == "gamma"
    assert kind("vision.encoder.layers.1.layer_norm2.bias", (32,)) == "beta"
    assert kind("model.img_cond_pos_embed", (1, 96, 64)) == "table"
    assert kind("vision.embeddings.position_embedding.weight", (16, 32)) == "table"
    assert kind("model.blocks.0.cross_attn.kv.bias", (128,)) == "fan_in"
    w = sd["model.blocks.0.cross_attn.kv.weight"]
    assert w.abs().max() <= 1 / 8 and w.std() > 0.03  # +-1/sqrt(64)


def test_cell_files_are_found_by_name():
    cell = core.load_cell(CELL)
    assert cell.traffic["kind"] == "closed_loop_plan_rdt" and cell.config["reduced"] == ["num_cameras"]
    assert cell.config["published"]["rdt.depth"] == 28 and cell.config["cfg"]["MODEL"]["RDT"]["VISION_DEPTH"] == 27
    drv = cell.driver()
    assert {"setup", "window", "sample", "reference", "run"} <= set(dir(drv))
    tokens, mask = drv.instruction(2**31 + 9, 32, 4096, cell.traffic["instruction_min"],
                                   cell.traffic["instruction_max"])
    assert tokens.shape == (32, 4096) and 8 <= mask.sum() <= 32 and mask[0]
    names = {m["name"] for m in core.metric_names(cell, trace=True)}
    assert {"dit_roofline.plan", "vision_roofline.plan", "mfu.plan", "step_kernels.plan"} <= names
    assert not names & {"residual_block_roofline.plan", "weight_stream_share.plan"}


@pytest.mark.parametrize("name", ["dit_roofline.plan", "vision_roofline.plan"])
def test_readers_find_nothing_without_spans(name, monkeypatch):
    spec = importlib.util.spec_from_file_location(name, core.PB / "metrics" / f"{name}.py")
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    work_counts = {"dit_bound_s": 5e-3, "vision_bound_s": 4e-3}
    assert reader.read(SimpleNamespace(kind="train", work=work_counts)) is None
    assert reader.read(SimpleNamespace(kind="plan", work=None)) is None
    from autonomous_driving_with_diffusion_model_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "report", lambda: {"device_spans": [], "spans": [], "graphs": [],
                                                      "counters": {}})
    assert reader.read(SimpleNamespace(kind="plan", work=work_counts)) is None
    span = "plan.denoise" if name.startswith("dit") else "plan.encode"
    monkeypatch.setattr(profiling, "report", lambda: {"device_spans": [
        {"graph": "plan", "spans": {span: 10.0}}, {"graph": "plan", "spans": {span: 20.0}},
        {"graph": "train", "spans": {span: 1.0}}]})
    bound = work_counts["dit_bound_s" if name.startswith("dit") else "vision_bound_s"]
    want = (100 * bound / 10e-3 + 100 * bound / 20e-3) / 2  # the median of the plan graph's two replays
    assert reader.read(SimpleNamespace(kind="plan", work=work_counts)) == pytest.approx(want)


def _run(overrides=None, variant=None, monkeypatch=None):
    cell = core.load_cell(CELL)
    cell.traffic.update(frames=8, check_plans=6, check_block=4)
    if variant is not None:  # the program computes what the reference computes with the fault planted
        drv = cell.driver()
        ref = drv.reference
        monkeypatch.setattr(drv, "reference", lambda run, state, requests: ref(run, state, requests, variant=variant))
        monkeypatch.setattr(cell, "driver", lambda: drv)
    return run_module.execute(cell, 2**31 + 77, 0.3, False, "cpu", time.perf_counter(), {**SMALL, **(overrides or {})})


def test_a_small_run_is_correct():
    out = _run()
    assert out["result"]["correct"], out["out"]["numbers"]
    assert out["out"]["numbers"]["plan_gap"] < 1e-5 and out["result"]["attempted"] >= 2
    assert {"plan_p50_ms", "plan_p95_ms", "setup_s"} <= set(out["result"]["metrics"])


@pytest.mark.parametrize("variant", ["mask_ignored", "alternation_swapped", "t_off_by_one"])
def test_a_planted_fault_reads_far_beyond_a_sound_run(variant, monkeypatch):
    """The whole run with the reference's fault planted: its gap stands
    thousands of times above the float32 run's (the cell's limit is set
    at the published sizes, in bfloat16, from these faults' readings)."""
    out = _run(variant=variant, monkeypatch=monkeypatch)
    assert out["out"]["numbers"]["plan_gap"] > 1e3 * 1e-5, out["out"]["numbers"]


def test_the_mask_sweep_reads_the_fault_only_where_the_mask_hides_padding():
    """``calibrate_rdt``'s sweep at a small size: ignoring the instruction's
    mask moves the plans when the mask hides padding, and changes nothing
    when every slot is valid."""
    from perfbench import calibrate_rdt

    got = calibrate_rdt.readings([2**31 + 77], 0.3, "cpu", SMALL, dict(frames=8, check_plans=6, check_block=4),
                                 lengths=(8, 32))
    by_length = {r["valid"]: r for r in got["mask_by_length"]}
    assert by_length[32]["plan_gap"] == 0.0 and by_length[32]["plan_rms_gap"] == 0.0
    assert by_length[8]["plan_gap"] > 1e3 * 1e-5, by_length[8]
    assert len(got["sound"]) == 1 and all(len(got[v]) == 1 for v in calibrate_rdt.VARIANTS)
