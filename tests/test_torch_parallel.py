"""Data-parallel training (``parallel/``) on the CPU: two real processes over
gloo against the port's one-process step on the global batch.

Two ranks at B rows each, on their rows of the global batch and draws
(``parallel/ddp.py:local_rows``), must compute what one process computes
on the 2B rows (the one-process step is held against JAX's by
``tests/test_torch_train.py``): BatchNorm frozen and in train mode (the
statistics of the global batch, through the differentiable all-reduce in
``models/resnet.py:_bn``), REMAT, gradient accumulation (global
micro-batch i is each rank's micro-batch i), and the three ``USE_COND``
variants (none leaves a parameter without a gradient, so DDP's reducer needs
no search). Then the train CLI under torchrun on two ranks writes one
``.pth``, from rank 0, equal to one process's on the same global batches.

Tolerances, as ``tests/test_torch_train.py``: the global loss to 2e-5
relative; the first step's averaged gradients to 1e-4 of each tensor's
largest plus 1e-7 (another summation order: the ranks' halves, then their
average); after three steps every element of the parameters and EMA within
Adam's bound (two LRs per update) and each tensor's update over its
elements whose first gradient is not near 0 (below 1e-6 or 1e-3 of the
tensor's largest) to 1e-3 of the update's norm; the first step's BatchNorm
statistics to 1e-4 relative to 1 + |value|. The two ranks hold the same
numbers exactly. Each subprocess has its own timeout (120 s).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from autonomous_driving_with_diffusion_model_tpu_torch.parallel import local_rows
from autonomous_driving_with_diffusion_model_tpu_torch.parallel.check import case_config, run_case

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
STEPS = 3
LR = 1e-3
TIMEOUT_S = 120
COMMON = ["MODEL.DIM", "8", "MODEL.DIM_MULTS", "[1, 2]", "MODEL.PERCEPTION", "tiny", "TRAIN.TIME_STEPS", "10",
          "TRAIN.SAMPLE_STEPS", "10", "TRAIN.LR", str(LR), "TRAIN.LR_WARMUP", "1", "TRAIN.IMAGE_HEIGHT", "32",
          "TRAIN.IMAGE_WIDTH", "48"]
CASES = [
    {"name": "frozen", "batch": 2, "opts": []},
    {"name": "bn_train", "batch": 2, "opts": ["MODEL.PERCEPTION", "resnet18", "TPU.BN_MODE", "train"]},
    {"name": "remat", "batch": 2, "opts": ["TPU.REMAT", "True"]},
    {"name": "accumulate", "batch": 4, "opts": ["MODEL.PERCEPTION", "resnet18", "TPU.BN_MODE", "train",
                                                 "TRAIN.USE_COND", "FREE_GUIDANCE",
                                                 "TRAIN.GRADIENT_ACCUMULATION_STEPS", "2"]},
    {"name": "free_guidance", "batch": 2, "opts": ["TRAIN.USE_COND", "FREE_GUIDANCE"]},
    {"name": "classifier_guidance", "batch": 2, "opts": ["TRAIN.USE_COND", "CLASSIFIER_GUIDANCE", "MODEL.DIM", "64"]},
]
for c in CASES:
    c["opts"] = COMMON + c["opts"]
    c["steps"] = STEPS


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    return env


def _wait(procs):
    """Every process's (returncode, stderr); kill the rest past the timeout."""
    out = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT_S)
            out.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results for every case, from one pair of processes."""
    tmp = tmp_path_factory.mktemp("ddp")
    cases = tmp / "cases.json"
    cases.write_text(json.dumps(CASES))
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "autonomous_driving_with_diffusion_model_tpu_torch.parallel.check",
         "--rank", str(r), "--world", str(WORLD), "--port", str(port), "--device", "cpu",
         "--cases", str(cases), "--out", str(tmp)],
        cwd=REPO, env=_env(), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    for rc, err in _wait(procs):
        assert rc == 0, err[-3000:]
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_two_ranks_match_one_process(ranks, case):
    """Both ranks identical; rank 0 against one process on the global batch."""
    r0, r1 = (r[case["name"]] for r in ranks)
    assert r0["losses"] == r1["losses"]
    for kind in ("grads", "params", "ema", "stats_first"):
        assert r0[kind].keys() == r1[kind].keys()
        for name in r0[kind]:
            assert torch.equal(r0[kind][name], r1[kind][name]), (kind, name)
    cfg = case_config(case["opts"])
    want = run_case(cfg, "cpu", case["batch"] * WORLD, STEPS)
    start = run_case(cfg, "cpu", case["batch"] * WORLD, 0)["params"]
    np.testing.assert_allclose(r0["losses"], want["losses"], rtol=2e-5)
    for name, g in r0["grads"].items():
        w = want["grads"][name]
        assert (g - w).abs().max() <= 1e-4 * w.abs().max() + 1e-7, name
    lr_sum = LR * (STEPS - 1)  # the first update's LR is 0
    for kind in ("params", "ema"):
        for name, p in r0[kind].items():
            w, g0 = want[kind][name], want["grads"][name].abs()
            assert ((p - w).abs() <= 2 * lr_sum).all(), (kind, name)
            keep = g0 >= max(1e-6, 1e-3 * float(g0.max()))
            if keep.any():
                moved, ref = (p - start[name])[keep], (w - start[name])[keep]
                assert (moved - ref).norm() <= 1e-3 * ref.norm() + 1e-6, (kind, name)
    for name, w in want["stats_first"].items():
        assert ((r0["stats_first"][name] - w).abs() / (w.abs() + 1.0)).max() <= 1e-4, name
    if "BN_MODE" in " ".join(case["opts"]):
        assert want["stats_first"], "a BatchNorm-train case moves statistics"


@pytest.mark.parametrize("world,groups", [(1, 1), (2, 1), (2, 2), (4, 3)])
def test_local_rows_partition_the_global_batch(world, groups):
    """The ranks' rows cover the global batch once; global micro-batch i is
    every rank's local micro-batch i, rank by rank."""
    B = 6
    rows = [local_rows(B, r, world, groups) for r in range(world)]
    assert sorted(torch.cat(rows).tolist()) == list(range(B * world))
    mb = B // groups
    for i in range(groups):
        micro = torch.cat([r[i * mb:(i + 1) * mb] for r in rows])
        assert micro.tolist() == list(range(i * world * mb, (i + 1) * world * mb))
    with pytest.raises(ValueError, match="micro-batches"):
        local_rows(5, 0, world, 2)


def test_data_parallel_size_and_one_process_defaults():
    from autonomous_driving_with_diffusion_model_tpu_torch.parallel import (
        data_parallel_size,
        initialize_distributed,
        is_main_process,
        local_batch_slice,
        process_count,
        process_index,
    )

    cfg = case_config([])
    assert data_parallel_size(cfg) == 1  # -1: every rank up, here one process
    cfg.TPU.DATA_PARALLEL = 1
    assert data_parallel_size(cfg) == 1
    cfg.TPU.DATA_PARALLEL = 4
    with pytest.raises(ValueError, match="DATA_PARALLEL"):
        data_parallel_size(cfg)
    saved = {k: os.environ.pop(k) for k in ("WORLD_SIZE", "RANK") if k in os.environ}
    try:
        assert initialize_distributed(device="cpu") is False  # no torchrun variables: one process
    finally:
        os.environ.update(saved)
    assert not torch.distributed.is_initialized()
    assert (process_index(), process_count(), is_main_process()) == (0, 1, True)
    assert local_batch_slice(8) == slice(0, 8)


def test_train_cli_on_two_ranks(tmp_path):
    """torchrun --nproc_per_node 2 runs the train CLI on the CPU (gloo): two
    iterations at TRAIN.BATCH_SIZE 2 each, each rank on its shard. Rank 0
    alone writes final.pth, the log and the tracker; the .pth equals one
    process's run on the same global batches (the shards' batches, rank by
    rank) and the same per-iteration draws."""
    from test_torch_train_cli import opts, write_dataset

    from autonomous_driving_with_diffusion_model_tpu_torch.data import Loader, TrajDataset, normalize_images
    from autonomous_driving_with_diffusion_model_tpu_torch.diffusion import make_schedule_from_cfg
    from autonomous_driving_with_diffusion_model_tpu_torch.models import build_model
    from autonomous_driving_with_diffusion_model_tpu_torch.train import cli, create_train_state, make_train_step

    write_dataset(str(tmp_path / "data"), n=8)
    run_opts = opts(tmp_path, "run", perception="resnet34", **{"TRAIN.USE_IMG_AUGMENTOR": "False",
                                                               "TRAIN.LR": str(LR)})
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(WORLD),
           "-m", "autonomous_driving_with_diffusion_model_tpu_torch.train", "--device", "cpu", "--max-iter", "2",
           "--opts", *run_opts]
    proc = subprocess.run(cmd, cwd=REPO, env=_env(), capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ck = tmp_path / "run" / "checkpoints"
    assert sorted(os.listdir(ck)) == ["final.pth"]
    log = (tmp_path / "run" / "train.log").read_text()
    assert log.count("iter: [2/2]") == 1 and "Data-parallel: 2 rank(s)" in log
    assert (tmp_path / "run" / "metrics.jsonl").read_text().count("run_start") == 1

    cfg = case_config(run_opts)
    loaders = [Loader(TrajDataset(cfg.TRAIN.ROOT), batch_size=2, num_workers=1, shard_index=r, shard_count=WORLD)
               for r in range(WORLD)]
    state = create_train_state(build_model(cfg, device="cpu", seed=cli.ROOT_SEED), cfg)
    start = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    step = make_train_step(make_schedule_from_cfg(cfg, "cpu"), cfg)
    for it, shards in enumerate(zip(*loaders)):
        batch = {k: torch.from_numpy(np.concatenate([s[k] for s in shards])) for k in shards[0]}
        batch["image"] = normalize_images(batch["image"])
        step(state, batch, generator=cli.iteration_generators(it, "cpu")[1])
        if it == 0:
            grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
        if it == 1:
            break
    saved = torch.load(ck / "final.pth", weights_only=False)
    assert saved["iter"] == 2 == state.step
    lr_sum = LR  # the first update's LR is 0
    for (name, p), s, s_saved in zip(state.model.named_parameters(), state.ema.shadow_params,
                                     saved["ema_state_dict"]["shadow_params"]):
        got, want = saved["state_dict"][name], p.detach()
        assert ((got - want).abs() <= 2 * lr_sum).all(), name
        assert ((s_saved - s).abs() <= 2 * lr_sum).all(), name
        keep = grads[name].abs() >= max(1e-6, 1e-3 * float(grads[name].abs().max()))
        if keep.any():
            moved, ref = (got - start[name])[keep], (want - start[name])[keep]
            assert (moved - ref).norm() <= 1e-3 * ref.norm() + 1e-6, name
