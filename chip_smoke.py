#!/usr/bin/env python3
"""Drives the PyTorch port of the planner on one NVIDIA GPU and checks it.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no result line):

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: the CUDA kernels from ``ops/csrc`` with nvcc (ptxas summary);
3. kernels against their plain PyTorch versions at every shape the
   planner's U-Net gives them, batch 1 and 2, float32 and bfloat16;
4. the path: ``DiffusionPlanner`` on the card at full width (ResNet-34 at
   900x256, MODEL.DIM 64, random weights from a seed) for the default,
   classifier-free and classifier guidance configs. Launch counts show the
   kernels on the path; the first plan is held against the same planner on
   the CPU; plan latency p50 and peak memory are printed;
5. kernel time by CUDA events beside the plain version's, the bound and the
   launch floor (the device time of an empty kernel launched the same way),
   with each launch's geometry; each residual block's time at every cluster
   size the geometry can pick; and the phase stamps of the head, of downs.0.1 and of mid_block1, cold (L2
   flushed) and warm: the median time of each phase over the CTAs, in ns and
   in SM cycles, and the span from the first entry to the last store.

The last two lines of standard output are the card (nvidia-smi) and the
kernels as JSON, then ``{"ok": true, "device": ...}``. Per-shape numbers go
to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "autonomous_driving_with_diffusion_model_tpu_torch"
CONFIGS = ("configs/default.yaml", "configs/guidance/free_guidance.yaml",
           "configs/guidance/classifier_guidance.yaml")
KERNEL_TOL = {
    # fp32: the conv sums up to 5 * 1024 products in another order than cuDNN
    "float32": dict(atol=1e-4, rtol=1e-4),
    # bf16: same bf16 inputs and fp32 math on both sides; the outputs may
    # round to neighbouring bf16 values (2^-8 relative), twice over
    "bfloat16": dict(atol=3e-2, rtol=1.6e-2),
}
# GPU plan vs CPU plan, in meters: 2 to 100 DDIM steps of float32 math whose
# sums run in other orders on the two devices
PLAN_TOL = dict(atol=5e-3, rtol=1e-3)
REPLACES = {
    "fused_residual_block": "autonomous_driving_with_diffusion_model_tpu/ops/pallas_kernels.py:106",
    "fused_conv1d_gn_mish": "autonomous_driving_with_diffusion_model_tpu/ops/pallas_kernels.py:206",
}


def log(*a):
    print(*a, flush=True)


def card_rates(name: str):
    """(bytes/s, float32 FLOP/s) from the data sheet of the named part."""
    if "PCIe" in name:
        return 2.0e12, 51e12
    if "NVL" in name:
        return 3.9e12, 60e12
    return 3.35e12, 67e12  # H100 SXM


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, PKG)):
        print(f"chip_smoke: {PKG}/ is not beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from autonomous_driving_with_diffusion_model_tpu_torch.driving import DiffusionPlanner
    from autonomous_driving_with_diffusion_model_tpu_torch.models import (
        Conv1dBlock,
        ResidualTemporalMapBlock,
    )
    from autonomous_driving_with_diffusion_model_tpu_torch.ops import build, kernels
    from autonomous_driving_with_diffusion_model_tpu_torch.utils.config import (
        create_cfg,
        merge_possible_with_base,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---------------------------------------------------------------- 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    bw, flops = card_rates(name)
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---------------------------------------------------------------- 2. build
    t0 = time.time()
    build.build_all()
    for src, report in build.ptxas_report.items():
        log(f"ptxas ({src}):\n{report}")
    log(f"build: {time.time() - t0:.1f} s")

    def load_cfg(path):
        cfg = create_cfg()
        merge_possible_with_base(cfg, os.path.join(REPO, path))
        return cfg

    # main-path shapes and weights: one forward of the default planner's U-Net
    planner = DiffusionPlanner(load_cfg(CONFIGS[0]), seed=0)
    calls = []
    hooks = [
        m.register_forward_hook(lambda mod, args, out, n=n: calls.append((n, mod, args)))
        for n, m in planner.model.named_modules()
        if isinstance(m, (ResidualTemporalMapBlock, Conv1dBlock))
    ]
    with torch.no_grad():
        feat = planner.model.encode_image(torch.zeros(1, 256, 900, 3, device=dev))
        planner.model(planner.init_trajs[:1], time=torch.ones(1, device=dev), img_feature=feat)
    for h in hooks:
        h.remove()
    del planner

    def case(mod, args, B, dtype, gen):
        """(kernel, plain version, arguments) for block ``mod`` at batch B,
        with its weights and random inputs of the shape the path gave it."""
        L, cin = args[0].shape[1:]
        x = torch.randn(B, L, cin, generator=gen).to(dev, dtype)
        params = tuple(None if p is None else p.to(dtype) for p in mod.kernel_params())
        if isinstance(mod, ResidualTemporalMapBlock):
            t = torch.randn(B, args[1].shape[1], generator=gen).to(dev, dtype)
            return kernels.fused_residual_block, kernels.residual_block_plain, (x, t) + params
        return kernels.fused_conv1d_gn_mish, kernels.conv1d_gn_mish_plain, (x,) + params

    report = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda, "shapes": []}

    # ---------------------------------------------------------------- 3. check
    gen = torch.Generator().manual_seed(0)
    max_err = {"fused_residual_block": 0.0, "fused_conv1d_gn_mish": 0.0}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            tol = KERNEL_TOL[str(dtype).split(".")[1]]
            for B in (1, 2):
                for n, m, a in calls:
                    fn, plain, args = case(m, a, B, dtype, gen)
                    got = fn(*args).float()
                    want = plain(*args).float()
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    ok = torch.allclose(got, want, **tol) and bool(torch.isfinite(got).all())
                    if dtype == torch.float32:
                        max_err[fn.__name__] = max(max_err[fn.__name__], err)
                    log(f"check {fn.__name__:22s} {n:22s} B={B} {tuple(args[0].shape)} "
                        f"{str(dtype)[6:]:8s} max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"{fn.__name__} at {n} B={B} {dtype}: max_abs_err {err}")

    # ---------------------------------------------------------------- 4. path
    def device_breakdown(run):
        """One run under torch.profiler: wall ms, the kernels' summed device
        ms (one stream, so they do not overlap), and that sum by kind."""
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        by_kind = {}
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            # kernels only: a CPU op's own device time repeats its kernels'
            if us <= 0 or getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
                continue
            name = ev.key
            kind = ("conv_gn_mish" if "gn_mish" in name else  # both port kernels
                    "memcpy/memset" if "Memcpy" in name or "Memset" in name else
                    "cudnn/cublas" if any(s in name for s in ("cudnn", "xmma", "gemm", "conv", "sm90")) else
                    "other")
            by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3
        dev_ms = sum(by_kind.values())
        return {"wall_ms": wall, "device_ms": dev_ms, "busy_share": dev_ms / wall,
                "by_kind": {k: round(v, 4) for k, v in sorted(by_kind.items())}}

    launches = {"fused_residual_block": 0, "fused_conv1d_gn_mish": 0}
    plans = {}
    frames = np.random.default_rng(1).integers(0, 256, (4, 256, 900, 3), dtype=np.uint8)
    target = np.array([0.3, 0.1], np.float32)
    for path in CONFIGS:
        cfg = load_cfg(path)
        gpu = DiffusionPlanner(cfg, seed=0)
        tgt = target if gpu.use_guidance_type.name != "NO_GUIDANCE" else None
        n_fwd = len(cfg.TPU.SAMPLE_TIMESTEPS) or cfg.EVAL.SAMPLE_STEPS
        kernels.reset_launch_counts()
        first = gpu.plan(frames[0], tgt)
        torch.cuda.synchronize()
        got = {"fused_residual_block": kernels.fused_residual_block.launches,
               "fused_conv1d_gn_mish": kernels.fused_conv1d_gn_mish.launches}
        want = {"fused_residual_block": 16 * n_fwd, "fused_conv1d_gn_mish": n_fwd}
        log(f"path {path}: launches {got}, expected {want}")
        if got != want:
            raise AssertionError(f"{path}: launch counts {got} != {want}")
        for k in launches:
            launches[k] += got[k]
        if first.shape != (1, cfg.MODEL.HORIZON, cfg.MODEL.TRANSITION_DIM) or not np.isfinite(first).all():
            raise AssertionError(f"{path}: plan shape {first.shape} or non-finite values")

        cpu = DiffusionPlanner(cfg, seed=0, device="cpu")
        cpu.init_trajs = gpu.init_trajs.cpu()
        ref = cpu.plan(frames[0], tgt)
        diff = float(np.abs(first - ref).max())
        ok = np.allclose(first, ref, **PLAN_TOL)
        log(f"path {path}: GPU vs CPU plan max_abs_diff={diff:.3e} m {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{path}: GPU plan differs from the CPU plan by {diff} m")
        del cpu

        gpu.plan(frames[1], tgt)  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(5):
            t0 = time.perf_counter()
            gpu.plan(frames[i % len(frames)], tgt)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        p50 = float(np.median(times))
        peak = torch.cuda.max_memory_allocated() / 2**20
        busy = device_breakdown(lambda: gpu.plan(frames[2], tgt))
        plans[path] = {"steps": n_fwd, "plan_ms_p50": p50, "plan_ms": times, "peak_mib": peak,
                       "gpu_vs_cpu_max_abs_m": diff, "profile": busy}
        log(f"path {path}: plan p50 {p50:.2f} ms over {len(times)} plans ({n_fwd} steps), "
            f"peak {peak:.1f} MiB, on {smi}")
        log(f"path {path}: profiled plan {busy['wall_ms']:.2f} ms, device busy {busy['device_ms']:.2f} ms "
            f"({busy['busy_share']:.3f}); device ms by kind {busy['by_kind']}")
        del gpu
    report["plans"] = plans

    # ---------------------------------------------------------------- 5. time
    def eager_cycle_ms(fns, reps=20, warm=3):
        """Mean ms of each fn, called eagerly in turn as one forward calls
        them: CUDA events between the calls, so the host's time to issue a
        call counts wherever the card waits for it."""
        for _ in range(warm):
            for f in fns:
                f()
        ev = [[torch.cuda.Event(enable_timing=True) for _ in range(len(fns) + 1)] for _ in range(reps)]
        for r in range(reps):
            ev[r][0].record()
            for i, f in enumerate(fns):
                f()
                ev[r][i + 1].record()
        torch.cuda.synchronize()
        return [sum(ev[r][i].elapsed_time(ev[r][i + 1]) for r in range(reps)) / reps for i in range(len(fns))]

    def graph_ms(fns, reps=20):
        """Device ms of one pass over fns: the pass is captured once in a
        CUDA graph and replayed, so no host time falls between launches."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for f in fns:
                f()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for f in fns:
                f()
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def geometries(fn, args):
        """The geometry of each launch of one call, as the wrapper launches it."""
        B, L, cin = args[0].shape
        if fn is kernels.fused_residual_block:
            return kernels.residual_block_geometry(B, L, cin, args[2].shape[2], args[1].shape[1],
                                                   args[12] is not None)
        return (kernels.head_geometry(B, L, cin, args[1].shape[2], args[1].shape[0], 8,
                                      args[0].element_size(), args[1].element_size()),)

    def describe(geo):
        if isinstance(geo, kernels.HeadGeometry):
            return (f"P={kernels.HEAD_P} S={geo.S} threads={geo.threads} copies={geo.width}B "
                    f"stage={geo.stage} ctas={geo.ctas}")
        return f"cs={geo.cs} ctas={geo.ctas}"

    def bound_ms(fn, args):
        x = args[0]
        B, L, cin = x.shape
        tensors = [a for a in args if a is not None]
        if fn is kernels.fused_residual_block:
            C, E = args[2].shape[2], args[1].shape[1]
            ops = 2 * B * (L * 5 * cin * C + L * 5 * C * C + E * C + (L * cin * C if args[12] is not None else 0))
        else:
            C = args[1].shape[2]
            ops = 2 * B * L * 5 * cin * C
        nbytes = sum(a.numel() * a.element_size() for a in tensors) + B * L * C * x.element_size()
        t_bytes, t_ops = nbytes / bw * 1e3, ops / flops * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    gen = torch.Generator().manual_seed(1)
    cases = [case(m, a, 1, torch.float32, gen) for n, m, a in calls]
    kcall = lambda c: (lambda: c[0](*c[2]))
    pcall = lambda c: (lambda: c[1](*c[2]))
    template_lib = build.library(kernels.SOURCE)

    def empty(geo):
        """An empty kernel launched as a launch of geometry ``geo`` is: in
        clusters of ``geo.cs`` for the template, with no cluster for the head
        (whose geometry has no ``cs``); with its shared memory."""
        def f():
            stream = torch.cuda.current_stream().cuda_stream
            err = template_lib.adm_empty_launch(geo.ctas, geo.threads, getattr(geo, "cs", 0),
                                                geo.smem, stream)
            if err != 0:
                raise RuntimeError(f"empty launch failed (CUDA error {err}, {geo})")
        return f

    summary = {}
    with torch.no_grad():
        # one forward's calls of each kernel, in forward order: the weights of
        # a whole forward (61 MB) exceed the 50 MB L2, as in a plan
        for kname in ("fused_residual_block", "fused_conv1d_gn_mish"):
            mine = [c for c in cases if c[0].__name__ == kname]
            bounds = [bound_ms(c[0], c[2]) for c in mine]
            geos = [g for c in mine for g in geometries(c[0], c[2])]
            summary[kname] = dict(
                ms=graph_ms([kcall(c) for c in mine]),
                plain_ms=graph_ms([pcall(c) for c in mine]),
                bound_ms=sum(b for b, _ in bounds),
                bound_by="bytes" if all(by == "bytes" for _, by in bounds) else "operations",
                floor_ms=graph_ms([empty(g) for g in geos]),
                calls=len(mine), ctas=sum(g.ctas for g in geos),
            )
            log(f"time {kname}: one forward's {len(mine)} calls ({len(geos)} launches, "
                f"{summary[kname]['ctas']} CTAs in all), device ms: kernel "
                f"{summary[kname]['ms']:.4f}, plain {summary[kname]['plain_ms']:.4f}, "
                f"bound {summary[kname]['bound_ms']:.7f}, launch floor {summary[kname]['floor_ms']:.4f} "
                f"on {smi}")
        k_eager = eager_cycle_ms([kcall(c) for c in cases])
        p_eager = eager_cycle_ms([pcall(c) for c in cases])
        for (n, m, a), c, ke, pe in zip(calls, cases, k_eager, p_eager):
            fn, _, args = c
            b, by = bound_ms(fn, args)
            geos = geometries(fn, args)
            # the same call 20 times in one graph: device time with the
            # block's weights warm in L2
            reps = 20
            row = dict(kernel=fn.__name__, block=n, shape=list(args[0].shape),
                       C=int(args[2 if fn is kernels.fused_residual_block else 1].shape[-1]),
                       geometry=[describe(g) for g in geos],
                       kernel_us=graph_ms([kcall(c)] * reps) / reps * 1e3,
                       plain_us=graph_ms([pcall(c)] * reps) / reps * 1e3,
                       kernel_eager_us=ke * 1e3, plain_eager_us=pe * 1e3,
                       bound_us=b * 1e3, bound_by=by,
                       floor_us=graph_ms([empty(g) for g in geos] * reps) / reps * 1e3)
            report["shapes"].append(row)
            log(f"time {fn.__name__:22s} {n:22s} L={row['shape'][1]:2d} {row['shape'][2]:4d}->{row['C']:4d} "
                f"{'; '.join(row['geometry'])}: "
                f"kernel_us={row['kernel_us']:.2f} plain_us={row['plain_us']:.2f} "
                f"(eager, host included: {row['kernel_eager_us']:.1f} / {row['plain_eager_us']:.1f}) "
                f"bound_us={row['bound_us']:.5f} ({by}) floor_us={row['floor_us']:.3f} on {smi}")

        # the floor one launch pays: an empty kernel launched as the kernels
        # are, 20 in one graph (the template in clusters, the head plainly)
        report["launch_floor_us"] = []
        floors = [kernels.Geometry(cs, 1, threads, 0, ctas)
                  for ctas, threads, cs in ((8, 256, 1), (8, 1024, 1), (64, 1024, 8), (128, 1024, 8))]
        floors += [geometries(c[0], c[2])[0] for c in cases if c[0] is kernels.fused_conv1d_gn_mish][:1]
        for geo in floors:
            us = graph_ms([empty(geo)] * 20) / 20 * 1e3
            report["launch_floor_us"].append(dict(geometry=describe(geo), threads=geo.threads,
                                                  smem=geo.smem, us=us))
            how = (f"no cluster, {geo.smem} bytes of shared memory (the head's)"
                   if isinstance(geo, kernels.HeadGeometry) else f"in clusters of {geo.cs}")
            log(f"time empty launch: {geo.ctas} CTAs of {geo.threads} threads {how}: "
                f"{us:.3f} us of device time per launch in a graph, on {smi}")

        # each residual block at every cluster size the geometry can pick,
        # both launches forced to it (the same call 20 times in one graph)
        pick = kernels.launch_geometry
        try:
            for (n, m, a), c, row in zip(calls, cases, report["shapes"]):
                if c[0] is not kernels.fused_residual_block:
                    continue
                row["sweep_us"] = {}
                for cs in (1, 2, 4, 8):
                    kernels.launch_geometry = lambda *p, cs=cs, **kw: pick(*p, cs=cs)
                    row["sweep_us"][cs] = graph_ms([kcall(c)] * 20) / 20 * 1e3
                kernels.launch_geometry = pick
                log(f"sweep {n:22s} L={row['shape'][1]:2d} {row['shape'][2]:4d}->{row['C']:4d}: us at cs "
                    f"1/2/4/8 = {'/'.join(f'{v:.2f}' for v in row['sweep_us'].values())} "
                    f"(picked {'; '.join(row['geometry'])}) on {smi}")
        finally:
            kernels.launch_geometry = pick

        # phase stamps, cold (a 64 MB write evicts the 50 MB L2 first) and warm
        scratch = torch.empty(16 * 2**20, device=dev)
        report["phases"] = []
        names = [f"{a} -> {b}" for a, b in zip(kernels.PHASES, kernels.PHASES[1:])]
        for (n, m, a), c in zip(calls, cases):
            if c[0] is not kernels.fused_conv1d_gn_mish and n not in ("downs.0.1", "mid_block1"):
                continue
            fn, _, args = c
            geos = geometries(fn, args)
            for temp in ("cold", "warm"):
                bufs = [kernels.phase_stamps(g.ctas, dev) for g in geos]
                if temp == "cold":
                    scratch.zero_()
                else:
                    fn(*args)
                torch.cuda.synchronize()
                fn(*args, stamps=bufs[0] if len(bufs) == 1 else tuple(bufs))
                torch.cuda.synchronize()
                for i, (g, buf) in enumerate(zip(geos, bufs)):
                    t = buf.cpu().numpy()  # (ctas, phases, [ns, cycles])
                    d = np.diff(t, axis=1)
                    ph = dict(block=n, launch=i + 1, temp=temp, geometry=describe(g),
                              phase_ns=[float(np.median(d[:, p, 0])) for p in range(d.shape[1])],
                              phase_cycles=[float(np.median(d[:, p, 1])) for p in range(d.shape[1])],
                              cta_ns=float(np.median(t[:, -1, 0] - t[:, 0, 0])),
                              cta_cycles=float(np.median(t[:, -1, 1] - t[:, 0, 1])),
                              span_ns=int(t[:, -1, 0].max() - t[:, 0, 0].min()))
                    report["phases"].append(ph)
                    log(f"phases {n:22s} launch {i + 1} {temp}: " + "; ".join(
                        f"{nm} {ns:.0f} ns / {cy:.0f} cycles"
                        for nm, ns, cy in zip(names, ph["phase_ns"], ph["phase_cycles"]))
                        + f"; one CTA entry -> stored (median) {ph['cta_ns']:.0f} ns / "
                        f"{ph['cta_cycles']:.0f} cycles; first entry -> last store {ph['span_ns']} ns "
                        f"({describe(g)}) on {smi}")
        del scratch
        clocks = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
        report["clocks_sm"] = clocks
        log(f"phases: nvidia-smi clocks.sm, clocks.max.sm after the stamped launches: {clocks}")

    kernels_line = []
    for kname in ("fused_residual_block", "fused_conv1d_gn_mish"):
        s = summary[kname]
        source = kernels.HEAD_SOURCE if kname == "fused_conv1d_gn_mish" else kernels.SOURCE
        kernels_line.append(dict(
            name=kname, route="cuda", source=f"{PKG}/ops/csrc/{source}",
            replaces=REPLACES[kname], launches=launches[kname], max_abs_err=max_err[kname],
            ms=s["ms"], plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
            bound_by=s["bound_by"], library_ms=None, floor_ms=s["floor_ms"],
            per=f"one U-Net forward at batch 1, float32, device time: its {s['calls']} calls",
            library_note="no single PyTorch call computes this function",
        ))
    report["kernels"] = kernels_line
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    log(smi)
    log(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
