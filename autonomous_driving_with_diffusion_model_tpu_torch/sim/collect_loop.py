"""Crash-restart collection supervisor (reference: misc/collect_loop.py:7-44),
extended with shard-parallel collection across CARLA servers.

The port's own copy of the JAX package's ``sim/collect_loop.py``, which it may not import.

Single shard reproduces the reference loop: re-launch the collector
subprocess until the sample quota is met, resuming from the on-disk counts.
With ``--num-shards N`` the quota is split over N concurrently-supervised
collectors, each writing ``{save_path}/shard_{i}`` against its own server
port (``--base-port + 10*i``; a CARLA server claims a small port range), then
the shards are merged into one contiguously-numbered dataset at
``{save_path}`` (the exact on-disk contract dataset/carla_dataset.py expects).
"""

from __future__ import annotations

import argparse
import glob
import os
import os.path as osp
import shutil
import subprocess
import sys
import threading
from typing import List, Sequence

from .collector import count_current_saved

__all__ = ["collect_loop", "collect_sharded", "merge_shards"]


def collect_loop(num_to_collect: int, output_dir: str, extra_args: Sequence[str] = ()):
    """Supervise ONE collector until ``output_dir`` holds the quota.

    Each (re)launch draws a fresh time-based seed inside collect_cli unless
    the caller pins one — a crash-restart must not replay the same episode
    sequence into duplicated samples (reference data_collect.py:36-44)."""
    extra_args = list(extra_args)
    if "--off-screen" not in extra_args:
        extra_args.append("--off-screen")  # headless servers, like the reference
    cur_num = count_current_saved(output_dir)
    while cur_num < num_to_collect:
        process = subprocess.Popen(
            [
                sys.executable,
                "-m",
                "autonomous_driving_with_diffusion_model_tpu_torch.sim.collect_cli",
                "--save-path",
                output_dir,
                "--save-num",
                str(num_to_collect),
                *extra_args,
            ]
        )
        process.wait()
        cur_num = count_current_saved(output_dir)
        print(f"[{output_dir}] collected: {cur_num}/{num_to_collect}")


def merge_shards(shard_dirs: Sequence[str], dest: str, hardlink: bool = False) -> int:
    """Renumber shard datasets into one contiguous dataset at ``dest``.

    Only complete samples (front png + waypoints txt present) are taken; bev
    images come along when present. Copies by default so a later re-collection
    of a shard (which may rewrite a crash-truncated stem in place) cannot
    silently mutate the merged dataset through a shared inode; pass
    ``hardlink=True`` for the space-saving variant when shards are final.
    Returns the merged sample count."""
    for sub in ("front", "bev", "waypoints"):
        os.makedirs(osp.join(dest, sub), exist_ok=True)

    def _place(src, dst):
        if osp.exists(dst):
            os.remove(dst)
        if hardlink:
            try:
                os.link(src, dst)
                return
            except OSError:
                pass
        shutil.copy2(src, dst)

    out_idx = 0
    for shard in shard_dirs:
        fronts = sorted(glob.glob(osp.join(shard, "front", "*.png")))
        for front in fronts:
            stem = osp.splitext(osp.basename(front))[0]
            wp = osp.join(shard, "waypoints", f"{stem}.txt")
            if not osp.exists(wp):
                continue  # incomplete sample (collector crashed mid-write)
            _place(front, osp.join(dest, "front", f"{out_idx:06d}.png"))
            _place(wp, osp.join(dest, "waypoints", f"{out_idx:06d}.txt"))
            bev = osp.join(shard, "bev", f"{stem}.png")
            dest_bev = osp.join(dest, "bev", f"{out_idx:06d}.png")
            if osp.exists(bev):
                _place(bev, dest_bev)
            elif osp.exists(dest_bev):
                os.remove(dest_bev)  # no stale pairing from a prior merge
            out_idx += 1

    # truncate leftovers from a previous, larger merge — a re-merge with
    # fewer shards/samples must not leave stale samples the loader would see
    for sub, pat in (("front", "*.png"), ("waypoints", "*.txt"), ("bev", "*.png")):
        for path in glob.glob(osp.join(dest, sub, pat)):
            stem = osp.splitext(osp.basename(path))[0]
            if stem.isdigit() and int(stem) >= out_idx:
                os.remove(path)
    return out_idx


def collect_sharded(
    num_to_collect: int,
    output_dir: str,
    num_shards: int,
    base_port: int = 2000,
    extra_args: Sequence[str] = (),
    merge: bool = True,
) -> int:
    """Split the quota over ``num_shards`` concurrently-supervised collectors
    (each with its own save dir + server port), then merge into
    ``output_dir``. Crash-restart applies per shard; re-running resumes each
    shard from its on-disk count."""
    per = num_to_collect // num_shards
    quotas = [per + (1 if i < num_to_collect % num_shards else 0) for i in range(num_shards)]
    shard_dirs: List[str] = [osp.join(output_dir, f"shard_{i}") for i in range(num_shards)]

    threads = []
    errors: List[BaseException] = []

    def _supervise(quota, shard_dir, shard_args):
        try:
            collect_loop(quota, shard_dir, shard_args)
        except BaseException as exc:  # propagate to the caller after join
            errors.append(exc)

    for i, (quota, shard_dir) in enumerate(zip(quotas, shard_dirs)):
        if quota == 0:
            continue
        # per-shard port only; seeds stay fresh-per-launch inside collect_cli
        # (a fixed per-shard seed would make every crash-restart replay the
        # same episodes into duplicated samples)
        shard_args = list(extra_args) + ["--port", str(base_port + 10 * i)]
        t = threading.Thread(
            target=_supervise, args=(quota, shard_dir, shard_args), daemon=True
        )
        t.start()
        threads.append(t)
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(
            f"{len(errors)} shard supervisor(s) failed; first: {errors[0]!r}"
        ) from errors[0]

    if not merge:
        return sum(count_current_saved(d) for d in shard_dirs)
    merged = merge_shards(shard_dirs, output_dir)
    print(f"merged {merged} samples from {num_shards} shards into {output_dir}")
    return merged


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--save-num", type=int, required=True)
    parser.add_argument("--save-path", type=str, required=True)
    parser.add_argument("--num-shards", type=int, default=1)
    parser.add_argument("--base-port", type=int, default=2000)
    parser.add_argument("--no-merge", action="store_true")
    parser.add_argument(
        "--collector-args", nargs=argparse.REMAINDER, default=[],
        help="remaining args pass through to collect_cli (e.g. --off-screen, "
             "--fake-env, --town Town01)",
    )
    args = parser.parse_args()
    if args.num_shards <= 1:
        collect_loop(args.save_num, args.save_path, list(args.collector_args or []))
    else:
        collect_sharded(
            args.save_num,
            args.save_path,
            args.num_shards,
            base_port=args.base_port,
            extra_args=list(args.collector_args or []),
            merge=not args.no_merge,
        )
