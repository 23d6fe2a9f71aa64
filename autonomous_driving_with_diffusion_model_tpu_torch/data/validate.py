"""Dataset validation CLI: integrity + distribution stats over a collected root.

The port's own copy of the JAX package's ``data/validate.py``, which it may not import.

The reference has no dataset tooling at all — collection quality is discovered
at training time (a corrupt png raises inside a DataLoader worker,
dataset/carla_dataset.py:24-42). This sweeps the on-disk contract up front:

* pairing: every ``front/*.png`` has its ``waypoints/{idx:06d}.txt`` (and
  vice versa), plus optional ``bev/`` coverage;
* decodability: every png opens (corrupt files listed);
* schema: waypoint files parse to 1 target line + 16 rows x 7 floats;
* distributions: target-point spread, out-of-range (pre-clip) row rate,
  red-light fraction (16 identical full-brake transitions — the collector's
  red-light synthesis, reference misc/data_collect.py:159-166), action stats.

Usage::

    python -m autonomous_driving_with_diffusion_model_tpu_torch.data.validate \
        --root <dataset_dir> [--json] [--sample N]

The JAX copy decodes with ``cv2.imread``; this one with ``data/png.py``'s
reader, which takes the 8-bit grey, RGB and RGBA PNGs that the collectors
write and reports any file it cannot decode as corrupt, where ``cv2.imread``
returns None.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import os.path as osp
from typing import Dict, List, Optional

import numpy as np

from .png import read_png

__all__ = ["validate_dataset", "format_report"]


def _parse_waypoints(path: str):
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    target = np.asarray([float(v) for v in lines[0].split()], np.float64)
    rows = np.asarray([[float(v) for v in ln.split()] for ln in lines[1:]], np.float64)
    return target, rows


def validate_dataset(
    root: str, sample: Optional[int] = None, check_images: bool = True
) -> Dict:
    """Sweep ``root`` and return the report dict (see module docstring).

    ``sample``: only decode-check the first N images (waypoint files are
    always all parsed — they're cheap)."""
    fronts = sorted(glob.glob(osp.join(root, "front", "*.png")))
    waypoints = sorted(glob.glob(osp.join(root, "waypoints", "*.txt")))
    bevs = sorted(glob.glob(osp.join(root, "bev", "*.png")))

    front_ids = {osp.splitext(osp.basename(p))[0] for p in fronts}
    wp_ids = {osp.splitext(osp.basename(p))[0] for p in waypoints}
    bev_ids = {osp.splitext(osp.basename(p))[0] for p in bevs}

    report: Dict = {
        "root": root,
        "num_front": len(fronts),
        "num_waypoints": len(waypoints),
        "num_bev": len(bevs),
        "missing_waypoints": sorted(front_ids - wp_ids),
        "orphan_waypoints": sorted(wp_ids - front_ids),
        "missing_bev": len(front_ids - bev_ids) if bevs else len(front_ids),
    }

    corrupt: List[str] = []
    image_hw = None
    if check_images:
        to_check = fronts if sample is None else fronts[:sample]
        for p in to_check:
            try:
                img = read_png(p)
            except Exception:  # where cv2.imread returns None
                corrupt.append(osp.basename(p))
                continue
            if image_hw is None:
                image_hw = tuple(int(v) for v in img.shape[:2])
        report["images_checked"] = len(to_check)
    report["corrupt_images"] = corrupt
    report["image_hw"] = image_hw

    bad_schema: List[str] = []
    targets, clipped_rows, red_light, n_rows_total = [], 0, 0, 0
    actions = []
    for p in waypoints:
        try:
            target, rows = _parse_waypoints(p)
            assert target.shape == (2,), "target line must be 2 floats"
            assert rows.shape == (16, 7), f"expected 16x7 rows, got {rows.shape}"
        except Exception:
            bad_schema.append(osp.basename(p))
            continue
        targets.append(target)
        n_rows_total += len(rows)
        clipped_rows += int(np.sum(np.any(np.abs(rows) > 1.0, axis=1)))
        actions.append(rows[:, 4:7])
        # red-light synthesis: 16 identical stationary full-brake transitions
        # (data_collect.py:159-166)
        if np.all(rows == rows[0]) and rows[0, 6] == 1.0 and rows[0, 4] == 0.0:
            red_light += 1
    report["bad_schema"] = bad_schema

    n_ok = len(targets)
    report["num_valid_samples"] = n_ok
    if n_ok:
        t = np.asarray(targets)
        a = np.concatenate(actions, axis=0)
        report["target_stats"] = {
            "mean": [round(float(v), 4) for v in t.mean(0)],
            "std": [round(float(v), 4) for v in t.std(0)],
            "min": [round(float(v), 4) for v in t.min(0)],
            "max": [round(float(v), 4) for v in t.max(0)],
        }
        report["clipped_row_rate"] = round(clipped_rows / max(n_rows_total, 1), 4)
        report["red_light_fraction"] = round(red_light / n_ok, 4)
        report["action_means"] = {
            "throttle": round(float(a[:, 0].mean()), 4),
            "steer": round(float(a[:, 1].mean()), 4),
            "brake": round(float(a[:, 2].mean()), 4),
        }
    report["ok"] = not (
        report["missing_waypoints"] or report["orphan_waypoints"]
        or corrupt or bad_schema or n_ok == 0
    )
    return report


def format_report(report: Dict) -> str:
    lines = [
        f"dataset root: {report['root']}",
        f"  front images : {report['num_front']}"
        + (f" ({report['image_hw'][1]}x{report['image_hw'][0]})" if report.get("image_hw") else ""),
        f"  waypoints    : {report['num_waypoints']}",
        f"  bev images   : {report['num_bev']} (missing {report['missing_bev']})",
        f"  valid samples: {report['num_valid_samples']}",
    ]
    for key in ("missing_waypoints", "orphan_waypoints", "corrupt_images", "bad_schema"):
        vals = report.get(key) or []
        if vals:
            shown = ", ".join(vals[:5]) + (" ..." if len(vals) > 5 else "")
            lines.append(f"  {key:<16}: {len(vals)} [{shown}]")
    if report.get("target_stats"):
        ts = report["target_stats"]
        lines.append(f"  target mean/std: {ts['mean']} / {ts['std']}")
        lines.append(f"  target min/max : {ts['min']} / {ts['max']}")
        lines.append(f"  clipped-row rate    : {report['clipped_row_rate']:.2%}")
        lines.append(f"  red-light fraction  : {report['red_light_fraction']:.2%}")
        am = report["action_means"]
        lines.append(
            "  action means        : throttle "
            f"{am['throttle']:.3f}, steer {am['steer']:.3f}, brake {am['brake']:.3f}"
        )
    lines.append("  status: " + ("OK" if report["ok"] else "PROBLEMS FOUND"))
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", required=True, help="dataset root directory")
    parser.add_argument("--json", action="store_true", help="print the raw JSON report")
    parser.add_argument(
        "--sample", type=int, default=None,
        help="decode-check only the first N images (default: all)",
    )
    args = parser.parse_args(argv)
    report = validate_dataset(args.root, sample=args.sample)
    if args.json:
        print(json.dumps(report))
    else:
        print(format_report(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
