"""Leaderboard result aggregation (reference: e2e_driving/statistics.py:13-72).

The port's own copy of the JAX package's ``driving/statistics.py``, which it may not import.

Aggregates a leaderboard ``_checkpoint`` JSON: mean composed/penalty/route
scores over the first 15 records, per-infraction rates per km averaged over 3
interleaved runs, and the 3-run std protocol.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List

import numpy as np

__all__ = ["cal_std", "aggregate", "main"]

INFRACTION_KEYS = [
    "collisions_layout",
    "collisions_pedestrian",
    "collisions_vehicle",
    "red_light",
    "stop_infraction",
    "vehicle_blocked",
    "outside_route_lanes",
]


def cal_std(score_list: List[float]) -> float:
    """3-interleaved-run std (reference: statistics.py:13-25)."""
    total_length = len(score_list)
    run_means = [
        sum(score_list[i::3]) / (total_length / 3) for i in range(3)
    ]
    mean = sum(score_list) / total_length
    return float(np.sqrt(sum((m - mean) ** 2 for m in run_means) / 3))


def aggregate(data: Dict) -> Dict:
    records = data["_checkpoint"]["records"]
    # surface the env provenance so a synthetic (fake-env) smoke run can never
    # be mistaken for a real evaluation in quoted output
    out: Dict = {
        "env_kinds": sorted(
            {r.get("meta", {}).get("env_kind", "unknown") for r in records}
        )
    }
    for key in ("score_composed", "score_penalty", "score_route"):
        vals = [r["scores"][key] for r in records[:15]]
        out[key] = sum(vals) / len(vals)

    for item in INFRACTION_KEYS:
        rates = []
        for i in range(3):
            length = 0.0
            count = 0
            for record in records[i::3]:
                length += (
                    record["scores"]["score_route"] / 100 * record["meta"]["route_length"] / 1000
                )
                count += len(record["infractions"][item])
            rates.append(count / length if length > 0 else 0.0)
        out[item] = sum(rates) / len(rates)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="Leaderboard statistics")
    parser.add_argument("--json-file", required=True, type=str)
    args = parser.parse_args(argv)
    with open(args.json_file) as f:
        data = json.load(f)
    result = aggregate(data)
    print("env_kinds =", ",".join(result["env_kinds"]))
    for key in ("score_composed", "score_penalty", "score_route"):
        print(f"{key} =", result[key])
    for item in INFRACTION_KEYS:
        print(item, "=", result[item])


if __name__ == "__main__":
    main()
