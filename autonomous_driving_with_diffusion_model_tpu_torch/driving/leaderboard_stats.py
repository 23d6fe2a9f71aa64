"""Leaderboard global-record math over ``_checkpoint`` records.

The port's own copy of the JAX package's ``driving/leaderboard_stats.py``, which it may not import.

First-party implementation of the vendored StatisticsManager's aggregation
(reference: leaderboard/leaderboard/utils/statistics_manager.py:234-361):
``compute_global_record`` mirrors ``compute_global_statistics`` and
``finalize_checkpoint`` mirrors ``save_global_record``'s values/labels +
entry-status block, so a checkpoint produced by ``driving.evaluator`` carries
the exact artifact the leaderboard publishes.

Parity is asserted against the *vendored implementation itself* in
``tests/test_statistics_reconcile.py`` (imported read-only from
/root/reference), including the vendored quirk that per-km infraction rates
divide by ``score_route(%) * route_length_m / 1000`` — i.e. the percentage is
used unnormalized (statistics_manager.py:252-261). We reproduce it verbatim
because the reconciliation contract is bit-equality with the consumer.
"""

from __future__ import annotations

from typing import Dict, List

__all__ = ["GLOBAL_INFRACTION_KEYS", "compute_global_record", "finalize_checkpoint"]

# RouteRecord.infractions key order (statistics_manager.py:38-48)
GLOBAL_INFRACTION_KEYS = [
    "collisions_pedestrian",
    "collisions_vehicle",
    "collisions_layout",
    "red_light",
    "stop_infraction",
    "outside_route_lanes",
    "route_dev",
    "route_timeout",
    "vehicle_blocked",
]

# data["labels"] column order (statistics_manager.py:303-338)
GLOBAL_LABELS = [
    "Avg. driving score",
    "Avg. route completion",
    "Avg. infraction penalty",
    "Collisions with pedestrians",
    "Collisions with vehicles",
    "Collisions with layout",
    "Red lights infractions",
    "Stop sign infractions",
    "Off-road infractions",
    "Route deviations",
    "Route timeouts",
    "Agent blocked",
]

def compute_global_record(records: List[Dict], total_routes: int) -> Dict:
    """Aggregate route records into the leaderboard's global record
    (statistics_manager.py:234-280): summed-then-averaged scores, per-km
    infraction rates, and the exceptions list for non-completed routes."""
    scores = {"score_route": 0.0, "score_penalty": 0.0, "score_composed": 0.0}
    infractions: Dict[str, float] = {k: 0.0 for k in GLOBAL_INFRACTION_KEYS}
    status = "Completed"
    meta: Dict = {}

    for record in records:
        for key in scores:
            scores[key] += record["scores"][key]
        # vendored quirk: score_route is a 0-100 percentage but is used
        # UN-normalized here (statistics_manager.py:252-257) — kept verbatim
        route_length_kms = max(
            record["scores"]["score_route"] * record["meta"]["route_length"] / 1000.0,
            0.001,
        )
        for key in GLOBAL_INFRACTION_KEYS:
            infractions[key] += len(record["infractions"].get(key, [])) / route_length_kms
        if record["status"] != "Completed":
            status = "Failed"
            meta.setdefault("exceptions", []).append(
                (record["route_id"], record["index"], record["status"])
            )

    for key in scores:
        # zero routes (e.g. a filter matched nothing): an all-zero record,
        # not a ZeroDivisionError
        scores[key] /= float(max(total_routes, 1))

    return {
        "route_id": -1,
        "index": -1,
        "status": status,
        "infractions": infractions,
        "scores": scores,
        "meta": meta,
    }


def finalize_checkpoint(data: Dict, total_routes: int) -> Dict:
    """Attach ``global_record`` / ``values`` / ``labels`` / ``entry_status`` /
    ``eligible`` to a ``_checkpoint`` dict, like the vendored
    ``save_global_record`` + ``save_entry_status`` (statistics_manager.py:
    283-361). Mutates and returns ``data``."""
    records = data["_checkpoint"]["records"]
    progress = data["_checkpoint"].get("progress") or [len(records), total_routes]
    global_record = compute_global_record(records, total_routes)
    data["_checkpoint"]["global_record"] = global_record

    data["values"] = [
        "{:.3f}".format(global_record["scores"]["score_composed"]),
        "{:.3f}".format(global_record["scores"]["score_route"]),
        "{:.3f}".format(global_record["scores"]["score_penalty"]),
    ] + [
        # the values[] columns follow the RouteRecord infraction key order
        # (statistics_manager.py:309-322)
        "{:.3f}".format(global_record["infractions"][k]) for k in GLOBAL_INFRACTION_KEYS
    ]
    data["labels"] = list(GLOBAL_LABELS)

    entry_status = "Finished"
    eligible = True
    if len(records) != total_routes or progress[0] != progress[1]:
        entry_status = "Finished with missing data"
        eligible = False
    else:
        for record in records:
            if "Agent" in record["status"]:
                entry_status = "Finished with agent errors"
                break
    data["entry_status"] = entry_status
    data["eligible"] = eligible
    return data
