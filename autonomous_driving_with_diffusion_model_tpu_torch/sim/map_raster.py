"""Global map rasterizer: produces the birdview .h5 masks.

The port's own copy of the JAX package's ``sim/map_raster.py``, which it may not import.

cv2-based re-design of the reference's pygame map renderer (reference:
carla_gym/utils/birdview_map.py:16-511): lane strips (centerline polyline +
width + boundary marking types) rasterize into the road /
lane_marking_all / lane_marking_white_broken global masks consumed by
``sim.birdview.BirdviewRenderer`` — same .h5 layout and attrs
(world_offset_in_meters, pixels_per_meter).

``strips_from_carla_map`` extracts strips by waypoint-marching a live carla
map (gated on the carla package); any other map source producing LaneStrip
tuples works identically.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["LaneStrip", "rasterize_map", "save_h5", "strips_from_carla_map"]


@dataclass
class LaneStrip:
    """One lane: centerline (N, 2) world meters, per-point width (N,), and
    boundary marking kinds ("solid" | "broken" | "none") for each side."""

    centerline: np.ndarray
    width: np.ndarray
    left_marking: str = "solid"
    right_marking: str = "solid"


def _boundaries(strip: LaneStrip) -> Tuple[np.ndarray, np.ndarray]:
    c = np.asarray(strip.centerline, np.float64)
    w = np.asarray(strip.width, np.float64).reshape(-1)
    d = np.gradient(c, axis=0)
    norm = np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
    t = d / norm
    right = np.stack([-t[:, 1], t[:, 0]], axis=1)
    half = (w / 2.0)[:, None]
    return c - right * half, c + right * half


def _draw_polyline(mask, pts_px, thickness, dashed=False):
    import cv2 as cv

    pts = np.round(pts_px).astype(np.int32)
    if not dashed:
        cv.polylines(mask, [pts], False, 255, thickness=thickness)
        return
    # dashed: 3 m dash / 3 m gap pattern along the polyline (broken markings)
    seg_len = 0.0
    on = True
    for i in range(len(pts) - 1):
        a, b = pts[i], pts[i + 1]
        step = float(np.linalg.norm(b - a))
        if on:
            cv.line(mask, tuple(a), tuple(b), 255, thickness=thickness)
        seg_len += step
        if seg_len > 15:  # ~3 m at 5 px/m
            seg_len = 0.0
            on = not on


def rasterize_map(
    strips: Sequence[LaneStrip],
    pixels_per_meter: float = 5.0,
    margin_m: float = 10.0,
) -> Dict:
    """-> {"road", "lane_marking_all", "lane_marking_white_broken",
    "world_offset_in_meters", "pixels_per_meter"}."""
    import cv2 as cv

    all_pts = np.concatenate([np.asarray(s.centerline, np.float64) for s in strips])
    max_w = max(float(np.max(s.width)) for s in strips)
    lo = all_pts.min(axis=0) - margin_m - max_w
    hi = all_pts.max(axis=0) + margin_m + max_w
    world_offset = lo.astype(np.float32)
    size = np.ceil((hi - lo) * pixels_per_meter).astype(int)
    W, H = int(size[0]), int(size[1])

    road = np.zeros((H, W), np.uint8)
    lane_all = np.zeros((H, W), np.uint8)
    lane_broken = np.zeros((H, W), np.uint8)

    def to_px(pts):
        return (np.asarray(pts, np.float64) - lo) * pixels_per_meter

    for strip in strips:
        left, right = _boundaries(strip)
        poly = np.concatenate([to_px(left), to_px(right)[::-1]])
        cv.fillPoly(road, [np.round(poly).astype(np.int32)], 255)
        for side_pts, kind in ((left, strip.left_marking), (right, strip.right_marking)):
            if kind == "none":
                continue
            _draw_polyline(lane_all, to_px(side_pts), 1, dashed=False)
            if kind == "broken":
                _draw_polyline(lane_broken, to_px(side_pts), 1, dashed=True)

    return {
        "road": road,
        "lane_marking_all": lane_all,
        "lane_marking_white_broken": lane_broken,
        "world_offset_in_meters": world_offset,
        "pixels_per_meter": float(pixels_per_meter),
    }


def save_h5(path: str, masks: Dict) -> None:
    """Write the BirdviewRenderer-compatible .h5 (chauffeurnet.py:81-100 layout)."""
    import h5py

    with h5py.File(path, "w") as hf:
        for key in ("road", "lane_marking_all", "lane_marking_white_broken"):
            hf.create_dataset(key, data=masks[key], compression="gzip")
        hf.attrs["world_offset_in_meters"] = masks["world_offset_in_meters"]
        hf.attrs["pixels_per_meter"] = masks["pixels_per_meter"]


def strips_from_carla_map(carla_map, precision: float = 1.0) -> List[LaneStrip]:
    """Waypoint-march every road of a live carla map into LaneStrips
    (reference: birdview_map.py topology walk)."""
    strips: List[LaneStrip] = []
    for start, _ in carla_map.get_topology():
        pts, widths = [], []
        wp = start
        guard = 0
        while wp is not None and guard < 10000:
            loc = wp.transform.location
            pts.append([loc.x, loc.y])
            widths.append(wp.lane_width)
            nxt = wp.next(precision)
            if not nxt or nxt[0].road_id != start.road_id:
                break
            wp = nxt[0]
            guard += 1
        if len(pts) >= 2:
            strips.append(
                LaneStrip(
                    centerline=np.asarray(pts),
                    width=np.asarray(widths),
                    left_marking="broken",
                    right_marking="solid",
                )
            )
    return strips


def main(argv=None):
    """Map-generation CLI (reference: carla_gym/utils/birdview_map.py CLI +
    config_utils.py:12-53 check): connect to a CARLA server, march each town's
    lane topology, rasterize, and save the renderer-compatible .h5.

        python -m autonomous_driving_with_diffusion_model_tpu_torch.sim.map_raster \
            --towns Town01 Town02 --save-dir maps --pixels-per-meter 5.0
    """
    import argparse
    import os

    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("--host", default="localhost")
    parser.add_argument("--port", default=2000, type=int)
    parser.add_argument("--towns", nargs="+", default=["Town01"])
    parser.add_argument("--save-dir", required=True)
    parser.add_argument("--pixels-per-meter", default=5.0, type=float)
    parser.add_argument("--precision", default=1.0, type=float)
    args = parser.parse_args(argv)

    import carla

    client = carla.Client(args.host, args.port)
    client.set_timeout(60.0)
    os.makedirs(args.save_dir, exist_ok=True)
    for town in args.towns:
        world = client.load_world(town)
        carla_map = world.get_map()
        strips = strips_from_carla_map(carla_map, precision=args.precision)
        masks = rasterize_map(strips, pixels_per_meter=args.pixels_per_meter)
        path = os.path.join(args.save_dir, f"{town}.h5")
        save_h5(path, masks)
        print(f"{path}: {len(strips)} lane strips, {masks['road'].shape} px")


if __name__ == "__main__":
    main()
