"""Chauffeurnet-style birdview renderer, simulator-independent.

The port's own copy of the JAX package's ``sim/birdview.py``, which it may not import.

Pure-data re-design of the roach BEV obs manager (reference:
carla_gym/core/obs_manager/birdview/chauffeurnet.py:40-411): ego-centric warp
of cached global road/lane masks, history-tinted vehicle/walker/traffic-light
masks, route polyline, and the pedestrian ``collision_px`` flag. Inputs are
plain arrays — global masks from the reference's town .h5 files (or any
rasterizer), actor oriented boxes as (center_xy, yaw_deg, extent_xy) tuples,
stop lines as vertex pairs. Default geometry matches the reference configs:
192 px @ 5 px/m, ego 40 px from the bottom, history [-16, -11, -6, -1].
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["BirdviewRenderer", "tint"]

COLOR_RED = (255, 0, 0)
COLOR_GREEN = (0, 255, 0)
COLOR_BLUE = (0, 0, 255)
COLOR_CYAN = (0, 255, 255)
COLOR_MAGENTA = (255, 0, 255)
COLOR_MAGENTA_2 = (255, 140, 255)
COLOR_YELLOW = (255, 255, 0)
COLOR_YELLOW_2 = (160, 160, 0)
COLOR_WHITE = (255, 255, 255)
COLOR_ALUMINIUM_3 = (136, 138, 133)
COLOR_ALUMINIUM_5 = (46, 52, 54)


def tint(color, factor):
    """Lighten a color toward white (reference: chauffeurnet.py:28-34)."""
    r, g, b = color
    return (
        int(r + (255 - r) * factor),
        int(g + (255 - g) * factor),
        int(b + (255 - b) * factor),
    )


Actor = Tuple[Tuple[float, float], float, Tuple[float, float]]  # (center, yaw_deg, extent)


class BirdviewRenderer:
    def __init__(
        self,
        road: np.ndarray,
        lane_marking_all: np.ndarray,
        lane_marking_white_broken: np.ndarray,
        world_offset: Sequence[float],
        pixels_per_meter: float = 5.0,
        width_in_pixels: int = 192,
        pixels_ev_to_bottom: int = 40,
        history_idx: Sequence[int] = (-16, -11, -6, -1),
        scale_bbox: bool = True,
        scale_mask_col: float = 1.1,
    ):
        self._road = road
        self._lane_all = lane_marking_all
        self._lane_broken = lane_marking_white_broken
        self._world_offset = np.asarray(world_offset, np.float32)
        self._ppm = pixels_per_meter
        self._width = width_in_pixels
        self._pixels_ev_to_bottom = pixels_ev_to_bottom
        self._history_idx = list(history_idx)
        self._scale_bbox = scale_bbox
        self._scale_mask_col = scale_mask_col
        self._history: deque = deque(maxlen=20)
        # record-time actor gate, one canvas width in meters
        # (reference chauffeurnet.py:102)
        self.distance_threshold = float(np.ceil(width_in_pixels / pixels_per_meter))

    @classmethod
    def from_h5(cls, path: str, **kwargs) -> "BirdviewRenderer":
        """Load the reference's cached global masks
        (chauffeurnet.py:81-100 layout; files under
        carla_gym/core/obs_manager/birdview/maps/*.h5)."""
        import h5py

        with h5py.File(path, "r", libver="latest", swmr=True) as hf:
            return cls(
                road=np.array(hf["road"], np.uint8),
                lane_marking_all=np.array(hf["lane_marking_all"], np.uint8),
                lane_marking_white_broken=np.array(hf["lane_marking_white_broken"], np.uint8),
                world_offset=np.array(hf.attrs["world_offset_in_meters"], np.float32),
                pixels_per_meter=float(hf.attrs["pixels_per_meter"]),
                **kwargs,
            )

    # ------------------------------------------------------------- geometry

    def _world_to_pixel(self, loc_xy) -> np.ndarray:
        return self._ppm * (np.asarray(loc_xy, np.float32) - self._world_offset[:2])

    def _warp_transform(self, ev_loc_xy, ev_yaw_deg):
        import cv2 as cv

        ev_px = self._world_to_pixel(ev_loc_xy)
        yaw = np.deg2rad(ev_yaw_deg)
        fwd = np.array([np.cos(yaw), np.sin(yaw)])
        right = np.array([np.cos(yaw + 0.5 * np.pi), np.sin(yaw + 0.5 * np.pi)])
        w = self._width
        bottom_left = ev_px - self._pixels_ev_to_bottom * fwd - 0.5 * w * right
        top_left = ev_px + (w - self._pixels_ev_to_bottom) * fwd - 0.5 * w * right
        top_right = ev_px + (w - self._pixels_ev_to_bottom) * fwd + 0.5 * w * right
        src = np.stack([bottom_left, top_left, top_right]).astype(np.float32)
        dst = np.array([[0, w - 1], [0, 0], [w - 1, 0]], np.float32)
        return cv.getAffineTransform(src, dst)

    def _actor_mask(self, actors: Sequence[Actor], M) -> np.ndarray:
        import cv2 as cv

        mask = np.zeros((self._width, self._width), np.uint8)
        for (cx, cy), yaw_deg, (ex, ey) in actors:
            yaw = np.deg2rad(yaw_deg)
            R = np.array([[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]])
            # pointed pentagon showing heading (chauffeurnet.py:327-333)
            local = np.array(
                [[-ex, -ey], [ex, -ey], [ex, 0.0], [ex, ey], [-ex, ey]]
            )
            world = (R @ local.T).T + np.array([cx, cy])
            px = np.array([[self._world_to_pixel(p)] for p in world])
            warped = cv.transform(px, M)
            cv.fillConvexPoly(mask, np.round(warped).astype(np.int32), 1)
        return mask.astype(bool)

    def _stopline_mask(self, stoplines, M) -> np.ndarray:
        import cv2 as cv

        mask = np.zeros((self._width, self._width), np.uint8)
        for p0, p1 in stoplines:
            px = np.array([[self._world_to_pixel(p0)], [self._world_to_pixel(p1)]])
            warped = cv.transform(px, M)
            # Endpoints TRUNCATE toward zero, not round: the reference passes
            # raw float pixels to cv.line (chauffeurnet.py:309-321) and its
            # deployed opencv-python==4.2.0.32 (leaderboard/requirements.txt:3)
            # converted them through np.float32.__int__ — a C-style cast.
            # Reproduced quirk; see docs/PARITY.md.
            cv.line(
                mask,
                tuple(warped[0, 0].astype(int)),
                tuple(warped[1, 0].astype(int)),
                color=1,
                thickness=6,
            )
        return mask.astype(bool)

    @staticmethod
    def _scale_actors(actors: Sequence[Actor], scale: float) -> List[Actor]:
        out = []
        for center, yaw, (ex, ey) in actors:
            out.append((center, yaw, (max(ex * scale, 0.8), max(ey * scale, 0.8))))
        return out

    # ------------------------------------------------------------------ tick

    def tick(
        self,
        ev_loc_xy,
        ev_yaw_deg: float,
        ev_extent_xy: Tuple[float, float],
        vehicles: Sequence[Actor] = (),
        walkers: Sequence[Actor] = (),
        tl_green=(),
        tl_yellow=(),
        tl_red=(),
        stops: Sequence[Actor] = (),
        route_xy: Optional[np.ndarray] = None,
    ) -> Dict:
        """Render one frame; returns {"rendered" (W,W,3) u8, "masks"
        (3+3*len(history), W, W) u8, "collision_px" bool}."""
        import cv2 as cv

        if self._scale_bbox:
            vehicles = self._scale_actors(vehicles, 1.0)
            walkers = self._scale_actors(walkers, 2.0)
        self._history.append((list(vehicles), list(walkers), list(tl_green),
                              list(tl_yellow), list(tl_red), list(stops)))

        M = self._warp_transform(ev_loc_xy, ev_yaw_deg)
        w = self._width

        veh_m, wal_m, g_m, y_m, r_m, stop_m = [], [], [], [], [], []
        qsize = len(self._history)
        for idx in self._history_idx:
            idx = max(idx, -qsize)
            v, wk, g, y, r, st = self._history[idx]
            veh_m.append(self._actor_mask(v, M))
            wal_m.append(self._actor_mask(wk, M))
            g_m.append(self._stopline_mask(g, M))
            y_m.append(self._stopline_mask(y, M))
            r_m.append(self._stopline_mask(r, M))
            stop_m.append(self._actor_mask(st, M))

        road_mask = cv.warpAffine(self._road, M, (w, w)).astype(bool)
        lane_all = cv.warpAffine(self._lane_all, M, (w, w)).astype(bool)
        lane_broken = cv.warpAffine(self._lane_broken, M, (w, w)).astype(bool)

        route_mask = np.zeros((w, w), np.uint8)
        if route_xy is not None and len(route_xy) >= 2:
            pts = np.array([[self._world_to_pixel(p)] for p in route_xy[:80]])
            warped = cv.transform(pts, M)
            cv.polylines(route_mask, [np.round(warped).astype(np.int32)], False, 1,
                         thickness=16)
        route_mask = route_mask.astype(bool)

        ev_actor = ((float(ev_loc_xy[0]), float(ev_loc_xy[1])), ev_yaw_deg,
                    (float(ev_extent_xy[0]), float(ev_extent_xy[1])))
        ev_mask = self._actor_mask([ev_actor], M)
        ev_col = ((float(ev_loc_xy[0]), float(ev_loc_xy[1])), ev_yaw_deg,
                  (ev_extent_xy[0] * self._scale_mask_col,
                   ev_extent_xy[1] * self._scale_mask_col))
        ev_mask_col = self._actor_mask([ev_col], M)

        image = np.zeros((w, w, 3), np.uint8)
        image[road_mask] = COLOR_ALUMINIUM_5
        image[route_mask] = COLOR_ALUMINIUM_3
        image[lane_all] = COLOR_MAGENTA
        image[lane_broken] = COLOR_MAGENTA_2
        h_len = len(self._history_idx) - 1
        for i, m in enumerate(stop_m):
            image[m] = tint(COLOR_YELLOW_2, (h_len - i) * 0.2)
        for i, m in enumerate(g_m):
            image[m] = tint(COLOR_GREEN, (h_len - i) * 0.2)
        for i, m in enumerate(y_m):
            image[m] = tint(COLOR_YELLOW, (h_len - i) * 0.2)
        for i, m in enumerate(r_m):
            image[m] = tint(COLOR_RED, (h_len - i) * 0.2)
        for i, m in enumerate(veh_m):
            image[m] = tint(COLOR_BLUE, (h_len - i) * 0.2)
        for i, m in enumerate(wal_m):
            image[m] = tint(COLOR_CYAN, (h_len - i) * 0.2)
        image[ev_mask] = COLOR_WHITE

        c_road = road_mask.astype(np.uint8) * 255
        c_route = route_mask.astype(np.uint8) * 255
        c_lane = lane_all.astype(np.uint8) * 255
        c_lane[lane_broken] = 120
        c_tl = []
        for i in range(len(self._history_idx)):
            t = np.zeros((w, w), np.uint8)
            t[g_m[i]] = 80
            t[y_m[i]] = 170
            t[r_m[i]] = 255
            t[stop_m[i]] = 255
            c_tl.append(t)
        masks = np.stack(
            [c_road, c_route, c_lane]
            + [m.astype(np.uint8) * 255 for m in veh_m]
            + [m.astype(np.uint8) * 255 for m in wal_m]
            + c_tl,
            axis=0,
        )
        return {
            "rendered": image,
            "masks": masks,
            "collision_px": bool(np.any(ev_mask_col & wal_m[-1])),
        }
