"""Shared constants (the port's own copy of the JAX package's
``utils/constants.py``; reference: misc/constant.py:4-20)."""

from enum import Enum

# BGR-ish plot palette used when painting sampled trajectories onto BEV images.
COLOR_LIST = [
    (13, 36, 250),
    (23, 129, 226),
    (166, 230, 185),
    (146, 15, 39),
    (207, 214, 108),
    (209, 69, 61),
    (181, 221, 146),
    (244, 41, 112),
    (154, 162, 254),
    (174, 6, 136),
]

# Meters per normalized trajectory unit: the BEV camera at z=50 m with fov 50
# degrees covers ~46.63 m, half-extent 23.315 m == half the 512 px image
# (reference: modeling/temporal.py:195).
MAGIC_NUM = 23.315

# Trajectory layout: horizon x [x, y, yaw, speed, throttle, steer, brake].
STATE_DIM = 4
ACTION_DIM = 3
ANCHOR_DIMS = 3  # dims zeroed at the first waypoint each step


class GuidanceType(Enum):
    NO_GUIDANCE = 0
    FREE_GUIDANCE = 1
    CLASSIFIER_GUIDANCE = 2
