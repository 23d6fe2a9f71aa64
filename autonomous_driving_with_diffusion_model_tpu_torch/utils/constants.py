"""Shared constants (the port's own copy of the JAX package's
``utils/constants.py``; reference: misc/constant.py:4-20)."""

from enum import Enum

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
