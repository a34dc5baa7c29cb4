"""Core numeric constants.

JAX-native re-expression of the reference engine's global constants
(see /root/reference/common.hpp:14-16). Everything is float32 — the
accelerator's fast precision — instead of the reference's double.
"""

import numpy as np

PI = float(np.pi)
INFINITY = float(np.inf)

# Self-intersection offset applied when respawning scattered rays
# (reference: common.hpp:16 `ray_epsilon = 0.0001`).
RAY_EPSILON = 1e-4

# Minimum hit distance for primary/secondary rays
# (reference: camera.hpp:355 `tmin = 0.001`).
T_MIN = 1e-3

# Large-but-finite stand-in for +inf ray extents; keeps arithmetic finite.
T_MAX = 1e30

# Weak-ray early-out threshold (reference: camera.hpp:968 `< 0.0001`).
WEAK_RAY_EPS = 1e-4

# Russian roulette starts strictly after this bounce index
# (reference: camera.hpp:976 `if (i > 10)`).
RR_START_BOUNCE = 10
RR_P_MIN = 0.05
RR_P_MAX = 0.95

# Default z-depth normalization distance (reference: camera.hpp:59 z_depth_max_dist).
Z_DEPTH_MAX_DIST = 50.0


def degrees_to_radians(deg):
    return deg * PI / 180.0


def radians_to_degrees(rad):
    return rad * 180.0 / PI
