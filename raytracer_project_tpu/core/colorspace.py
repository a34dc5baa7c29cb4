"""Color-space transforms: ACES fit, gamma, NaN scrubbing.

JAX-native, differentiable versions of the reference's color helpers
(/root/reference/common.hpp:48-91). Operate on arrays of any shape
(typically [..., 3] linear RGB).
"""

from __future__ import annotations

import jax.numpy as jnp

GAMMA = 2.2


def scrub_non_finite(x, replace=0.0):
    """NaN/Inf -> `replace` (common.hpp:50-55 safeguard)."""
    return jnp.where(jnp.isfinite(x), x, replace)


def apply_aces(x):
    """Narkowicz ACES filmic fit with NaN killer (common.hpp:48-67)."""
    v = jnp.maximum(scrub_non_finite(x), 0.0)
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return (v * (a * v + b)) / (v * (c * v + d) + e)


def linear_to_gamma(x):
    """Linear -> gamma 2.2, clamping negatives to 0 (common.hpp:70-84)."""
    return jnp.where(x > 0.0, jnp.power(jnp.maximum(x, 1e-12), 1.0 / GAMMA), 0.0)


def gamma_to_linear(x):
    return jnp.where(x > 0.0, jnp.power(jnp.maximum(x, 1e-12), GAMMA), 0.0)


def to_srgb_u8(img):
    """Linear float image -> uint8 gamma-encoded pixels for PNG export.

    Matches the reference's export quantization (camera.hpp:771-777):
    clamp to [0,1], gamma 2.2, scale by 255.999.
    """
    g = linear_to_gamma(jnp.clip(scrub_non_finite(img), 0.0, 1.0))
    return jnp.clip(g * 255.999, 0.0, 255.0).astype(jnp.uint8)
