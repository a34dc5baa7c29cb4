"""Batched 3-vector math on trailing-dim-3 arrays.

JAX-native equivalent of the reference's scalar `vec3` class
(/root/reference/vec3.hpp). Instead of a vec3 object graph we operate on
jnp arrays of shape [..., 3] so every op is a fused elementwise map under
XLA.
All functions are pure and differentiable.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Guard used by the reference's unit_vector (vec3.hpp:165-171).
_UNIT_EPS = 1e-8


def safe_sqrt(x):
    """sqrt whose gradient is 0 (not NaN/inf) where x <= 0.

    `sqrt(max(x, 0))` silently poisons backward passes: at x <= 0 the
    cotangent is `inf * 0 = NaN`, and `jnp.where` on the primal does not
    stop it. The double-where pattern keeps the primal identical and the
    adjoint finite — required for the inverse-rendering path (SURVEY §7/S7).
    """
    pos = x > 0.0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, x, 1.0)), 0.0)


def safe_arccos(x):
    """arccos with value clamped to [-1, 1] and pole gradients zeroed.

    d/dx arccos = -1/sqrt(1-x^2) explodes at |x| = 1 (sphere UV poles,
    normal-incidence cosines); the fallback branch is stop-gradiented so
    adjoints stay finite while primal values are exact.
    """
    inside = jnp.abs(x) < 1.0 - 1e-7
    main = jnp.arccos(jnp.where(inside, x, 0.0))
    fallback = jax.lax.stop_gradient(jnp.arccos(jnp.clip(x, -1.0, 1.0)))
    return jnp.where(inside, main, fallback)


def dot(u, v, keepdims: bool = False):
    """Batched dot product over the trailing axis (vec3.hpp:154-156)."""
    return jnp.sum(u * v, axis=-1, keepdims=keepdims)


def cross(u, v):
    """Batched cross product (vec3.hpp:158-162)."""
    return jnp.cross(u, v)


def length_squared(v, keepdims: bool = False):
    return jnp.sum(v * v, axis=-1, keepdims=keepdims)


def length(v, keepdims: bool = False):
    return safe_sqrt(length_squared(v, keepdims=keepdims))


def normalize(v):
    """Safe unit vector: returns 0 for (near-)zero input (vec3.hpp:165-171)."""
    len_ = length(v, keepdims=True)
    return jnp.where(len_ < _UNIT_EPS, 0.0, v / jnp.maximum(len_, _UNIT_EPS))


def near_zero(v):
    """True where all components are tiny (vec3.hpp near_zero, RTiOW semantics)."""
    return jnp.all(jnp.abs(v) < 1e-8, axis=-1)


def reflect(v, n):
    """Mirror reflection about normal n (vec3.hpp:204-206)."""
    return v - 2.0 * dot(v, n, keepdims=True) * n


def refract(uv, n, etai_over_etat):
    """Snell refraction; `uv` must be unit length (vec3.hpp:209-214).

    etai_over_etat broadcasts against the batch ([...] or [..., 1]).
    """
    if jnp.ndim(etai_over_etat) and etai_over_etat.shape[-1:] != (1,):
        etai_over_etat = etai_over_etat[..., None]
    cos_theta = jnp.minimum(dot(-uv, n, keepdims=True), 1.0)
    r_out_perp = etai_over_etat * (uv + cos_theta * n)
    # k <= 0 is total internal reflection: callers select the reflected ray
    # there (material.hpp:208-212), so the refracted value is unused — return
    # the grad-safe 0 instead of the reference's sqrt(|k|) garbage value.
    k = 1.0 - length_squared(r_out_perp, keepdims=True)
    return r_out_perp - safe_sqrt(k) * n


def luminance(c):
    """Rec.709 luminance (vec3.hpp:106-108)."""
    return c[..., 0] * 0.2126 + c[..., 1] * 0.7152 + c[..., 2] * 0.0722


def direction_from_spherical(elevation_deg, azimuth_deg):
    """Spherical (degrees) -> unit direction, y-up (common.hpp:94-103)."""
    phi = jnp.deg2rad(azimuth_deg)
    theta = jnp.deg2rad(90.0 - elevation_deg)
    sin_t = jnp.sin(theta)
    return jnp.stack(
        [sin_t * jnp.cos(phi), jnp.cos(theta), sin_t * jnp.sin(phi)], axis=-1
    )


def smoothstep(edge0, edge1, x):
    """Hermite smoothstep (common.hpp:87-91)."""
    t = jnp.clip((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)
