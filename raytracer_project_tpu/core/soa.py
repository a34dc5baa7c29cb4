"""SoA 3-vector helpers: vectors as (x, y, z) tuples of [N] arrays.

Why this exists: a rank-2 [N, 3] array has two possible layouts, and a
compiler can switch between them across fusion boundaries (transposes that
do no useful work). Plain [N] component arrays have exactly one layout,
and every vector op becomes plain elementwise arithmetic (a dot product is
two fma's, not a cross-lane reduce).

The hot wavefront loop (ops/wavefront.py) and everything it calls
(shade, environment, camera ray-gen, hit records) runs on these triples;
[N, 3] arrays appear only at module boundaries (accumulator buffers,
public API) via `pack`/`unpack`.

Reference semantics match core/vecmath.py one-for-one (vec3.hpp:7-213).
"""

from __future__ import annotations

import jax.numpy as jnp

# A "v3" is a plain tuple (x, y, z) of same-shaped f32 arrays (or python
# scalars — broadcasting works componentwise).


def unpack(a):
    """[..., 3] array -> (x, y, z) tuple."""
    return a[..., 0], a[..., 1], a[..., 2]


def pack(v):
    """(x, y, z) -> [..., 3] array (boundary use only — materializes)."""
    return jnp.stack(jnp.broadcast_arrays(*v), axis=-1)


def splat(c):
    """Constant 3-vector (tuple/list/np array) -> v3 of python floats."""
    return float(c[0]), float(c[1]), float(c[2])


def add(a, b):
    return a[0] + b[0], a[1] + b[1], a[2] + b[2]


def sub(a, b):
    return a[0] - b[0], a[1] - b[1], a[2] - b[2]


def mul(a, b):
    """Componentwise (Hadamard) product."""
    return a[0] * b[0], a[1] * b[1], a[2] * b[2]


def scale(a, s):
    """Scalar (array or python number) times vector."""
    return a[0] * s, a[1] * s, a[2] * s


def neg(a):
    return -a[0], -a[1], -a[2]


def axpy(s, a, b):
    """s * a + b."""
    return s * a[0] + b[0], s * a[1] + b[1], s * a[2] + b[2]


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def length_squared(a):
    return dot(a, a)


def length(a):
    return jnp.sqrt(length_squared(a))


_UNIT_EPS = 1e-12


def normalize(a):
    """Safe unit vector: 0 for (near-)zero input (vec3.hpp:165-171)."""
    l2 = length_squared(a)
    inv = jnp.where(l2 < _UNIT_EPS * _UNIT_EPS, 0.0,
                    1.0 / jnp.sqrt(jnp.maximum(l2, _UNIT_EPS * _UNIT_EPS)))
    return scale(a, inv)


def near_zero(a, eps=1e-8):
    """True where all components are tiny (vec3.hpp near_zero)."""
    return (jnp.abs(a[0]) < eps) & (jnp.abs(a[1]) < eps) & (jnp.abs(a[2]) < eps)


def reflect(v, n):
    """v - 2 (v.n) n (vec3.hpp:204-206)."""
    d = 2.0 * dot(v, n)
    return v[0] - d * n[0], v[1] - d * n[1], v[2] - d * n[2]


def refract(uv, n, etai_over_etat):
    """Snell refraction of unit uv about n (vec3.hpp:209-213)."""
    cos_theta = jnp.minimum(dot(neg(uv), n), 1.0)
    perp = scale(add(uv, scale(n, cos_theta)), etai_over_etat)
    par_len = -jnp.sqrt(jnp.abs(1.0 - length_squared(perp)))
    return add(perp, scale(n, par_len))


def where(m, a, b):
    """Componentwise select by a scalar mask [N]."""
    return (jnp.where(m, a[0], b[0]), jnp.where(m, a[1], b[1]),
            jnp.where(m, a[2], b[2]))


def luminance(c):
    """Rec.709 luma (vec3.hpp:106-110)."""
    return 0.2126 * c[0] + 0.7152 * c[1] + 0.0722 * c[2]
