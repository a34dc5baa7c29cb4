"""Homogeneous participating media (constant-density fog volumes).

JAX-native re-expression of the reference's `constant_medium`
(/root/reference/constant_medium.hpp:24-87): find the ray's [entry, exit]
span inside the boundary, clamp it against the closest surface hit, draw an
exponential free-flight distance `-1/density * log(u)`, and scatter
isotropically if the flight ends inside the span.

Instead of a polymorphic hittable wrapper, volumes live in their own SoA
table (sphere or axis-aligned-box boundaries — the only shapes the
reference ever wraps) and are sampled *after* the surface closest-hit, with
per-lane counter-based RNG. The phase function is an ISOTROPIC material row
(constant_medium.hpp:9-22), so shading needs no special casing.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import rng, vecmath
from ..core.constants import T_MAX
from .intersect import Hit, HitRecord

VOL_SPHERE = 0
VOL_BOX = 1


class VolumeTable(NamedTuple):
    """V fog volumes (a pytree).

    kind            i32[V]   VOL_SPHERE / VOL_BOX
    center          f32[V,3] sphere center (box: unused)
    radius          f32[V]   sphere radius
    box_min/box_max f32[V,3] AABB boundary (sphere: unused)
    neg_inv_density f32[V]   -1/density (constant_medium.hpp:29)
    mat             i32[V]   ISOTROPIC material row (phase function + albedo)
    """

    kind: jax.Array
    center: jax.Array
    radius: jax.Array
    box_min: jax.Array
    box_max: jax.Array
    neg_inv_density: jax.Array
    mat: jax.Array

    @property
    def count(self) -> int:
        return self.kind.shape[0]


def _boundary_span(vol: VolumeTable, v: int, o, d):
    """Unclamped [entry, exit] of every ray with volume v's boundary over
    t in (-inf, inf) (constant_medium.hpp:42-47 uses interval::universe).

    Returns (entry [N], exit [N], hit [N])."""
    kind = vol.kind[v]

    # Sphere span.
    oc = vol.center[v] - o
    a = vecmath.length_squared(d)
    h = vecmath.dot(d, oc)
    c = vecmath.length_squared(oc) - vol.radius[v] ** 2
    disc = h * h - a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    s_entry = (h - sq) / a
    s_exit = (h + sq) / a
    s_hit = (disc > 0.0) & (vol.radius[v] > 0.0)

    # Box slab span.
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-20,
                            jnp.where(d < 0, -1e-20, 1e-20), d)
    t0 = (vol.box_min[v] - o) * inv_d
    t1 = (vol.box_max[v] - o) * inv_d
    b_entry = jnp.max(jnp.minimum(t0, t1), axis=-1)
    b_exit = jnp.min(jnp.maximum(t0, t1), axis=-1)
    b_hit = b_entry < b_exit

    is_sphere = kind == VOL_SPHERE
    entry = jnp.where(is_sphere, s_entry, b_entry)
    exit_ = jnp.where(is_sphere, s_exit, b_exit)
    return entry, exit_, jnp.where(is_sphere, s_hit, b_hit)


def sample_interaction(volumes: VolumeTable, o, d, tmin, surface: Hit,
                       keys) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Stochastic volume-scatter test against every volume.

    keys [N,2] per-lane. Returns (t [N], mat [N], is_volume [N]): where
    is_volume, a scatter event at t (before any surface hit) in material
    `mat`; elsewhere t/mat are the untouched surface values.
    Matches constant_medium.hpp:39-77 in law.
    """
    n = o.shape[0]
    best_t = jnp.where(surface.hit, surface.t, T_MAX)
    best_mat = jnp.zeros((n,), jnp.int32)
    is_volume = jnp.zeros((n,), bool)
    ray_len = vecmath.length(d)

    for v in range(volumes.count):
        entry, exit_, bhit = _boundary_span(volumes, v, o, d)
        e = jnp.maximum(entry, tmin)
        x = jnp.minimum(exit_, best_t)
        valid = bhit & (e < x)

        if isinstance(keys, rng.LaneRng):
            u = rng.draw_uniform(keys, rng.STREAM_VOLUME, salt=v + 1)
        else:
            u = rng.uniform_each(rng.fold_each(keys, v + 1))
        # log(u) with u in [0,1): guard u=0 (log -> -inf is harmless but
        # keep it finite).
        flight = volumes.neg_inv_density[v] * jnp.log(jnp.maximum(u, 1e-38))
        dist_inside = (x - e) * ray_len
        scatters = valid & (flight <= dist_inside)

        t_v = e + flight / jnp.maximum(ray_len, 1e-20)
        take = scatters & (t_v < best_t)
        best_t = jnp.where(take, t_v, best_t)
        best_mat = jnp.where(take, volumes.mat[v], best_mat)
        is_volume = is_volume | take

    return best_t, best_mat, is_volume


def apply_to_record(volumes: VolumeTable, o, d, surface_hit: Hit,
                    rec: HitRecord, keys) -> HitRecord:
    """Overlay volume interactions onto the surface hit record.

    Volume hits get p at the scatter point, the reference's arbitrary
    normal (1,0,0)/front_face=True (constant_medium.hpp:72-73), and the
    volume's ISOTROPIC material."""
    if volumes is None or volumes.count == 0:
        return rec
    t, mat, is_vol = sample_interaction(
        volumes, o, d, jnp.broadcast_to(jnp.asarray(1e-3, jnp.float32), rec.t.shape),
        surface_hit, keys,
    )
    p = o + t[:, None] * d
    vb = is_vol[:, None]
    arbitrary_n = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), rec.normal.shape)
    return HitRecord(
        t=jnp.where(is_vol, t, rec.t),
        p=jnp.where(vb, p, rec.p),
        normal=jnp.where(vb, arbitrary_n, rec.normal),
        tangent=jnp.where(vb, 0.0, rec.tangent),
        bitangent=jnp.where(vb, 0.0, rec.bitangent),
        front_face=jnp.where(is_vol, True, rec.front_face),
        u=jnp.where(is_vol, 0.0, rec.u),
        v=jnp.where(is_vol, 0.0, rec.v),
        mat=jnp.where(is_vol, mat, rec.mat),
        hit=rec.hit | is_vol,
    )
