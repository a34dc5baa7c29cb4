"""Branchless material evaluation over ray wavefronts.

JAX-native replacement for the reference's virtual `material::scatter`
dispatch (/root/reference/material.hpp:24,74-108,129-151,192-224,255-258).
All material families are evaluated for every lane with shared random
draws, then the per-lane result is selected by the material type tag —
switch-free SIMD shading. A lane only ever *uses* one family's result, so
sharing one unit-sphere draw across families is statistically sound.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import rng, soa, vecmath
from ..core.constants import RAY_EPSILON
from ..models import materials as mat_mod
from ..models import textures as tex_mod
from ..models.scene import Scene
from .intersect import HitRecord

# Finite-difference step of the bump heightfield (material.hpp:40-41).
_BUMP_DELTA = 1.0 / 1024.0


def _mat_fetch(scene: Scene, mat_ids):
    """One wide-row gather of all material columns: the material table
    packed into one [M, 8] f32 matrix makes the lookup a single gather.
    Returns (mtype i32[N], albedo f32[N,3], param f32[N], texture_id
    i32[N], bump_id i32[N], bump_strength f32[N]).
    """
    m = scene.materials
    packed = jnp.concatenate(
        [m.albedo, m.param[:, None], m.mtype.astype(jnp.float32)[:, None],
         m.texture_id.astype(jnp.float32)[:, None],
         m.bump_id.astype(jnp.float32)[:, None],
         m.bump_strength[:, None]], axis=1,
    )[mat_ids]
    return (packed[:, 4].astype(jnp.int32), packed[:, 0:3], packed[:, 3],
            packed[:, 5].astype(jnp.int32), packed[:, 6].astype(jnp.int32),
            packed[:, 7])


def _mat_fetch_soa(scene: Scene, mat_ids):
    """SoA twin of _mat_fetch: per-component 1-D gathers from the
    loop-invariant material columns.
    Returns (mtype i32[N], albedo (r, g, b) tuple, param f32[N],
    texture_id i32[N], bump_id i32[N], bump_strength f32[N]).
    """
    m = scene.materials
    f32 = jnp.float32
    cols = (m.albedo[:, 0], m.albedo[:, 1], m.albedo[:, 2], m.param,
            m.mtype.astype(f32), m.texture_id.astype(f32),
            m.bump_id.astype(f32), m.bump_strength)
    g = tuple(jnp.asarray(c, f32)[mat_ids] for c in cols)
    return (g[4].astype(jnp.int32), (g[0], g[1], g[2]), g[3],
            g[5].astype(jnp.int32), g[6].astype(jnp.int32), g[7])


class Scatter(NamedTuple):
    """Result of one shading event (all [N])."""

    origin: jax.Array       # f32[N,3] respawn origin (epsilon-offset)
    direction: jax.Array    # f32[N,3] next ray direction
    attenuation: jax.Array  # f32[N,3]
    emitted: jax.Array      # f32[N,3] radiance emitted at this hit
    scattered: jax.Array    # bool[N] False = path terminates here (absorb/light)


def bumped_normal(scene: Scene, rec: HitRecord, bump_id, strength):
    """Tangent-space heightfield bump (material.hpp:35-54): finite-difference
    taps at (u,v)/(u+du,v)/(u,v+dv); N' = normalize(N - f_u*T - f_v*B).

    The three nearest-neighbor height taps collapse into one precomputed
    neighbor-delta gather (see textures.sample_bump_deltas) — same values,
    a third of the texture traffic.
    """
    du, dv = tex_mod.sample_bump_deltas(
        scene.textures, bump_id, rec.u, rec.v, _BUMP_DELTA
    )
    f_u = du * strength
    f_v = dv * strength
    has_bump = bump_id >= 0
    n = rec.normal - f_u[:, None] * rec.tangent - f_v[:, None] * rec.bitangent
    n = vecmath.normalize(n)
    return jnp.where(has_bump[:, None], n, rec.normal)


def get_albedo(scene: Scene, rec: HitRecord):
    """Denoiser/AOV albedo (material.hpp:29,99-102,154-156,226-229,266-275):
    lambertian/metal -> texture color; dielectric -> white; emissive ->
    emission clamped to <= 1; isotropic -> its albedo texture."""
    mtype, solid, _, texture_id, _, _ = _mat_fetch(scene, rec.mat)
    tex = tex_mod.sample(scene.textures, texture_id, rec.u, rec.v, rec.p, solid)
    albedo = tex
    albedo = jnp.where((mtype == mat_mod.DIELECTRIC)[:, None], 1.0, albedo)
    albedo = jnp.where(
        (mtype == mat_mod.EMISSIVE)[:, None], jnp.minimum(tex, 1.0), albedo
    )
    # Isotropic phase material keeps the base-class black albedo
    # (isovolumetric doesn't override get_albedo, constant_medium.hpp:9-22).
    albedo = jnp.where((mtype == mat_mod.ISOTROPIC)[:, None], 0.0, albedo)
    return albedo


def get_albedo_soa(scene: Scene, rec):
    """SoA twin of get_albedo: rec is a HitRecordSoa, returns (r, g, b)."""
    mtype, solid3, _, texture_id, _, _ = _mat_fetch_soa(scene, rec.mat)
    tex3 = tex_mod.sample_soa(
        scene.textures, texture_id, rec.u, rec.v, rec.p, solid3
    )
    one = jnp.ones_like(tex3[0])
    albedo = soa.where(mtype == mat_mod.DIELECTRIC, (one, one, one), tex3)
    albedo = soa.where(mtype == mat_mod.EMISSIVE,
                       tuple(jnp.minimum(c, 1.0) for c in tex3), albedo)
    zero = jnp.zeros_like(one)
    return soa.where(mtype == mat_mod.ISOTROPIC, (zero, zero, zero), albedo)


class ScatterSoa(NamedTuple):
    """SoA twin of Scatter: vector fields are (x, y, z) tuples of [N]."""

    origin: tuple
    direction: tuple
    attenuation: tuple
    emitted: tuple
    scattered: jax.Array


def scatter_soa(scene: Scene, rec, in_dir, lr: rng.LaneRng) -> ScatterSoa:
    """SoA twin of scatter for the pooled-wavefront hot loop.

    rec is a HitRecordSoa; in_dir a component tuple. Same material math and
    identical random draws as scatter (the AoS oracle above); vectors stay
    component tuples so no [N, 3] arrays materialize (core/soa.py).
    Parity vs scatter is asserted in tests/test_shade.py.
    """
    mtype, solid3, param, texture_id, bump_id, bump_strength = _mat_fetch_soa(
        scene, rec.mat
    )
    tex3 = tex_mod.sample_soa(
        scene.textures, texture_id, rec.u, rec.v, rec.p, solid3
    )

    sphere_draw, choice_u = rng.draw_unit_vector_and_uniform_soa(
        lr, rng.STREAM_SCATTER
    )

    # Bump (material.hpp:35-54): N' = normalize(N - f_u T - f_v B).
    du, dv = tex_mod.sample_bump_deltas(
        scene.textures, bump_id, rec.u, rec.v, _BUMP_DELTA
    )
    f_u = du * bump_strength
    f_v = dv * bump_strength
    n_b = tuple(rec.normal[k] - f_u * rec.tangent[k] - f_v * rec.bitangent[k]
                for k in range(3))
    working_n = soa.where(bump_id >= 0, soa.normalize(n_b), rec.normal)
    unit_in = soa.normalize(in_dir)

    # --- lambertian (material.hpp:74-96) ---
    lam_dir = soa.add(working_n, sphere_draw)
    lam_dir = soa.where(soa.near_zero(lam_dir), working_n, lam_dir)
    eps_origin = soa.axpy(RAY_EPSILON, rec.normal, rec.p)

    # --- metal (material.hpp:129-151) ---
    reflected = soa.reflect(unit_in, working_n)
    metal_dir = soa.normalize(soa.axpy(param, sphere_draw, reflected))
    metal_ok = soa.dot(metal_dir, rec.normal) > 0.0

    # --- dielectric (material.hpp:192-224, Schlick :237-241) ---
    ri = jnp.where(rec.front_face, 1.0 / jnp.maximum(param, 1e-6), param)
    cos_theta = jnp.minimum(soa.dot(soa.neg(unit_in), working_n), 1.0)
    sin_theta = vecmath.safe_sqrt(1.0 - cos_theta * cos_theta)
    cannot_refract = ri * sin_theta > 1.0
    r0 = ((1.0 - ri) / (1.0 + ri)) ** 2
    reflect_prob = r0 + (1.0 - r0) * (1.0 - cos_theta) ** 5
    do_reflect = cannot_refract | (reflect_prob > choice_u)
    refracted = soa.refract(unit_in, working_n, ri)
    diel_dir = soa.where(do_reflect, reflected, refracted)
    offset_out = soa.dot(diel_dir, rec.normal) > 0.0
    diel_origin = soa.axpy(
        jnp.where(offset_out, RAY_EPSILON, -RAY_EPSILON), rec.normal, rec.p
    )

    # --- select by type tag ---
    is_lam = mtype == mat_mod.LAMBERTIAN
    is_metal = mtype == mat_mod.METAL
    is_diel = mtype == mat_mod.DIELECTRIC
    is_iso = mtype == mat_mod.ISOTROPIC

    direction = soa.where(is_lam, lam_dir,
                soa.where(is_metal, metal_dir,
                soa.where(is_diel, diel_dir, sphere_draw)))
    origin = soa.where(is_lam | is_metal, eps_origin,
             soa.where(is_diel, diel_origin, rec.p))

    attenuation = soa.where(is_diel, solid3, tex3)
    scattered = is_lam | (is_metal & metal_ok) | is_diel | is_iso
    zero = jnp.zeros_like(tex3[0])
    z3 = (zero, zero, zero)
    emitted = soa.where(mtype == mat_mod.EMISSIVE, tex3, z3)

    return ScatterSoa(origin=origin, direction=direction,
                      attenuation=attenuation, emitted=emitted,
                      scattered=scattered)


def scatter(scene: Scene, rec: HitRecord, in_dir, keys) -> Scatter:
    """One shading event for every lane; branchless over material types.

    in_dir f32[N,3] incoming ray direction (not necessarily unit).
    keys: a core.rng.LaneRng (hot path — one counter-hash per lane) or legacy
    per-lane threefry keys [N, 2] — randomness depends only on the lane's
    own identity so shading is shard-invariant and replayable.
    """
    mtype, solid, param, texture_id, bump_id, bump_strength = _mat_fetch(
        scene, rec.mat
    )
    tex_color = tex_mod.sample(
        scene.textures, texture_id, rec.u, rec.v, rec.p, solid
    )

    if isinstance(keys, rng.LaneRng):
        # shared unit-sphere draw + dielectric reflect probability
        sphere_draw, choice_u = rng.draw_unit_vector_and_uniform(
            keys, rng.STREAM_SCATTER
        )
    else:
        k_sphere, k_choice = rng.split_each(keys, 2)
        sphere_draw = rng.unit_vector_each(k_sphere)
        choice_u = rng.uniform_each(k_choice)

    working_n = bumped_normal(scene, rec, bump_id, bump_strength)
    unit_in = vecmath.normalize(in_dir)

    # --- lambertian (material.hpp:74-96) ---
    lam_dir = working_n + sphere_draw
    lam_dir = jnp.where(vecmath.near_zero(lam_dir)[:, None], working_n, lam_dir)
    lam_origin = rec.p + rec.normal * RAY_EPSILON

    # --- metal (material.hpp:129-151) ---
    reflected = vecmath.reflect(unit_in, working_n)
    metal_dir = vecmath.normalize(reflected + param[:, None] * sphere_draw)
    metal_ok = vecmath.dot(metal_dir, rec.normal) > 0.0
    metal_origin = rec.p + rec.normal * RAY_EPSILON

    # --- dielectric (material.hpp:192-224, Schlick :237-241) ---
    ri = jnp.where(rec.front_face, 1.0 / jnp.maximum(param, 1e-6), param)
    cos_theta = jnp.minimum(vecmath.dot(-unit_in, working_n), 1.0)
    sin_theta = vecmath.safe_sqrt(1.0 - cos_theta * cos_theta)
    cannot_refract = ri * sin_theta > 1.0
    r0 = ((1.0 - ri) / (1.0 + ri)) ** 2
    reflect_prob = r0 + (1.0 - r0) * (1.0 - cos_theta) ** 5
    do_reflect = cannot_refract | (reflect_prob > choice_u)
    refracted = vecmath.refract(unit_in, working_n, ri)
    diel_dir = jnp.where(do_reflect[:, None],
                         vecmath.reflect(unit_in, working_n), refracted)
    offset_out = vecmath.dot(diel_dir, rec.normal) > 0.0
    diel_origin = rec.p + jnp.where(offset_out[:, None], RAY_EPSILON, -RAY_EPSILON) * rec.normal

    # --- isotropic volume phase (constant_medium.hpp:9-22) ---
    iso_dir = sphere_draw
    iso_origin = rec.p

    # --- select by type tag ---
    is_lam = (mtype == mat_mod.LAMBERTIAN)[:, None]
    is_metal = (mtype == mat_mod.METAL)[:, None]
    is_diel = (mtype == mat_mod.DIELECTRIC)[:, None]
    is_iso = (mtype == mat_mod.ISOTROPIC)[:, None]

    direction = jnp.where(is_lam, lam_dir,
                jnp.where(is_metal, metal_dir,
                jnp.where(is_diel, diel_dir, iso_dir)))
    origin = jnp.where(is_lam, lam_origin,
             jnp.where(is_metal, metal_origin,
             jnp.where(is_diel, diel_origin, iso_origin)))

    # Attenuation: texture albedo for lambertian/metal/isotropic; solid for
    # dielectric (material.hpp:193 — dielectric albedo is untextured).
    attenuation = jnp.where(is_diel, solid, tex_color)

    scattered = (
        (mtype == mat_mod.LAMBERTIAN)
        | ((mtype == mat_mod.METAL) & metal_ok)
        | (mtype == mat_mod.DIELECTRIC)
        | (mtype == mat_mod.ISOTROPIC)
    )

    # Emission: diffuse_light returns its (possibly textured) radiance
    # (material.hpp:261-263); all other families emit black.
    emitted = jnp.where((mtype == mat_mod.EMISSIVE)[:, None], tex_color, 0.0)

    return Scatter(
        origin=origin,
        direction=direction,
        attenuation=attenuation,
        emitted=emitted,
        scattered=scattered,
    )
