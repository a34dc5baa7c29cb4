"""Ray-primitive intersection: branchless, batched, memory-bounded.

Equivalents of the reference's per-ray virtual hit() calls:
  sphere   /root/reference/sphere.hpp:18-64
  triangle /root/reference/triangle.hpp:17-82 (area method; here
           Möller-Trumbore, algebraically equivalent, two-sided)
  brute-force closest-hit loop /root/reference/hittable_list.hpp:28-41

The brute-force path (`intersect_brute`) scans primitives in fixed-size
chunks with a running closest-hit so memory stays O(N_rays * CHUNK). It is
the production route below BVH_MIN_PRIMS and the oracle for BVH property
tests.

Every contraction here is written as an elementwise sum over the three
vector components: a float32 dot or einsum at default precision may run
in TF32 on a GPU, whose ~10 mantissa bits flip hit decisions near t_min.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import soa, vecmath
from ..core.constants import PI, T_MAX
from ..models.geometry import PRIM_BOX, PRIM_SPHERE, PRIM_TRIANGLE
from ..models.scene import Scene

# Primitive chunk width for the brute-force scan.
CHUNK = 128


class Hit(NamedTuple):
    """Closest-hit result for a ray batch (all [N])."""

    t: jax.Array          # f32 hit distance (T_MAX when miss)
    prim_type: jax.Array  # i32 PRIM_SPHERE / PRIM_TRIANGLE
    prim_idx: jax.Array   # i32 row in the per-type table
    hit: jax.Array        # bool


class HitRecord(NamedTuple):
    """Full shading record, gathered after the closest hit is known.

    Mirrors hit_record (/root/reference/hittable.hpp:9-26) in SoA form.
    """

    t: jax.Array           # f32[N]
    p: jax.Array           # f32[N,3]
    normal: jax.Array      # f32[N,3] front-face corrected
    tangent: jax.Array     # f32[N,3]
    bitangent: jax.Array   # f32[N,3]
    front_face: jax.Array  # bool[N]
    u: jax.Array           # f32[N]
    v: jax.Array           # f32[N]
    mat: jax.Array         # i32[N]
    hit: jax.Array         # bool[N]


# ---------------------------------------------------------------------------
# Primitive tests (candidate t for a [N, C] ray-x-prim block)
# ---------------------------------------------------------------------------

def sphere_candidate_t(center, radius, o, d, tmin, tmax):
    """Nearest valid root of the sphere quadratic (sphere.hpp:18-39).

    center f32[C,3], radius f32[C]; o, d f32[N,3]; returns t f32[N,C]
    (T_MAX where invalid).
    """
    oc = center[None, :, :] - o[:, None, :]           # [N,C,3]
    a = vecmath.length_squared(d)[:, None]            # [N,1]
    h = jnp.sum(oc * d[:, None, :], axis=-1)          # [N,C]
    c = jnp.sum(oc * oc, axis=-1) - (radius * radius)[None, :]
    disc = h * h - a * c
    sq = vecmath.safe_sqrt(disc)  # grad-safe at miss lanes (disc <= 0)
    inv_a = 1.0 / a
    root0 = (h - sq) * inv_a
    root1 = (h + sq) * inv_a
    ok0 = (root0 > tmin[:, None]) & (root0 < tmax[:, None])
    ok1 = (root1 > tmin[:, None]) & (root1 < tmax[:, None])
    root = jnp.where(ok0, root0, root1)
    valid = (disc >= 0.0) & (ok0 | ok1) & (radius[None, :] > 0.0)
    return jnp.where(valid, root, T_MAX)


def box_candidate_t(minv, trans, o, d, tmin, tmax):
    """Affine-slab box test against the canonical [-1,1]^3 cube
    (cube.hpp:44-86 in the box's local frame).

    minv f32[C,9] (world->local linear part, row-major), trans f32[C,3];
    o, d f32[N,3]; returns t f32[N,C] (T_MAX where invalid). Two-sided:
    entering hit at slab t_near when t_near > tmin, else the exit hit
    (matching the triangle-tessellated box, which reports the true exit
    intersection for interior origins — see models/geometry.py docstring).
    """
    m = minv.reshape(-1, 3, 3)                               # [C,3,3]
    o_l = rows_dot(m[None], o[:, None, None, :]) + trans[None]   # [N,C,3]
    d_l = rows_dot(m[None], d[:, None, None, :])                 # [N,C,3]
    # Safe inverse: ~zero components get a huge positive inverse; the slab
    # arithmetic then resolves the parallel-ray cases correctly (inside the
    # slab -> +-huge bracket, outside -> empty interval).
    inv = 1.0 / jnp.where(jnp.abs(d_l) < 1e-30, 1e-30, d_l)
    t0 = (-1.0 - o_l) * inv
    t1 = (1.0 - o_l) * inv
    t_near = jnp.max(jnp.minimum(t0, t1), axis=-1)           # [N,C]
    t_far = jnp.min(jnp.maximum(t0, t1), axis=-1)
    t = jnp.where(t_near > tmin[:, None], t_near, t_far)
    valid = (t_near < t_far) & (t > tmin[:, None]) & (t < tmax[:, None])
    return jnp.where(valid, t, T_MAX)


def rows_dot(m, v):
    """sum_j m[..., i, j] * v[..., j] as three f32 multiply-adds (no
    contraction, so no reduced-precision matrix unit; see module doc)."""
    return m[..., 0] * v[..., 0] + m[..., 1] * v[..., 1] + m[..., 2] * v[..., 2]


def triangle_candidate_t(v0, e1, e2, o, d, tmin, tmax):
    """Möller-Trumbore, two-sided (same hit set as triangle.hpp:17-82).

    v0/e1/e2 f32[C,3]; o, d f32[N,3]; returns t f32[N,C] (T_MAX invalid).
    """
    d_b = d[:, None, :]                                # [N,1,3]
    pvec = jnp.cross(d_b, e2[None, :, :])              # [N,C,3]
    det = jnp.sum(e1[None, :, :] * pvec, axis=-1)      # [N,C]
    # Degenerate/parallel guard (triangle.hpp:25,34).
    near_zero = jnp.abs(det) < 1e-12
    inv_det = 1.0 / jnp.where(near_zero, 1.0, det)
    tvec = o[:, None, :] - v0[None, :, :]              # [N,C,3]
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1[None, :, :])
    v = jnp.sum(d_b * qvec, axis=-1) * inv_det
    t = jnp.sum(e2[None, :, :] * qvec, axis=-1) * inv_det
    valid = (
        ~near_zero
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > tmin[:, None])
        & (t < tmax[:, None])
    )
    return jnp.where(valid, t, T_MAX)


# ---------------------------------------------------------------------------
# Brute-force closest hit (the oracle)
# ---------------------------------------------------------------------------

def _pad_rows(x, n):
    pad = n - x.shape[0]
    if pad <= 0:
        return x
    cfg = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, cfg)


def _scan_chunks(candidate_fn, table_cols, n_rows, o, d, tmin, best_t, best_idx):
    """Running closest-hit over primitive chunks via lax.scan."""
    n_chunks = -(-n_rows // CHUNK)
    padded = n_chunks * CHUNK
    cols = [_pad_rows(c, padded) for c in table_cols]
    chunked = [c.reshape((n_chunks, CHUNK) + c.shape[1:]) for c in cols]
    base_ids = jnp.arange(CHUNK, dtype=jnp.int32)
    row_valid_template = jnp.arange(CHUNK)

    def body(carry, chunk):
        best_t, best_idx = carry
        cols_c, chunk_i = chunk
        t = candidate_fn(*cols_c, o, d, tmin, best_t)
        # Mask padding rows.
        rows = chunk_i * CHUNK + row_valid_template
        t = jnp.where((rows < n_rows)[None, :], t, T_MAX)
        cmin = jnp.min(t, axis=1)
        carg = jnp.argmin(t, axis=1).astype(jnp.int32)
        better = cmin < best_t
        best_t = jnp.where(better, cmin, best_t)
        best_idx = jnp.where(better, chunk_i * CHUNK + carg, best_idx)
        return (best_t, best_idx), None

    (best_t, best_idx), _ = jax.lax.scan(
        body,
        (best_t, best_idx),
        (tuple(chunked), jnp.arange(n_chunks, dtype=jnp.int32)),
    )
    return best_t, best_idx


def intersect_brute(scene: Scene, o, d, tmin, tmax=None) -> Hit:
    """Closest hit over all primitives, linear scan (hittable_list.hpp:28-41).

    o, d f32[N,3]; tmin f32[N] or scalar. Returns Hit of [N] columns.
    """
    n = o.shape[0]
    tmin = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (n,))
    init_t = jnp.full((n,), T_MAX if tmax is None else tmax, jnp.float32)
    init_idx = jnp.zeros((n,), jnp.int32)

    sph = scene.spheres
    s_t, s_idx = _scan_chunks(
        sphere_candidate_t, [sph.center, sph.radius], sph.count,
        o, d, tmin, init_t, init_idx,
    )
    tri = scene.triangles
    t_t, t_idx = _scan_chunks(
        triangle_candidate_t, [tri.v0, tri.e1, tri.e2], tri.count,
        o, d, tmin, s_t, s_idx,
    )
    # After the second scan, best_t <= s_t; triangle wins where it improved.
    tri_won = t_t < s_t
    ptype = jnp.where(tri_won, PRIM_TRIANGLE, PRIM_SPHERE).astype(jnp.int32)
    b_t, b_idx = t_t, t_idx
    if scene.boxes is not None:
        box = scene.boxes
        b_t, b_idx = _scan_chunks(
            box_candidate_t, [box.minv, box.trans], box.count,
            o, d, tmin, t_t, t_idx,
        )
        box_won = b_t < t_t
        ptype = jnp.where(box_won, PRIM_BOX, ptype)
        t_idx = jnp.where(box_won, b_idx, t_idx)
    return Hit(
        t=b_t,
        prim_type=ptype,
        prim_idx=t_idx,
        hit=b_t < T_MAX,
    )


# At and above this primitive count (with a BVH built) the threaded BVH
# walk replaces the brute-force scan. Measured on one H200 (700 W) with
# tools/bench_routes.py, 262,144 camera + bounce rays: the scan wins at
# 1,454 (5.0 vs 28.3 ms), 25,091 (51.7 vs 86.0 ms) and 50,179 primitives
# (105 vs 140 ms), the BVH at 100,355 (190 vs 210 ms); the interpolated
# crossover is ~85k, rounded down.
BVH_MIN_PRIMS = 80_000


def intersect_dispatch(scene: Scene) -> str:
    """The single closest-hit routing decision, shared by the chunked and
    pooled paths so they can never pick different intersectors: "bvh" |
    "brute". It reads only the primitive count and whether a BVH exists."""
    if scene.bvh is not None and scene.primitive_count >= BVH_MIN_PRIMS:
        return "bvh"
    return "brute"


def intersect(scene: Scene, o, d, tmin) -> Hit:
    """Closest hit through the route intersect_dispatch picks."""
    if intersect_dispatch(scene) == "bvh":
        from . import traverse

        return traverse.intersect_bvh(scene, o, d, tmin)
    return intersect_brute(scene, o, d, tmin)


# ---------------------------------------------------------------------------
# Detached-traversal differentiable intersection (SURVEY §7/S7)
# ---------------------------------------------------------------------------

# The closest-hit *search* (which primitive wins, hit vs miss) is discrete —
# its argmin/while-loop structure has no useful derivative and blocks
# reverse-mode AD (lax.while_loop has no transpose rule). The standard
# detached-sampling estimator differentiates everything *except* that
# discrete choice: traversal runs on stop_gradient'd inputs with whatever
# fast path applies (BVH walk or brute scan), then the hit
# distance t of the chosen primitive is recomputed differentiably from the
# raw geometry tables. Gradients flow to camera/geometry/material/env
# parameters through the chosen hit; only boundary (silhouette) terms are
# dropped, exactly as BASELINE.json's "reparameterized/detached-sampling
# gradients" allows. This removes the old restriction that differentiable
# renders needed brute-force-small scenes.

def _eps_signed(x, eps=1e-12):
    """Clamp |x| >= eps preserving sign (gradient-safe division guard)."""
    return jnp.where(jnp.abs(x) < eps, jnp.where(x < 0.0, -eps, eps), x)


def _diff_t_sphere(scene: Scene, o, d, idx, t_det):
    """Differentiable t of the chosen sphere: re-solve the quadratic
    (sphere.hpp:18-39) and pick the root the detached traversal chose."""
    s = scene.spheres
    center = s.center[idx]
    radius = s.radius[idx]
    oc = center - o
    a = vecmath.length_squared(d)
    h = vecmath.dot(d, oc)
    c = vecmath.length_squared(oc) - radius * radius
    disc = jnp.maximum(h * h - a * c, 0.0)  # chosen lanes have disc > 0
    sq = vecmath.safe_sqrt(disc)
    inv_a = 1.0 / _eps_signed(a)
    r0 = (h - sq) * inv_a
    r1 = (h + sq) * inv_a
    sg = jax.lax.stop_gradient
    pick0 = jnp.abs(sg(r0) - t_det) <= jnp.abs(sg(r1) - t_det)
    return jnp.where(pick0, r0, r1)


def _diff_t_triangle(scene: Scene, o, d, idx, t_det):
    """Differentiable t of the chosen triangle (Möller-Trumbore,
    triangle.hpp:17-82 equivalent)."""
    tr = scene.triangles
    v0, e1, e2 = tr.v0[idx], tr.e1[idx], tr.e2[idx]
    pvec = jnp.cross(d, e2)
    det = _eps_signed(vecmath.dot(e1, pvec))
    tvec = o - v0
    qvec = jnp.cross(tvec, e1)
    return vecmath.dot(e2, qvec) / det


def _diff_t_box(scene: Scene, o, d, idx, t_det):
    """Differentiable t of the chosen affine-slab box: local-frame slab
    distances (cube.hpp:44-86), picking near/exit as the traversal did."""
    b = scene.boxes
    m = b.minv[idx].reshape(-1, 3, 3)
    trans = b.trans[idx]
    lo = rows_dot(m, o[:, None, :]) + trans
    ld = _eps_signed(rows_dot(m, d[:, None, :]), 1e-30)
    inv = 1.0 / ld
    t0 = (-1.0 - lo) * inv
    t1 = (1.0 - lo) * inv
    tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
    sg = jax.lax.stop_gradient
    pickn = jnp.abs(sg(tn) - t_det) <= jnp.abs(sg(tf) - t_det)
    return jnp.where(pickn, tn, tf)


def intersect_detached(scene: Scene, o, d, tmin) -> Hit:
    """Closest hit with detached traversal + differentiable hit distance.

    Drop-in for `intersect` on differentiable paths: the returned prim
    choice and hit mask are constants w.r.t. AD, but `t` carries exact
    gradients to the chosen primitive's parameters and to (o, d)."""
    sg = jax.lax.stop_gradient
    det = intersect(sg(scene), sg(o), sg(d), sg(jnp.asarray(tmin)))
    t_det = jnp.where(det.hit, det.t, 1.0)
    t = t_det
    if scene.spheres.count:
        ts = _diff_t_sphere(
            scene, o, d,
            jnp.clip(det.prim_idx, 0, scene.spheres.count - 1), t_det,
        )
        t = jnp.where(det.prim_type == PRIM_SPHERE, ts, t)
    if scene.triangles.count:
        tt = _diff_t_triangle(
            scene, o, d,
            jnp.clip(det.prim_idx, 0, scene.triangles.count - 1), t_det,
        )
        t = jnp.where(det.prim_type == PRIM_TRIANGLE, tt, t)
    if scene.boxes is not None and scene.boxes.count:
        tb = _diff_t_box(
            scene, o, d, jnp.clip(det.prim_idx, 0, scene.boxes.count - 1),
            t_det,
        )
        t = jnp.where(det.prim_type == PRIM_BOX, tb, t)
    # Miss lanes keep the detached constant (T_MAX); hit lanes must carry
    # the recomputed value, which equals t_det to float rounding.
    t = jnp.where(det.hit, t, det.t)
    return Hit(t=t, prim_type=det.prim_type, prim_idx=det.prim_idx,
               hit=det.hit)


# ---------------------------------------------------------------------------
# Deferred hit-record construction
# ---------------------------------------------------------------------------

# Each record fetch packs ALL of a primitive type's shading columns into
# one wide f32 matrix (loop-invariant -> hoisted) and gathers exactly once.
# Integer ids are < 2^24, exact through the f32 round-trip.

def _sphere_packed(scene: Scene):
    """[S, 5]: center xyz, radius, mat."""
    s = scene.spheres
    return jnp.concatenate(
        [s.center, s.radius[:, None],
         s.mat.astype(jnp.float32)[:, None]], axis=1,
    )


def _tri_packed(scene: Scene):
    """[T, 28]: v0 e1 e2 n0 n1 n2 (18) uv0 uv1 uv2 (6) tangent (3) mat."""
    t = scene.triangles
    return jnp.concatenate(
        [t.v0, t.e1, t.e2, t.n0, t.n1, t.n2, t.uv0, t.uv1, t.uv2,
         t.tangent, t.mat.astype(jnp.float32)[:, None]], axis=1,
    )


_PACK_COLS = 28


def _default_row(vals):
    import numpy as np

    r = np.zeros((_PACK_COLS,), np.float32)
    r[: len(vals)] = vals
    return r


# Benign stand-in rows fed to a decoder for lanes of another primitive type
# (numpy so they embed as free constants — see the _BOX_FACE_U note below).
# Sphere: unit sphere at origin; triangle: unit right triangle with +z
# normals; box: identity transform. All arithmetic on them stays O(1).
_SPHERE_DEFAULT_ROW = _default_row([0, 0, 0, 1, 0])
_TRI_DEFAULT_ROW = _default_row(
    [0, 0, 0, 1, 0, 0, 0, 1, 0,          # v0, e1, e2
     0, 0, 1, 0, 0, 1, 0, 0, 1,          # n0, n1, n2
     0, 0, 1, 0, 0, 1,                   # uv0, uv1, uv2
     1, 0, 0, 0]                          # tangent, mat
)
_BOX_DEFAULT_ROW = _default_row([1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 0])


def _packed_all(scene: Scene):
    """One [Ns+Nt+Nb, 28] table holding every primitive type's shading
    columns (sphere rows use cols 0:5, triangle rows 0:28, box rows 0:13).

    Loop-invariant, so XLA hoists it out of the bounce loop; make_record
    then needs exactly ONE wide gather per step instead of one per
    primitive type."""
    pads = []
    s = _sphere_packed(scene)
    pads.append(jnp.pad(s, ((0, 0), (0, _PACK_COLS - s.shape[1]))))
    pads.append(_tri_packed(scene))
    if scene.boxes is not None:
        b = _box_packed(scene)
        pads.append(jnp.pad(b, ((0, 0), (0, _PACK_COLS - b.shape[1]))))
    return jnp.concatenate(pads, axis=0)


def _sphere_record_from(g, o, d, t):
    """Sphere shading data (sphere.hpp:40-59); g = packed rows [N, 28]."""
    center = g[:, 0:3]
    # abs+floor keeps wrong-type rows (cols are then e1/minv components,
    # possibly negative) from blowing up the masked-out lanes' arithmetic;
    # identity for real spheres (radius > 0).
    radius = jnp.maximum(jnp.abs(g[:, 3]), 1e-6)
    mat = g[:, 4].astype(jnp.int32)
    p = o + t[:, None] * d
    outward = (p - center) / radius[:, None]
    front = vecmath.dot(d, outward) < 0.0
    normal = jnp.where(front[:, None], outward, -outward)

    # Spherical UV from the *outward* normal (sphere.hpp:70-79).
    theta = vecmath.safe_arccos(-outward[:, 1])
    phi = jnp.arctan2(-outward[:, 2], outward[:, 0]) + PI
    u = phi / (2.0 * PI)
    v = theta / PI

    # Tangent frame from world-up with pole fallback (sphere.hpp:50-59).
    world_up = jnp.asarray([0.0, 1.0, 0.0])
    alt = jnp.asarray([0.0, 0.0, 1.0])
    tangent = jnp.cross(jnp.broadcast_to(world_up, normal.shape), normal)
    degenerate = vecmath.length_squared(tangent) < 1e-3
    tangent = jnp.where(
        degenerate[:, None],
        jnp.cross(jnp.broadcast_to(alt, normal.shape), normal),
        tangent,
    )
    tangent = vecmath.normalize(tangent)
    bitangent = jnp.cross(normal, tangent)
    return p, normal, tangent, bitangent, front, u, v, mat


def _triangle_record_from(g, o, d, t):
    """Triangle shading data: barycentric-smooth normal (triangle.hpp:56-79)
    + interpolated UVs and the face tangent frame (cube faces)."""
    v0, e1, e2 = g[:, 0:3], g[:, 3:6], g[:, 6:9]
    n0, n1, n2 = g[:, 9:12], g[:, 12:15], g[:, 15:18]
    uv0, uv1, uv2 = g[:, 18:20], g[:, 20:22], g[:, 22:24]
    tangent = g[:, 24:27]
    mat = g[:, 27].astype(jnp.int32)
    p = o + t[:, None] * d

    geo_n = jnp.cross(e1, e2)
    area_sq = jnp.maximum(vecmath.length_squared(geo_n), 1e-24)
    # Barycentric weights of p (u weights v1, v weights v2; triangle.hpp:66-70).
    rel = p - v0
    c0 = jnp.cross(e1, rel)
    c2 = jnp.cross(rel, e2)
    u = vecmath.dot(geo_n, c2) / area_sq
    v = vecmath.dot(geo_n, c0) / area_sq
    w = 1.0 - u - v

    smooth = vecmath.normalize(
        w[:, None] * n0 + u[:, None] * n1 + v[:, None] * n2
    )
    front = vecmath.dot(d, smooth) < 0.0
    normal = jnp.where(front[:, None], smooth, -smooth)

    uv = w[:, None] * uv0 + u[:, None] * uv1 + v[:, None] * uv2
    bitangent = jnp.cross(normal, tangent)
    return p, normal, tangent, bitangent, front, uv[:, 0], uv[:, 1], mat


def _box_packed(scene: Scene):
    """[B, 13]: minv (9), trans (3), mat."""
    b = scene.boxes
    return jnp.concatenate(
        [b.minv, b.trans, b.mat.astype(jnp.float32)[:, None]], axis=1,
    )


# Per-face UV maps of the canonical [-1,1]^3 cube (cube.hpp:104-138),
# evaluated on the local hit point l: u = dot(l, U)*0.5 + 0.5, likewise v.
# Rows indexed by face = axis*2 + (sign>0). NUMPY on purpose: module-level
# jnp arrays would be created on the default device at import time.
import numpy as _np

_BOX_FACE_U = _np.asarray([
    [0., 0., 1.], [0., 0., 1.],     # MIN_X, MAX_X: u from z
    [1., 0., 0.], [1., 0., 0.],     # MIN_Y, MAX_Y: u from x
    [-1., 0., 0.], [1., 0., 0.],    # MIN_Z (mirrored), MAX_Z
], _np.float32)
_BOX_FACE_V = _np.asarray([
    [0., 1., 0.], [0., 1., 0.],
    [0., 0., 1.], [0., 0., 1.],
    [0., 1., 0.], [0., 1., 0.],
], _np.float32)
# Local face tangents (cube.hpp:100-142 / geometry._CUBE_FACES).
_BOX_FACE_TAN = _np.asarray([
    [0., 0., 1.], [0., 0., -1.],
    [1., 0., 0.], [-1., 0., 0.],
    [-1., 0., 0.], [1., 0., 0.],
], _np.float32)


def _onehot_rows(w, table):
    """sum_i w[n, i] * table[(n,) i, :] as elementwise multiply-adds: the
    weighted row sum of a [K, 3] (or per-lane [N, K, 3]) table."""
    out = w[:, 0:1] * table[..., 0, :]
    for i in range(1, w.shape[1]):
        out = out + w[:, i:i + 1] * table[..., i, :]
    return out


def _box_record_from(g, o, d, t):
    """Box shading data: face normal/UV/tangent from the local hit point
    (cube.hpp:100-142)."""
    m = g[:, 0:9].reshape(-1, 3, 3)           # world->local rows
    trans = g[:, 9:12]
    mat = g[:, 12].astype(jnp.int32)
    p = o + t[:, None] * d

    l = rows_dot(m, p[:, None, :]) + trans             # local hit ~ on cube
    axis = jnp.argmax(jnp.abs(l), axis=-1)              # dominant face axis
    # Everything face-dependent goes through one-hot arithmetic against
    # [6, 3] constants, as elementwise sums (see _onehot_rows).
    onehot = (jnp.arange(3)[None, :] == axis[:, None]).astype(jnp.float32)
    sign = jnp.sign(jnp.sum(l * onehot, axis=-1))
    pos = (sign > 0.0).astype(jnp.float32)
    # face = axis*2 + (sign>0): columns [x-,x+,y-,y+,z-,z+].
    onehot6 = (onehot[:, :, None]
               * jnp.stack([1.0 - pos, pos], axis=-1)[:, None, :]
               ).reshape(-1, 6)

    # Normals/tangents transform by the inverse-transpose: +-minv row `axis`
    # (see models/geometry.BoxTable).
    outward = vecmath.normalize(sign[:, None] * _onehot_rows(onehot, m))
    front = vecmath.dot(d, outward) < 0.0
    normal = jnp.where(front[:, None], outward, -outward)

    u = vecmath.dot(l, _onehot_rows(onehot6, _BOX_FACE_U)) * 0.5 + 0.5
    v = vecmath.dot(l, _onehot_rows(onehot6, _BOX_FACE_V)) * 0.5 + 0.5

    tan_l = _onehot_rows(onehot6, _BOX_FACE_TAN)
    tangent = vecmath.normalize(_onehot_rows(tan_l, m))
    bitangent = jnp.cross(normal, tangent)
    return p, normal, tangent, bitangent, front, u, v, mat


# ---------------------------------------------------------------------------
# SoA record decode (component-tuple twins; see core/soa.py)
# ---------------------------------------------------------------------------
#
# The AoS decoders above are the oracle; these produce the same values with
# vectors as (x, y, z) tuples of [N] arrays so the pooled-wavefront loop
# never materializes [N, 3] arrays. Parity is asserted in
# tests/test_soa_parity.py.


class HitRecordSoa(NamedTuple):
    """SoA twin of HitRecord: vector fields are (x, y, z) tuples."""

    t: jax.Array
    p: tuple
    normal: tuple
    tangent: tuple
    bitangent: tuple
    front_face: jax.Array
    u: jax.Array
    v: jax.Array
    mat: jax.Array
    hit: jax.Array


def _sphere_record_soa(g, o, d, t):
    """SoA twin of _sphere_record_from (sphere.hpp:40-59).

    g is a tuple of per-column [N] arrays (cols 0:5 used)."""
    center = (g[0], g[1], g[2])
    radius = jnp.maximum(jnp.abs(g[3]), 1e-6)
    mat = g[4].astype(jnp.int32)
    p = soa.axpy(t, d, o)
    outward = soa.scale(soa.sub(p, center), 1.0 / radius)
    front = soa.dot(d, outward) < 0.0
    normal = soa.where(front, outward, soa.neg(outward))

    theta = vecmath.safe_arccos(-outward[1])
    phi = jnp.arctan2(-outward[2], outward[0]) + PI
    u = phi / (2.0 * PI)
    v = theta / PI

    # world-up x n = (nz, 0, -nx); fallback (0,0,1) x n = (-ny, nx, 0)
    # (sphere.hpp:50-59 pole handling).
    tan_a = (normal[2], jnp.zeros_like(normal[0]), -normal[0])
    degenerate = soa.length_squared(tan_a) < 1e-3
    tan_b = (-normal[1], normal[0], jnp.zeros_like(normal[0]))
    tangent = soa.normalize(soa.where(degenerate, tan_b, tan_a))
    bitangent = soa.cross(normal, tangent)
    return p, normal, tangent, bitangent, front, u, v, mat


def _triangle_record_soa(g, o, d, t):
    """SoA twin of _triangle_record_from (triangle.hpp:56-79); g is a tuple
    of per-column [N] arrays (see _sphere_record_soa)."""
    v0 = (g[0], g[1], g[2])
    e1 = (g[3], g[4], g[5])
    e2 = (g[6], g[7], g[8])
    n0 = (g[9], g[10], g[11])
    n1 = (g[12], g[13], g[14])
    n2 = (g[15], g[16], g[17])
    tangent = (g[24], g[25], g[26])
    mat = g[27].astype(jnp.int32)
    p = soa.axpy(t, d, o)

    geo_n = soa.cross(e1, e2)
    area_sq = jnp.maximum(soa.length_squared(geo_n), 1e-24)
    rel = soa.sub(p, v0)
    c0 = soa.cross(e1, rel)
    c2 = soa.cross(rel, e2)
    u = soa.dot(geo_n, c2) / area_sq
    v = soa.dot(geo_n, c0) / area_sq
    w = 1.0 - u - v

    smooth = soa.normalize(tuple(
        w * n0[k] + u * n1[k] + v * n2[k] for k in range(3)))
    front = soa.dot(d, smooth) < 0.0
    normal = soa.where(front, smooth, soa.neg(smooth))

    uu = w * g[18] + u * g[20] + v * g[22]
    vv = w * g[19] + u * g[21] + v * g[23]
    bitangent = soa.cross(normal, tangent)
    return p, normal, tangent, bitangent, front, uu, vv, mat


def _box_record_soa(g, o, d, t):
    """SoA twin of _box_record_from (cube.hpp:100-142): the face one-hot
    tables become explicit axis/sign selects. g is a tuple of per-column
    [N] arrays, cols 0:13 used (see _sphere_record_soa)."""
    mat = g[12].astype(jnp.int32)
    p = soa.axpy(t, d, o)
    # l = M p + trans, rows of M in g[0:9], trans in g[9:12].
    l = tuple(
        g[3 * k] * p[0] + g[3 * k + 1] * p[1] + g[3 * k + 2] * p[2]
        + g[9 + k]
        for k in range(3)
    )
    ax, ay, az = jnp.abs(l[0]), jnp.abs(l[1]), jnp.abs(l[2])
    axis0 = (ax >= ay) & (ax >= az)
    axis1 = ~axis0 & (ay >= az)
    axis2 = ~axis0 & ~axis1
    dom = jnp.where(axis0, l[0], jnp.where(axis1, l[1], l[2]))
    sign = jnp.sign(dom)
    pos = sign > 0.0

    # outward = normalize(sign * M[axis, :]) (inverse-transpose row).
    row = tuple(
        jnp.where(axis0, g[k], jnp.where(axis1, g[3 + k], g[6 + k]))
        for k in range(3)
    )
    outward = soa.normalize(soa.scale(row, sign))
    front = soa.dot(d, outward) < 0.0
    normal = soa.where(front, outward, soa.neg(outward))

    # Face UV axes (cube.hpp:104-138 / _BOX_FACE_U, _BOX_FACE_V):
    #   u-axis: x-faces (0,0,1); y-faces (1,0,0); z-: (-1,0,0); z+: (1,0,0)
    #   v-axis: y-faces (0,0,1); x/z-faces (0,1,0)
    zeros = jnp.zeros_like(l[0])
    fu = (
        jnp.where(axis0, 0.0, jnp.where(axis1, 1.0,
                                        jnp.where(pos, 1.0, -1.0))),
        zeros,
        jnp.where(axis0, 1.0, 0.0),
    )
    fv = (
        zeros,
        jnp.where(axis1, 0.0, 1.0),
        jnp.where(axis1, 1.0, 0.0),
    )
    u = soa.dot(l, fu) * 0.5 + 0.5
    v = soa.dot(l, fv) * 0.5 + 0.5

    # Local tangents (_BOX_FACE_TAN): x-: (0,0,1) x+: (0,0,-1);
    # y-: (1,0,0) y+: (-1,0,0); z-: (-1,0,0) z+: (1,0,0).
    tx = jnp.where(axis0, 0.0,
                   jnp.where(axis1, jnp.where(pos, -1.0, 1.0),
                             jnp.where(pos, 1.0, -1.0)))
    tz = jnp.where(axis0, jnp.where(pos, -1.0, 1.0), 0.0)
    # world tangent_j = sum_i tan_local_i * M[i, j]
    tangent = soa.normalize(tuple(
        tx * g[k] + tz * g[6 + k] for k in range(3)))
    bitangent = soa.cross(normal, tangent)
    return p, normal, tangent, bitangent, front, u, v, mat


def make_record_soa(scene: Scene, o, d, hit: Hit) -> HitRecordSoa:
    """SoA twin of make_record: o, d are (x, y, z) tuples of [N] arrays.

    The shading columns come from per-component 1-D gathers out of the
    transposed (loop-invariant) packed table."""
    idx = hit.prim_idx
    t_safe = jnp.where(hit.hit, hit.t, 1.0)
    ns, nt = scene.spheres.count, scene.triangles.count
    table = _packed_all(scene)
    table_t = jnp.transpose(table)        # [28, Ntot]; folded at compile
    base = jnp.where(hit.prim_type == PRIM_TRIANGLE, ns,
                     jnp.where(hit.prim_type == PRIM_BOX, ns + nt, 0))
    row = jnp.clip(idx + base, 0, table.shape[0] - 1)
    g = tuple(table_t[k][row] for k in range(_PACK_COLS))
    is_sph = hit.prim_type == PRIM_SPHERE
    is_tri = hit.prim_type == PRIM_TRIANGLE
    is_box = hit.prim_type == PRIM_BOX

    def sel_cols(mask, default, ncols):
        """Benign default-row components for wrong-type lanes; columns a
        decoder never reads stay as cheap zeros."""
        zero = jnp.zeros_like(g[0])
        return tuple(
            jnp.where(mask, g[k], float(default[k])) if k < ncols else zero
            for k in range(_PACK_COLS)
        )

    sp = _sphere_record_soa(sel_cols(is_sph, _SPHERE_DEFAULT_ROW, 5),
                            o, d, t_safe)
    tp = _triangle_record_soa(sel_cols(is_tri, _TRI_DEFAULT_ROW, 28),
                              o, d, t_safe)

    def sel(mask, a, b):
        if isinstance(a, tuple):
            return soa.where(mask, b, a)
        return jnp.where(mask, b, a)

    parts = tuple(sel(is_tri, sp[i], tp[i]) for i in range(8))
    if scene.boxes is not None:
        bp = _box_record_soa(sel_cols(is_box, _BOX_DEFAULT_ROW, 13),
                             o, d, t_safe)
        parts = tuple(sel(is_box, parts[i], bp[i]) for i in range(8))
    p, normal, tangent, bitangent, front, u, v, mat = parts
    return HitRecordSoa(
        t=hit.t, p=p, normal=normal, tangent=tangent, bitangent=bitangent,
        front_face=front, u=u, v=v, mat=mat, hit=hit.hit,
    )


def intersect_soa(scene: Scene, o, d, tmin) -> Hit:
    """SoA twin of intersect: o, d are component tuples of [N] arrays."""
    return intersect(scene, soa.pack(o), soa.pack(d), tmin)


def make_record(scene: Scene, o, d, hit: Hit) -> HitRecord:
    """Gather full shading data for the closest hits (deferred shading).

    Miss lanes carry t = T_MAX; feeding that into the position/frame math
    overflows float32 (p ~ 1e30, |p|^2 = inf) and poisons *backward* passes
    with NaN even though the values are masked out — so record geometry is
    computed with t clamped to 1 on misses (outputs there are discarded).
    """
    idx = hit.prim_idx
    t_safe = jnp.where(hit.hit, hit.t, 1.0)
    # One global gather: rows [0,Ns) spheres, [Ns,Ns+Nt) triangles,
    # [Ns+Nt,..) boxes. Each decoder interprets the SAME gathered rows with
    # its own column layout; wrong-type lanes produce garbage that the
    # type select below masks (all decoders are division/NaN-guarded, so
    # the garbage cannot poison gradients).
    ns, nt = scene.spheres.count, scene.triangles.count
    table = _packed_all(scene)
    base = jnp.where(hit.prim_type == PRIM_TRIANGLE, ns,
                     jnp.where(hit.prim_type == PRIM_BOX, ns + nt, 0))
    g = table[jnp.clip(idx + base, 0, table.shape[0] - 1)]
    # Wrong-type lanes must see a BENIGN row, not another type's columns:
    # garbage magnitudes (e.g. an affine minv row read as a sphere center)
    # survive the forward select but overflow the *backward* chain
    # (normalize grads cube the length) into NaN on masked lanes.
    is_sph = hit.prim_type == PRIM_SPHERE
    is_tri_m = hit.prim_type == PRIM_TRIANGLE
    is_box_m = hit.prim_type == PRIM_BOX
    sel_row = lambda m, default: jnp.where(m[:, None], g, default)
    sp = _sphere_record_from(sel_row(is_sph, _SPHERE_DEFAULT_ROW),
                             o, d, t_safe)
    tp = _triangle_record_from(sel_row(is_tri_m, _TRI_DEFAULT_ROW),
                               o, d, t_safe)

    is_tri = (hit.prim_type == PRIM_TRIANGLE)

    def sel(mask, a, b):
        return jnp.where(mask[:, None] if a.ndim == 2 else mask, b, a)

    parts = tuple(sel(is_tri, sp[i], tp[i]) for i in range(8))
    if scene.boxes is not None:
        bp = _box_record_from(sel_row(is_box_m, _BOX_DEFAULT_ROW),
                              o, d, t_safe)
        parts = tuple(sel(is_box_m, parts[i], bp[i]) for i in range(8))
    p, normal, tangent, bitangent, front, u, v, mat = parts
    return HitRecord(
        t=hit.t, p=p, normal=normal, tangent=tangent, bitangent=bitangent,
        front_face=front, u=u, v=v, mat=mat, hit=hit.hit,
    )
