"""Geometry: flat SoA primitive tables + host-side scene building.

JAX-native re-expression of the reference's shared_ptr polymorphic
`hittable` graph (/root/reference/hittable.hpp:29-36, sphere.hpp, cube.hpp,
triangle.hpp) and its transform wrappers (translate.hpp, rotate_x/y/z.hpp,
scale.hpp, material_instance.hpp).

Design decisions:
 * Three device-side primitive types: SPHERE, TRIANGLE, and BOX. A box is
   stored as the world->local affine of a canonical [-1,1]^3 cube and hit
   with the reference's local-frame slab test (cube.hpp:44-86) — one
   20-op slab epilogue per (ray, box) instead of 12 Moller-Trumbore
   triangles (>400 ops), which shrinks the showcase scene's hot primitive
   table ~10x. Per-face UVs/normals/tangents follow cube.hpp:100-142.
 * Transform wrappers do not exist on device: affine transforms are *baked*
   into primitive data at build time. Boxes absorb ANY affine exactly (the
   inverse rides along); triangles are closed under affine maps; spheres
   appear only with rigid + uniform-scale transforms in the reference
   scenes (scene_management.hpp:153-201), so center/radius baking is exact.
 * material_instance (zero-copy instancing) becomes "instantiate with a
   different mat id" — rows are cheap, no pointers needed.

Note: the reference cube returns a t=ray_t.min pseudo-hit when the ray
origin is inside the box (cube.hpp:47-73, slab tmin clamped to ray_t.min)
with a fallback normal; triangle-compiled boxes instead return the true
exit intersection. This build keeps the *correct* behavior and documents
the divergence.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# Primitive type tags (used by BVH leaves; prim id = [type, row]).
PRIM_SPHERE = 0
PRIM_TRIANGLE = 1
PRIM_BOX = 2


class SphereTable(NamedTuple):
    """S spheres: world-space center/radius + material id (sphere.hpp:7-15)."""

    center: jax.Array  # f32[S,3]
    radius: jax.Array  # f32[S]
    mat: jax.Array     # i32[S]

    @property
    def count(self) -> int:
        return self.radius.shape[0]


class BoxTable(NamedTuple):
    """B boxes as world->local affines of the canonical [-1,1]^3 cube.

    x_local = minv (3x3, row-flattened) @ x_world + trans. The local cube is
    EXACTLY [-1,1]^3 — per-box corners/half-extents are folded into the
    affine at build time — so the slab test and the per-face UV maps
    (cube.hpp:44-86, 100-142) need no extra per-box data.

    Normals and face tangents both transform by the inverse-transpose, which
    here is just minv's rows: world_normal(face k) = +-normalize(minv[k, :]).
    (Tangents strictly transform by the forward map, but after
    normalization inverse-transpose and forward agree for the
    rotation+scale transforms the reference scenes use — and the
    triangle-tessellation path used inverse-transpose too, so the two box
    representations shade identically.)

    aabb_min/max cache the world-space AABB of the transformed cube (8
    corner hull): used by the BVH builder.
    """

    minv: jax.Array      # f32[B,9]  world->local linear part, row-major
    trans: jax.Array     # f32[B,3]  world->local translation
    aabb_min: jax.Array  # f32[B,3]
    aabb_max: jax.Array  # f32[B,3]
    mat: jax.Array       # i32[B]

    @property
    def count(self) -> int:
        return self.mat.shape[0]


class TriangleTable(NamedTuple):
    """T triangles with per-vertex normals/UVs and a per-face tangent frame.

    v0 + e1/e2 edge form for Möller-Trumbore; n0/n1/n2 enable smooth (Phong)
    shading (triangle.hpp:73). uv* and tangent support the cube-face texture
    parameterization (cube.hpp:100-142); mesh triangles carry zero UVs and
    tangents (the reference never sets them for meshes either,
    triangle.hpp:76-79).
    """

    v0: jax.Array       # f32[T,3]
    e1: jax.Array       # f32[T,3]  v1 - v0
    e2: jax.Array       # f32[T,3]  v2 - v0
    n0: jax.Array       # f32[T,3]
    n1: jax.Array       # f32[T,3]
    n2: jax.Array       # f32[T,3]
    uv0: jax.Array      # f32[T,2]
    uv1: jax.Array      # f32[T,2]
    uv2: jax.Array      # f32[T,2]
    tangent: jax.Array  # f32[T,3] face-constant tangent (zero = none)
    mat: jax.Array      # i32[T]

    @property
    def count(self) -> int:
        return self.mat.shape[0]


# ---------------------------------------------------------------------------
# Host-side affine transforms (numpy; baked at build time)
# ---------------------------------------------------------------------------

def translate(offset) -> np.ndarray:
    """4x4 translation (translate.hpp semantics)."""
    m = np.eye(4, dtype=np.float64)
    m[:3, 3] = np.asarray(offset, np.float64)
    return m


def _rot(axis: int, radians: float) -> np.ndarray:
    c, s = np.cos(radians), np.sin(radians)
    m = np.eye(4, dtype=np.float64)
    i, j = [(1, 2), (2, 0), (0, 1)][axis]
    m[i, i] = c
    m[j, j] = c
    m[i, j] = -s
    m[j, i] = s
    return m


def rotate_x(degrees: float) -> np.ndarray:
    """rotate_x.hpp takes degrees."""
    return _rot(0, np.deg2rad(degrees))


def rotate_y(degrees: float) -> np.ndarray:
    """Y rotation, degrees.

    NOTE: the reference's rotate_y ctor takes *radians* (rotate_y.hpp:9-13)
    while rotate_x/rotate_z take degrees, yet build_geometry passes degrees
    to all three (scene_management.hpp:115-116). This build uses degrees
    uniformly (the documented intent); `rotate_y_radians` reproduces the
    reference's literal behavior for A/B image comparison.
    """
    return _rot(1, np.deg2rad(degrees))


def rotate_y_radians(radians: float) -> np.ndarray:
    return _rot(1, radians)


def rotate_z(degrees: float) -> np.ndarray:
    return _rot(2, np.deg2rad(degrees))


def scale(factors) -> np.ndarray:
    """4x4 scale; componentwise (scale.hpp)."""
    f = np.asarray(factors, np.float64)
    if f.ndim == 0:
        f = np.full(3, float(f))
    m = np.eye(4, dtype=np.float64)
    m[0, 0], m[1, 1], m[2, 2] = f
    return m


def compose(*mats) -> np.ndarray:
    """compose(A, B, C) applies C first, then B, then A (matrix product)."""
    out = np.eye(4, dtype=np.float64)
    for m in mats:
        out = out @ m
    return out


def _apply_points(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ m[:3, :3].T + m[:3, 3]


def _apply_normals(m: np.ndarray, nrm: np.ndarray) -> np.ndarray:
    """Inverse-transpose transform, renormalized (correct for any affine)."""
    it = np.linalg.inv(m[:3, :3]).T
    out = nrm @ it.T
    ln = np.linalg.norm(out, axis=-1, keepdims=True)
    return out / np.maximum(ln, 1e-12)


# ---------------------------------------------------------------------------
# Host-side geometry accumulation
# ---------------------------------------------------------------------------

# Cube face table (cube.hpp:100-142): for each face, (normal, tangent,
# uv basis). Corner UV assignment reproduces the reference's linear maps.
_CUBE_FACES = (
    # (axis, sign, normal, tangent)
    (0, -1, (-1, 0, 0), (0, 0, 1)),
    (0, +1, (1, 0, 0), (0, 0, -1)),
    (1, -1, (0, -1, 0), (1, 0, 0)),
    (1, +1, (0, 1, 0), (-1, 0, 0)),
    (2, -1, (0, 0, -1), (-1, 0, 0)),
    (2, +1, (0, 0, 1), (1, 0, 0)),
)


def _cube_face_uv(axis: int, sign: int, local: np.ndarray, he: np.ndarray):
    """Reference per-face UV maps (cube.hpp:104-138); local = point - center."""
    x, y, z = local[..., 0], local[..., 1], local[..., 2]
    hx, hy, hz = he
    if axis == 0:
        u = (z + hz) / (2 * hz)
        v = (y + hy) / (2 * hy)
    elif axis == 1:
        u = (x + hx) / (2 * hx)
        v = (z + hz) / (2 * hz)
    elif sign < 0:  # MIN_Z
        u = (hx - x) / (2 * hx)
        v = (y + hy) / (2 * hy)
    else:  # MAX_Z
        u = (x + hx) / (2 * hx)
        v = (y + hy) / (2 * hy)
    return np.stack([u, v], axis=-1)


class GeometryBuilder:
    """Accumulates primitives on host; `pack()` freezes SoA jnp tables."""

    def __init__(self):
        self._sph_center: list[np.ndarray] = []
        self._sph_radius: list[float] = []
        self._sph_mat: list[int] = []
        self._tri_chunks: list[dict[str, np.ndarray]] = []
        self._box_minv: list[np.ndarray] = []
        self._box_trans: list[np.ndarray] = []
        self._box_aabb: list[tuple[np.ndarray, np.ndarray]] = []
        self._box_mat: list[int] = []

    # -- spheres ------------------------------------------------------------

    def add_sphere(self, center, radius, mat_id, transform=None):
        center = np.asarray(center, np.float64)
        radius = max(0.0, float(radius))  # sphere.hpp:9 negative-radius guard
        if transform is not None:
            lin = transform[:3, :3]
            # Spheres stay spheres only under rigid + uniform scale; verify.
            s = np.linalg.norm(lin, axis=0)
            if not np.allclose(s, s[0], rtol=1e-5):
                raise ValueError(
                    "non-uniform scale on a sphere is not supported; "
                    "the reference scenes never do this (scene_management.hpp:169-184)"
                )
            center = _apply_points(transform, center[None])[0]
            radius *= float(s[0])
        self._sph_center.append(center)
        self._sph_radius.append(radius)
        self._sph_mat.append(int(mat_id))

    # -- triangles ----------------------------------------------------------

    def add_triangles(self, v0, v1, v2, mat_id, n0=None, n1=None, n2=None,
                      uv0=None, uv1=None, uv2=None, tangent=None,
                      transform=None):
        """Add a batch of triangles [T,3]-shaped arrays; normals default flat."""
        v0 = np.atleast_2d(np.asarray(v0, np.float64))
        v1 = np.atleast_2d(np.asarray(v1, np.float64))
        v2 = np.atleast_2d(np.asarray(v2, np.float64))
        t = v0.shape[0]

        flat_n = np.cross(v1 - v0, v2 - v0)
        ln = np.linalg.norm(flat_n, axis=-1, keepdims=True)
        flat_n = flat_n / np.maximum(ln, 1e-12)
        n0 = flat_n if n0 is None else np.atleast_2d(np.asarray(n0, np.float64))
        n1 = flat_n if n1 is None else np.atleast_2d(np.asarray(n1, np.float64))
        n2 = flat_n if n2 is None else np.atleast_2d(np.asarray(n2, np.float64))

        zeros2 = np.zeros((t, 2))
        uv0 = zeros2 if uv0 is None else np.atleast_2d(np.asarray(uv0, np.float64))
        uv1 = zeros2 if uv1 is None else np.atleast_2d(np.asarray(uv1, np.float64))
        uv2 = zeros2 if uv2 is None else np.atleast_2d(np.asarray(uv2, np.float64))
        tangent = (np.zeros((t, 3)) if tangent is None
                   else np.atleast_2d(np.asarray(tangent, np.float64)))

        if transform is not None:
            v0 = _apply_points(transform, v0)
            v1 = _apply_points(transform, v1)
            v2 = _apply_points(transform, v2)
            n0 = _apply_normals(transform, n0)
            n1 = _apply_normals(transform, n1)
            n2 = _apply_normals(transform, n2)
            tl = np.linalg.norm(tangent, axis=-1, keepdims=True)
            tangent = np.where(
                tl > 1e-12,
                _apply_normals(transform, np.where(tl > 1e-12, tangent, 1.0)),
                0.0,
            )

        mats = np.broadcast_to(np.asarray(mat_id, np.int32), (t,)).copy()
        self._tri_chunks.append(dict(
            v0=v0, e1=v1 - v0, e2=v2 - v0, n0=n0, n1=n1, n2=n2,
            uv0=uv0, uv1=uv1, uv2=uv2, tangent=tangent, mat=mats,
        ))

    def add_box(self, min_corner, max_corner, mat_id, transform=None,
                tessellate: bool = False):
        """Box primitive (cube.hpp:11-32): native affine-slab box by default;
        tessellate=True emits the legacy 12-triangle representation instead
        (kept as a cross-check oracle — both shade identically)."""
        if tessellate:
            return self.add_box_triangles(min_corner, max_corner, mat_id,
                                          transform=transform)
        mn = np.asarray(min_corner, np.float64)
        mx = np.asarray(max_corner, np.float64)
        center = 0.5 * (mn + mx)
        he = np.maximum(0.5 * (mx - mn), 1e-12)

        # local [-1,1]^3 -> world: A = transform . translate(center) . scale(he)
        a = compose(translate(center), scale(he))
        if transform is not None:
            a = compose(np.asarray(transform, np.float64), a)
        lin = a[:3, :3]
        minv = np.linalg.inv(lin)
        trans = -minv @ a[:3, 3]

        corners = np.array(
            [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
            np.float64,
        ) @ lin.T + a[:3, 3]
        self._box_minv.append(minv.reshape(9))
        self._box_trans.append(trans)
        self._box_aabb.append((corners.min(0), corners.max(0)))
        self._box_mat.append(int(mat_id))

    def add_box_triangles(self, min_corner, max_corner, mat_id, transform=None):
        """Axis-aligned box -> 12 triangles with reference face UVs/tangents
        (cube.hpp:11-32,100-142)."""
        mn = np.asarray(min_corner, np.float64)
        mx = np.asarray(max_corner, np.float64)
        center = 0.5 * (mn + mx)
        he = 0.5 * (mx - mn)

        for axis, sign, normal, tangent in _CUBE_FACES:
            a1, a2 = [(1, 2), (0, 2), (0, 1)][axis]
            # Four local-space corners of this face.
            corners = np.zeros((4, 3))
            corners[:, axis] = sign * he[axis]
            corners[[0, 1], a1] = -he[a1]
            corners[[2, 3], a1] = +he[a1]
            corners[[0, 2], a2] = -he[a2]
            corners[[1, 3], a2] = +he[a2]
            uv = _cube_face_uv(axis, sign, corners, he)
            world = corners + center
            n = np.tile(np.asarray(normal, np.float64), (2, 1))
            tan = np.tile(np.asarray(tangent, np.float64), (2, 1))
            # Two triangles per face: (0,1,3) and (0,3,2).
            i0, i1, i2 = (0, 0), (1, 3), (3, 2)
            self.add_triangles(
                v0=world[[0, 0]], v1=world[[1, 3]], v2=world[[3, 2]],
                n0=n, n1=n, n2=n,
                uv0=uv[[0, 0]], uv1=uv[[1, 3]], uv2=uv[[3, 2]],
                tangent=tan, mat_id=mat_id, transform=transform,
            )

    def add_cube(self, center, mat_id, transform=None):
        """Unit-half-extent cube at center (cube.hpp:24-32 second ctor)."""
        c = np.asarray(center, np.float64)
        self.add_box(c - 1.0, c + 1.0, mat_id, transform=transform)

    # -- packing ------------------------------------------------------------

    @staticmethod
    def _morton_spread(x: np.ndarray) -> np.ndarray:
        """Spread 10 bits to every 3rd bit position."""
        x = x.astype(np.uint64) & 0x3FF
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    @classmethod
    def morton_order(cls, points: np.ndarray) -> np.ndarray:
        """Stable permutation sorting points along a 30-bit 3-D Morton curve.

        Used to lay primitive-table rows out spatially, so every
        brute-scan chunk holds nearby primitives (what a chunk-culling
        intersector would need). Host-side numpy; purely a storage-order
        choice — the hit set is unchanged.
        """
        p = np.asarray(points, np.float64)
        if p.shape[0] <= 1:
            return np.arange(p.shape[0])
        lo = p.min(0)
        span = np.maximum(p.max(0) - lo, 1e-12)
        q = np.clip((p - lo) / span * 1023.0, 0.0, 1023.0).astype(np.uint64)
        code = (
            (cls._morton_spread(q[:, 0]) << 2)
            | (cls._morton_spread(q[:, 1]) << 1)
            | cls._morton_spread(q[:, 2])
        )
        return np.argsort(code, kind="stable")

    def pack(self) -> tuple[SphereTable, TriangleTable, BoxTable]:
        """Pack into *numpy*-backed tables; SceneBuilder.build does the
        single host->device conversion at the end (small mixed np/jnp host
        ops would each trigger a device compile over slow links)."""
        if self._sph_center:
            sph = SphereTable(
                center=np.stack(self._sph_center).astype(np.float32),
                radius=np.asarray(self._sph_radius, np.float32),
                mat=np.asarray(self._sph_mat, np.int32),
            )
        else:
            # Zero-radius dummy: intersection guards on radius > 0.
            sph = SphereTable(
                center=np.zeros((1, 3), np.float32),
                radius=np.zeros((1,), np.float32),
                mat=np.zeros((1,), np.int32),
            )

        if self._tri_chunks:
            cat = {
                k: np.concatenate([c[k] for c in self._tri_chunks])
                for k in self._tri_chunks[0]
            }
        else:
            # Degenerate dummy triangle (zero edges -> guaranteed miss).
            cat = dict(
                v0=np.zeros((1, 3)), e1=np.zeros((1, 3)), e2=np.zeros((1, 3)),
                n0=np.zeros((1, 3)), n1=np.zeros((1, 3)), n2=np.zeros((1, 3)),
                uv0=np.zeros((1, 2)), uv1=np.zeros((1, 2)), uv2=np.zeros((1, 2)),
                tangent=np.zeros((1, 3)), mat=np.zeros((1,), np.int32),
            )
        tri = TriangleTable(
            **{k: np.asarray(v, np.int32 if k == "mat" else np.float32)
               for k, v in cat.items()}
        )

        if self._box_minv:
            box = BoxTable(
                minv=np.stack(self._box_minv).astype(np.float32),
                trans=np.stack(self._box_trans).astype(np.float32),
                aabb_min=np.stack([a for a, _ in self._box_aabb]).astype(np.float32),
                aabb_max=np.stack([b for _, b in self._box_aabb]).astype(np.float32),
                mat=np.asarray(self._box_mat, np.int32),
            )
        else:
            # Dummy box far outside every scene: the slab test's safe
            # inverse turns the degenerate zero linear part into a
            # guaranteed miss (|o_local| >> 1 with ~zero direction).
            box = BoxTable(
                minv=np.zeros((1, 9), np.float32),
                trans=np.full((1, 3), 1e6, np.float32),
                aabb_min=np.full((1, 3), np.inf, np.float32),
                aabb_max=np.full((1, 3), -np.inf, np.float32),
                mat=np.zeros((1,), np.int32),
            )

        # Spatial (Morton) row order -> spatially tight scan chunks. Pure
        # storage-order choice.
        sp = self.morton_order(sph.center)
        sph = SphereTable(*(np.ascontiguousarray(col[sp]) for col in sph))
        centroid = tri.v0 + (tri.e1 + tri.e2) / 3.0
        tp = self.morton_order(centroid)
        tri = TriangleTable(*(np.ascontiguousarray(col[tp]) for col in tri))
        bp = self.morton_order((box.aabb_min + box.aabb_max) * 0.5
                               if self._box_minv else np.zeros((1, 3)))
        box = BoxTable(*(np.ascontiguousarray(col[bp]) for col in box))
        return sph, tri, box
