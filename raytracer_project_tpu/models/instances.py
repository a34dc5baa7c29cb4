"""Two-level instancing: per-mesh BLAS reuse + incremental instance moves.

The reference builds ONE BVH per mesh at asset-load time and reuses it
across every scene rebuild (/root/reference/model.hpp:95 — the sub-BVH
lives with the model, while `build_geometry` re-instantiates transforms
around it, scene_management.hpp:113-118, main.cpp:1492-1500). The flat
path in models/obj.py instead bakes every instance's triangles into the
global tables, so moving one instance costs a full world rebuild.

This module is the JAX-native two-level counterpart:

  BLAS  MeshAsset — local-space triangles, Morton-ordered ONCE, with a
        local flat BVH built ONCE and shared by every instance (and
        every rebuild). The local order is also the instance's block
        order in the global tables, so scan chunks stay spatially tight
        without any global re-sort.

  TLAS  InstancedWorld — instances are (mesh, 4x4 affine, material)
        rows. `build()` appends each instance as a CONTIGUOUS block
        after the base scene's triangles; `set_transform()` +
        `rebuild()` then recompute ONLY the moved instances' blocks
        (vertex and normal transform) and splice them into the existing
        tables —
        host work is O(moved triangles), not O(total triangles), which
        `triangles_recomputed` exposes for the test to pin.

  Query `intersect_instanced` — two-level closest hit for the CPU/BVH
        path: per instance, the ray is pulled into mesh-local space
        (t is affine-invariant when o and d transform together) and the
        shared local BVH is traversed; results map back through the
        block layout. The render path needs no special casing: the
        brute scan reads the same global tables.

Scenes built here carry `bvh=None` (the global single-level BVH is the
one structure that WOULD need a full O(N log N) rebuild per move; the
query path uses the BLAS'es instead).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import intersect as isect_mod
from ..ops.intersect import Hit
from . import geometry as geom_mod
from .scene import Scene, SceneBuilder


@dataclasses.dataclass
class MeshAsset:
    """Local-space mesh + its once-built BLAS (model.hpp:95 parity)."""

    name: str
    v0: np.ndarray       # f64[k, 3] local, Morton-ordered
    v1: np.ndarray
    v2: np.ndarray
    n0: np.ndarray
    n1: np.ndarray
    n2: np.ndarray
    local_scene: Scene   # single-mesh Scene (local space) for the BLAS
    local_bvh: Any       # the reusable sub-BVH (== local_scene.bvh)

    @property
    def count(self) -> int:
        return self.v0.shape[0]


@dataclasses.dataclass
class _Instance:
    mesh_id: int
    transform: np.ndarray   # 4x4
    mat_id: int
    start: int = -1         # block offset in the global triangle table
    dirty: bool = True


class InstancedWorld:
    """TLAS over reusable mesh BLAS'es with O(block) incremental moves."""

    def __init__(self):
        self.meshes: list[MeshAsset] = []
        self.instances: list[_Instance] = []
        self.triangles_recomputed = 0   # host-work meter for tests
        self._base_scene: Scene | None = None
        self._tri_host: dict | None = None   # host copies of tri fields
        self._scene: Scene | None = None

    # -- assets --------------------------------------------------------------

    def add_mesh(self, v0, v1, v2, n0=None, n1=None, n2=None,
                 name: str = "") -> int:
        """Register local-space triangles; Morton order + BLAS built ONCE."""
        v0 = np.atleast_2d(np.asarray(v0, np.float64))
        v1 = np.atleast_2d(np.asarray(v1, np.float64))
        v2 = np.atleast_2d(np.asarray(v2, np.float64))
        flat = np.cross(v1 - v0, v2 - v0)
        flat /= np.maximum(np.linalg.norm(flat, axis=-1, keepdims=True),
                           1e-12)
        n0 = flat if n0 is None else np.atleast_2d(np.asarray(n0, np.float64))
        n1 = flat if n1 is None else np.atleast_2d(np.asarray(n1, np.float64))
        n2 = flat if n2 is None else np.atleast_2d(np.asarray(n2, np.float64))

        order = geom_mod.GeometryBuilder.morton_order(
            ((v0 + v1 + v2) / 3.0).astype(np.float32))
        v0, v1, v2 = v0[order], v1[order], v2[order]
        n0, n1, n2 = n0[order], n1[order], n2[order]

        # The BLAS: a single-mesh local-space Scene with its own BVH,
        # built once and reused by every instance and every rebuild.
        b = SceneBuilder()
        m = b.materials.lambertian(f"__blas_{len(self.meshes)}__",
                                   (1.0, 1.0, 1.0))
        b.geometry.add_triangles(v0, v1, v2, m, n0=n0, n1=n1, n2=n2)
        local_scene = b.build(with_bvh=True)
        # Canonical local arrays come FROM the packed local scene, so the
        # instance's global block rows and the BLAS's triangle rows are
        # the same order by construction (prim-id mapping is a plain
        # offset in intersect_instanced).
        lt = local_scene.triangles
        lv0 = np.asarray(lt.v0, np.float64)
        self.meshes.append(MeshAsset(
            name=name or f"mesh{len(self.meshes)}",
            v0=lv0, v1=lv0 + np.asarray(lt.e1, np.float64),
            v2=lv0 + np.asarray(lt.e2, np.float64),
            n0=np.asarray(lt.n0, np.float64),
            n1=np.asarray(lt.n1, np.float64),
            n2=np.asarray(lt.n2, np.float64),
            local_scene=local_scene, local_bvh=local_scene.bvh))
        return len(self.meshes) - 1

    def add_obj(self, path: str, target_scale: float = 1.0,
                name: str = "") -> int:
        """Register an OBJ model as a reusable mesh asset — the
        reference's sceneAssetsLoader role (scene_management.hpp:29-46:
        load once, instantiate many)."""
        from . import obj as obj_mod

        mesh = obj_mod.load_obj(path)
        if mesh is None:
            raise FileNotFoundError(path)
        mesh = obj_mod.normalize_mesh(mesh, target_scale)
        return self.add_mesh(mesh.v0, mesh.v1, mesh.v2,
                             n0=mesh.n0, n1=mesh.n1, n2=mesh.n2,
                             name=name or path)

    def add_instance(self, mesh_id: int, transform, mat_id: int) -> int:
        self.instances.append(_Instance(
            mesh_id=mesh_id,
            transform=np.asarray(transform, np.float64).reshape(4, 4),
            mat_id=mat_id))
        return len(self.instances) - 1

    def set_transform(self, inst_id: int, transform) -> None:
        """Queue an instance move; `rebuild()` applies it incrementally."""
        inst = self.instances[inst_id]
        inst.transform = np.asarray(transform, np.float64).reshape(4, 4)
        inst.dirty = True

    # -- block math -----------------------------------------------------------

    def _world_block(self, inst: _Instance):
        """Instance triangles in world space (same math as
        geometry.add_triangles' baked transforms)."""
        mesh = self.meshes[inst.mesh_id]
        m = inst.transform
        v0 = geom_mod._apply_points(m, mesh.v0)
        v1 = geom_mod._apply_points(m, mesh.v1)
        v2 = geom_mod._apply_points(m, mesh.v2)
        n0 = geom_mod._apply_normals(m, mesh.n0)
        n1 = geom_mod._apply_normals(m, mesh.n1)
        n2 = geom_mod._apply_normals(m, mesh.n2)
        self.triangles_recomputed += mesh.count
        return v0, v1, v2, n0, n1, n2

    # -- build / rebuild ------------------------------------------------------

    def build(self, builder: SceneBuilder | None = None) -> Scene:
        """Full first build: base scene (materials/textures/other
        geometry) + one contiguous triangle block per instance."""
        builder = builder or _default_builder()
        base = builder.build(with_bvh=False)
        self._base_scene = base
        nb = base.triangles.count

        f32 = np.float32
        blocks = []
        start = nb
        for inst in self.instances:
            inst.start = start
            blocks.append(self._world_block(inst))
            start += self.meshes[inst.mesh_id].count
            inst.dirty = False
        total = start

        t = base.triangles
        tri = {
            "v0": np.empty((total, 3), f32), "e1": np.empty((total, 3), f32),
            "e2": np.empty((total, 3), f32), "n0": np.empty((total, 3), f32),
            "n1": np.empty((total, 3), f32), "n2": np.empty((total, 3), f32),
            "uv0": np.zeros((total, 2), f32), "uv1": np.zeros((total, 2), f32),
            "uv2": np.zeros((total, 2), f32),
            "tangent": np.zeros((total, 3), f32),
            "mat": np.empty((total,), np.int32),
        }
        for k in ("v0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
                  "tangent", "mat"):
            tri[k][:nb] = np.asarray(getattr(t, k))
        for inst, (v0, v1, v2, n0, n1, n2) in zip(self.instances, blocks):
            s, k = inst.start, self.meshes[inst.mesh_id].count
            tri["v0"][s:s + k] = v0
            tri["e1"][s:s + k] = v1 - v0
            tri["e2"][s:s + k] = v2 - v0
            tri["n0"][s:s + k] = n0
            tri["n1"][s:s + k] = n1
            tri["n2"][s:s + k] = n2
            tri["mat"][s:s + k] = inst.mat_id
        self._tri_host = tri

        tri_table = geom_mod.TriangleTable(
            **{k: jnp.asarray(v) for k, v in tri.items()})
        self._scene = base._replace(triangles=tri_table, bvh=None)
        return self._scene

    def rebuild(self) -> Scene:
        """Apply queued instance moves: O(moved triangles) host work, the
        untouched blocks' rows/slices are reused as-is (the counterpart
        of the reference's sub-BVH reuse across build_geometry calls)."""
        assert self._scene is not None, "call build() first"
        tri = self._tri_host
        dirty = [i for i in self.instances if i.dirty]
        if not dirty:
            return self._scene
        for inst in dirty:
            s, k = inst.start, self.meshes[inst.mesh_id].count
            v0, v1, v2, n0, n1, n2 = self._world_block(inst)
            tri["v0"][s:s + k] = v0
            tri["e1"][s:s + k] = v1 - v0
            tri["e2"][s:s + k] = v2 - v0
            tri["n0"][s:s + k] = n0
            tri["n1"][s:s + k] = n1
            tri["n2"][s:s + k] = n2
            inst.dirty = False

        tri_table = geom_mod.TriangleTable(
            **{k: jnp.asarray(v) for k, v in tri.items()})
        self._scene = self._scene._replace(triangles=tri_table)
        return self._scene


def _default_builder() -> SceneBuilder:
    b = SceneBuilder()
    b.materials.lambertian("__default__", (0.8, 0.8, 0.8))
    return b


# ---------------------------------------------------------------------------
# Two-level query (TLAS -> BLAS), the CPU/BVH counterpart of bvh.hpp:46-119
# through model.hpp:105-111's delegation
# ---------------------------------------------------------------------------

def intersect_instanced(world: InstancedWorld, scene: Scene, o, d,
                        tmin) -> Hit:
    """Closest hit: base-scene primitives (brute/mm) + per-instance local
    BVH traversal with the ray pulled into mesh space. Hit t is computed
    in local coordinates but is world-valid because o AND d transform
    through the same affine map (p(t) = o + t d commutes with it)."""
    from ..ops import traverse

    o = jnp.asarray(o, jnp.float32)
    d = jnp.asarray(d, jnp.float32)
    base = world._base_scene
    hit = isect_mod.intersect(base, o, d, tmin)
    best_t = jnp.where(hit.hit, hit.t, jnp.inf)
    best_idx = hit.prim_idx
    best_type = hit.prim_type
    any_hit = hit.hit

    for inst in world.instances:
        mesh = world.meshes[inst.mesh_id]
        minv = np.linalg.inv(inst.transform)
        a = jnp.asarray(minv[:3, :3], jnp.float32)
        t3 = jnp.asarray(minv[:3, 3], jnp.float32)
        o_l = isect_mod.rows_dot(a[None], o[:, None, :]) + t3
        d_l = isect_mod.rows_dot(a[None], d[:, None, :])
        h = traverse.intersect_bvh(mesh.local_scene, o_l, d_l, tmin)
        better = h.hit & (h.t < best_t)
        best_t = jnp.where(better, h.t, best_t)
        # Global triangle row: the instance block shares the BLAS's
        # local order, so the mapping is a plain offset.
        gid = inst.start + h.prim_idx
        best_idx = jnp.where(better, gid, best_idx)
        best_type = jnp.where(better,
                              jnp.asarray(isect_mod.PRIM_TRIANGLE), best_type)
        any_hit = any_hit | better

    return Hit(t=jnp.where(any_hit, best_t, isect_mod.T_MAX),
               prim_type=best_type, prim_idx=best_idx, hit=any_hit)
