"""Two-level instancing (models/instances.py): BLAS reuse + O(block)
incremental instance moves + the two-level query path.

Reference parity target: per-mesh sub-BVH reuse across scene rebuilds
(/root/reference/model.hpp:95; build_geometry re-instantiates around the
cached model, main.cpp:1492-1500)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracer_project_tpu.models import geometry as geom_mod
from raytracer_project_tpu.models.instances import (
    InstancedWorld, intersect_instanced)
from raytracer_project_tpu.models.scene import SceneBuilder
from raytracer_project_tpu.ops import intersect

pytestmark = pytest.mark.slow


def _tetra(scale=1.0):
    """Four-triangle tetrahedron in local space."""
    p = np.asarray([[0, 0, 0], [1, 0, 0], [0.5, 1, 0], [0.5, 0.4, 1.0]],
                   np.float64) * scale
    faces = [(0, 1, 2), (0, 1, 3), (1, 2, 3), (0, 2, 3)]
    v0 = np.stack([p[a] for a, _, _ in faces])
    v1 = np.stack([p[b] for _, b, _ in faces])
    v2 = np.stack([p[c] for _, _, c in faces])
    return v0, v1, v2


def _grid_mesh(n=6, scale=1.0):
    """2*n*n-triangle height-field patch (enough rows to span chunks)."""
    xs = np.linspace(0, 1, n + 1)
    v0, v1, v2 = [], [], []
    for i in range(n):
        for j in range(n):
            a = [xs[i], 0.1 * np.sin(i + j), xs[j]]
            b = [xs[i + 1], 0.1 * np.sin(i + 1 + j), xs[j]]
            c = [xs[i], 0.1 * np.sin(i + j + 1), xs[j + 1]]
            dd = [xs[i + 1], 0.1 * np.sin(i + j + 2), xs[j + 1]]
            v0 += [a, b]
            v1 += [b, dd]
            v2 += [c, c]
    arr = lambda x: np.asarray(x, np.float64) * scale
    return arr(v0), arr(v1), arr(v2)


def _world(n_instances=3):
    w = InstancedWorld()
    mid = w.add_mesh(*_grid_mesh(6), name="patch")
    b = SceneBuilder()
    red = b.materials.lambertian("red", (0.7, 0.2, 0.2))
    b.geometry.add_sphere((0.0, -100.5, 0.0), 100.0, red)
    for i in range(n_instances):
        w.add_instance(mid, geom_mod.translate((2.0 * i, 0.5, 0.0)), red)
    return w, b


def _flat_equivalent(w: InstancedWorld, builder: SceneBuilder):
    """From-scratch flat build of the same world (the oracle)."""
    b2 = SceneBuilder()
    red = b2.materials.lambertian("red", (0.7, 0.2, 0.2))
    b2.geometry.add_sphere((0.0, -100.5, 0.0), 100.0, red)
    for inst in w.instances:
        mesh = w.meshes[inst.mesh_id]
        b2.geometry.add_triangles(mesh.v0, mesh.v1, mesh.v2, red,
                                  n0=mesh.n0, n1=mesh.n1, n2=mesh.n2,
                                  transform=inst.transform)
    return b2.build(with_bvh=False)


def _rays(n=512, seed=0):
    o = jax.random.normal(jax.random.PRNGKey(seed), (n, 3)) * 2 + jnp.asarray(
        [2.0, 3.0, 6.0])
    d = jax.random.normal(jax.random.PRNGKey(seed + 1), (n, 3))
    return o, d


def test_build_matches_flat_world():
    w, b = _world()
    scene = w.build(b)
    o, d = _rays()
    got = intersect.intersect(scene, o, d, 1e-3)
    # Flat oracle hits the same surfaces at the same t.
    flat = _flat_equivalent(w, b)
    ref = intersect.intersect(flat, o, d, 1e-3)
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(ref.hit))
    m = np.asarray(got.hit)
    np.testing.assert_allclose(np.asarray(got.t)[m], np.asarray(ref.t)[m],
                               rtol=1e-5, atol=1e-5)


def test_instance_move_is_incremental_and_exact():
    w, b = _world(n_instances=3)
    scene = w.build(b)
    total = scene.triangles.count
    mesh_k = w.meshes[0].count
    assert total >= 3 * mesh_k

    # Move instance 1 only.
    w.triangles_recomputed = 0
    w.set_transform(1, geom_mod.translate((2.0, 1.7, -0.5)))
    scene2 = w.rebuild()

    # Host work touched ONLY the moved block — sublinear in total tris.
    assert w.triangles_recomputed == mesh_k

    # The untouched instances' table slices are bit-identical.
    s0 = w.instances[0].start
    s2 = w.instances[2].start
    for sl in (slice(s0, s0 + mesh_k), slice(s2, s2 + mesh_k)):
        np.testing.assert_array_equal(np.asarray(scene.triangles.v0)[sl],
                                      np.asarray(scene2.triangles.v0)[sl])

    # And the incremental scene equals a from-scratch flat build.
    flat = _flat_equivalent(w, b)
    o, d = _rays(seed=3)
    got = intersect.intersect(scene2, o, d, 1e-3)
    ref = intersect.intersect(flat, o, d, 1e-3)
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(ref.hit))
    m = np.asarray(got.hit)
    np.testing.assert_allclose(np.asarray(got.t)[m], np.asarray(ref.t)[m],
                               rtol=1e-5, atol=1e-5)
    # Triangle tables agree with a full build of the moved world (same
    # block layout -> directly comparable).
    w_full, b_full = _world(n_instances=3)
    w_full.set_transform(1, geom_mod.translate((2.0, 1.7, -0.5)))
    full = w_full.build(b_full)
    for k in ("v0", "e1", "e2", "n0", "n1", "n2"):
        np.testing.assert_allclose(np.asarray(getattr(scene2.triangles, k)),
                                   np.asarray(getattr(full.triangles, k)),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_blas_shared_and_reused():
    w = InstancedWorld()
    mid = w.add_mesh(*_tetra(), name="tet")
    b = SceneBuilder()
    red = b.materials.lambertian("red", (0.7, 0.2, 0.2))
    w.add_instance(mid, geom_mod.translate((0, 0, 0)), red)
    w.add_instance(mid, geom_mod.translate((3, 0, 0)), red)
    w.build(b)
    blas_before = w.meshes[0].local_bvh
    w.set_transform(0, geom_mod.translate((0, 2, 0)))
    w.rebuild()
    # The per-mesh sub-BVH survives rebuilds untouched (model.hpp:95).
    assert w.meshes[0].local_bvh is blas_before


def test_two_level_query_matches_brute():
    w, b = _world(n_instances=2)
    scene = w.build(b)
    o, d = _rays(n=256, seed=7)
    got = intersect_instanced(w, scene, o, d, 1e-3)
    ref = intersect.intersect_brute(scene, o, d, 1e-3)
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(ref.hit))
    m = np.asarray(got.hit) & np.asarray(ref.hit)
    tg, tr = np.asarray(got.t)[m], np.asarray(ref.t)[m]
    np.testing.assert_allclose(tg, tr, rtol=2e-4, atol=2e-4)
    # Matching ids where t is unambiguous.
    idg = np.asarray(got.prim_idx)[m]
    idr = np.asarray(ref.prim_idx)[m]
    tyg = np.asarray(got.prim_type)[m]
    tyr = np.asarray(ref.prim_type)[m]
    amb = np.isclose(tg, tr, rtol=1e-5)
    bad = ((idg != idr) | (tyg != tyr)) & ~amb
    assert not bad.any()
