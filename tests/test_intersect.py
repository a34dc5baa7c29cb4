"""Intersection unit/property tests — golden values from the quadratic and
Möller-Trumbore closed forms (sphere.hpp:18-64, triangle.hpp:17-82)."""

import jax.numpy as jnp
import numpy as np
import pytest

from raytracer_project_tpu.models.geometry import PRIM_SPHERE, PRIM_TRIANGLE
from raytracer_project_tpu.models.scene import SceneBuilder
from raytracer_project_tpu.ops import intersect


def _simple_scene(**kw):
    b = SceneBuilder()
    mat = b.materials.lambertian("m", (0.5, 0.5, 0.5))
    for args in kw.get("spheres", []):
        b.geometry.add_sphere(*args, mat)
    for tri in kw.get("triangles", []):
        b.geometry.add_triangles(*tri, mat_id=mat)
    return b.build(with_bvh=False)


def test_sphere_hit_golden():
    # Unit sphere at origin, ray from z=5 looking down -z: t = 4.
    scene = _simple_scene(spheres=[((0.0, 0.0, 0.0), 1.0)])
    o = jnp.asarray([[0.0, 0.0, 5.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    hit = intersect.intersect_brute(scene, o, d, 1e-3)
    assert bool(hit.hit[0])
    assert np.isclose(hit.t[0], 4.0, atol=1e-5)
    assert hit.prim_type[0] == PRIM_SPHERE


def test_sphere_inside_hit_far_root():
    # Origin inside the sphere: nearest root is negative, far root = 1.
    scene = _simple_scene(spheres=[((0.0, 0.0, 0.0), 1.0)])
    o = jnp.zeros((1, 3))
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    hit = intersect.intersect_brute(scene, o, d, 1e-3)
    assert bool(hit.hit[0])
    assert np.isclose(hit.t[0], 1.0, atol=1e-5)


def test_sphere_miss():
    scene = _simple_scene(spheres=[((0.0, 0.0, 0.0), 1.0)])
    o = jnp.asarray([[0.0, 5.0, 5.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    hit = intersect.intersect_brute(scene, o, d, 1e-3)
    assert not bool(hit.hit[0])


def test_unnormalized_direction():
    # t scales inversely with |d| (reference never normalizes camera rays).
    scene = _simple_scene(spheres=[((0.0, 0.0, 0.0), 1.0)])
    o = jnp.asarray([[0.0, 0.0, 5.0]])
    d = jnp.asarray([[0.0, 0.0, -2.0]])
    hit = intersect.intersect_brute(scene, o, d, 1e-3)
    assert np.isclose(hit.t[0], 2.0, atol=1e-5)


def test_triangle_hit_and_miss():
    tri = ([[0.0, 0.0, 0.0]], [[1.0, 0.0, 0.0]], [[0.0, 1.0, 0.0]])
    scene = _simple_scene(triangles=[tri])
    o = jnp.asarray([[0.2, 0.2, 3.0], [0.9, 0.9, 3.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    hit = intersect.intersect_brute(scene, o, d, 1e-3)
    assert bool(hit.hit[0]) and np.isclose(hit.t[0], 3.0, atol=1e-5)
    assert hit.prim_type[0] == PRIM_TRIANGLE
    assert not bool(hit.hit[1])  # outside the hypotenuse


def test_triangle_two_sided():
    tri = ([[0.0, 0.0, 0.0]], [[1.0, 0.0, 0.0]], [[0.0, 1.0, 0.0]])
    scene = _simple_scene(triangles=[tri])
    o = jnp.asarray([[0.2, 0.2, -3.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    hit = intersect.intersect_brute(scene, o, d, 1e-3)
    assert bool(hit.hit[0])


def test_closest_of_many():
    scene = _simple_scene(
        spheres=[((0.0, 0.0, -10.0), 1.0), ((0.0, 0.0, -5.0), 1.0),
                 ((0.0, 0.0, -20.0), 1.0)]
    )
    o = jnp.zeros((1, 3))
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    hit = intersect.intersect_brute(scene, o, d, 1e-3)
    assert np.isclose(hit.t[0], 4.0, atol=1e-5)
    # Table rows are Morton-ordered at pack time; resolve the winner by its
    # geometry, not its insertion index.
    np.testing.assert_allclose(
        np.asarray(scene.spheres.center)[int(hit.prim_idx[0])],
        [0.0, 0.0, -5.0], atol=1e-6,
    )


def test_record_sphere_normals_and_uv():
    scene = _simple_scene(spheres=[((0.0, 0.0, 0.0), 1.0)])
    o = jnp.asarray([[0.0, 0.0, 5.0], [0.0, 0.0, 0.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    hit = intersect.intersect_brute(scene, o, d, 1e-3)
    rec = intersect.make_record(scene, o, d, hit)
    # Outside hit: front face, outward normal +z.
    assert bool(rec.front_face[0])
    np.testing.assert_allclose(rec.normal[0], [0.0, 0.0, 1.0], atol=1e-5)
    # Inside hit: back face, normal flipped toward the ray origin.
    assert not bool(rec.front_face[1])
    np.testing.assert_allclose(rec.normal[1], [0.0, 0.0, 1.0], atol=1e-5)
    # UV at +z point: phi = atan2(-1, 0) + pi = pi/2 -> u = 0.25;
    # theta = acos(0) -> v = 0.5 (sphere.hpp:70-79).
    assert np.isclose(rec.u[0], 0.25, atol=1e-5)
    assert np.isclose(rec.v[0], 0.5, atol=1e-5)


def test_record_triangle_smooth_normal():
    # Vertex normals tilted: interpolation at centroid = average direction.
    tri = dict(
        v0=[[0.0, 0.0, 0.0]], v1=[[1.0, 0.0, 0.0]], v2=[[0.0, 1.0, 0.0]],
        n0=[[0.0, 0.0, 1.0]], n1=[[1.0, 0.0, 1.0]], n2=[[0.0, 1.0, 1.0]],
    )
    b = SceneBuilder()
    mat = b.materials.lambertian("m")
    b.geometry.add_triangles(**tri, mat_id=mat)
    scene = b.build(with_bvh=False)
    o = jnp.asarray([[1 / 3, 1 / 3, 3.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    hit = intersect.intersect_brute(scene, o, d, 1e-3)
    rec = intersect.make_record(scene, o, d, hit)
    expected = np.asarray([1 / 3, 1 / 3, 1.0])
    expected /= np.linalg.norm(expected)
    np.testing.assert_allclose(rec.normal[0], expected, atol=1e-4)


def test_box_native_world_hits():
    b = SceneBuilder()
    mat = b.materials.lambertian("m")
    b.geometry.add_box((-1, -1, -1), (1, 1, 1), mat)
    scene = b.build(with_bvh=False)
    assert scene.boxes.count == 1          # native affine-slab box
    assert scene.triangles.count == 1      # dummy row only
    o = jnp.asarray([[0.0, 0.0, 5.0], [0.0, 0.0, 0.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    hit = intersect.intersect_brute(scene, o, d, 1e-3)
    # Outside: entry face at t=4. Inside: exit face at t=1 (correct exit,
    # unlike the reference cube's t=tmin quirk, cube.hpp:47-73).
    assert np.isclose(hit.t[0], 4.0, atol=1e-5)
    assert np.isclose(hit.t[1], 1.0, atol=1e-5)


def test_box_native_matches_tessellated():
    """The native affine-slab box must reproduce the 12-triangle box: same
    hit set, same t, same shading frame (normal/UV/tangent), for random
    rays against a rotated+scaled box."""
    rng = np.random.default_rng(5)
    from raytracer_project_tpu.models import geometry as geo

    xform = geo.compose(
        geo.translate((0.5, 1.0, -0.3)),
        geo.rotate_y(37.0),
        geo.rotate_x(12.0),
        geo.scale((1.5, 0.7, 1.1)),
    )

    def build(tessellate):
        b = SceneBuilder()
        mat = b.materials.lambertian("m")
        b.geometry.add_box((-0.4, -0.2, -0.6), (0.4, 0.2, 0.6), mat,
                           transform=xform, tessellate=tessellate)
        return b.build(with_bvh=False)

    s_box = build(False)
    s_tri = build(True)
    n = 256
    o = jnp.asarray(rng.normal(0, 3, (n, 3)), jnp.float32)
    d = jnp.asarray(rng.normal(0, 1, (n, 3)), jnp.float32)
    hb = intersect.intersect_brute(s_box, o, d, 1e-3)
    ht = intersect.intersect_brute(s_tri, o, d, 1e-3)
    # Rays through face seams may differ at float edge cases; demand > 95%
    # agreement and exact-f32-tolerance t on the agreeing set.
    agree = np.asarray(hb.hit) == np.asarray(ht.hit)
    assert agree.mean() > 0.95
    m = np.asarray(hb.hit) & np.asarray(ht.hit)
    np.testing.assert_allclose(np.asarray(hb.t)[m], np.asarray(ht.t)[m],
                               rtol=1e-4, atol=1e-4)
    rb = intersect.make_record(s_box, o, d, hb)
    rt = intersect.make_record(s_tri, o, d, ht)
    np.testing.assert_allclose(np.asarray(rb.normal)[m],
                               np.asarray(rt.normal)[m], atol=2e-3)
    np.testing.assert_allclose(np.asarray(rb.u)[m], np.asarray(rt.u)[m],
                               atol=2e-3)
    np.testing.assert_allclose(np.asarray(rb.v)[m], np.asarray(rt.v)[m],
                               atol=2e-3)
    np.testing.assert_allclose(np.asarray(rb.tangent)[m],
                               np.asarray(rt.tangent)[m], atol=2e-3)


def test_degenerate_dummies_never_hit():
    scene = _simple_scene()  # only dummy rows
    o = jnp.zeros((4, 3))
    d = jnp.asarray([[0.0, 0.0, -1.0]] * 4)
    hit = intersect.intersect_brute(scene, o, d, 1e-3)
    assert not np.any(hit.hit)


@pytest.mark.parametrize("n_prims,with_bvh,route", [
    (3, False, "brute"),
    (3, True, "brute"),
    (64, False, "brute"),
    (64, True, "bvh"),
])
def test_dispatch_routes_by_count_and_bvh(monkeypatch, n_prims, with_bvh,
                                          route):
    """intersect_dispatch reads only the primitive count and BVH presence
    (the crossover is lowered so a tiny scene can sit on either side)."""
    monkeypatch.setattr(intersect, "BVH_MIN_PRIMS", 32)
    b = SceneBuilder()
    mat = b.materials.lambertian("m")
    for i in range(n_prims - 2):       # + triangle and box dummy rows
        b.geometry.add_sphere((float(i), 0.0, 0.0), 0.4, mat)
    scene = b.build(with_bvh=with_bvh)
    assert scene.primitive_count == n_prims
    assert intersect.intersect_dispatch(scene) == route
    # intersect() follows the decision and agrees with the brute oracle.
    o = jnp.asarray([[0.0, 0.0, 5.0], [float(n_prims - 3), 0.0, 5.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]] * 2)
    got = intersect.intersect(scene, o, d, 1e-3)
    ref = intersect.intersect_brute(scene, o, d, 1e-3)
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(ref.hit))
    np.testing.assert_allclose(np.asarray(got.t), np.asarray(ref.t),
                               rtol=1e-6)


def _box_table(rng, n):
    """n random affine boxes: world->local rows minv [n, 9], trans [n, 3]."""
    from raytracer_project_tpu.models import geometry as geo

    minv, trans = [], []
    for _ in range(n):
        xf = geo.compose(geo.translate(rng.uniform(-3, 3, 3)),
                         geo.rotate_y(rng.uniform(0, 90)),
                         geo.rotate_x(rng.uniform(0, 90)),
                         geo.scale(rng.uniform(0.3, 2.0, 3)))
        inv = np.linalg.inv(xf)
        minv.append(inv[:3, :3].reshape(9))
        trans.append(inv[:3, 3])
    return np.asarray(minv), np.asarray(trans)


def test_box_slab_matches_float64(rng):
    """box_candidate_t's local-frame transform is an f32 elementwise sum;
    it must agree with a float64 NumPy slab test at f32 tolerance."""
    minv, trans = _box_table(rng, 24)
    o = rng.normal(0, 6, (256, 3))
    d = rng.normal(0, 1, (256, 3))
    got = np.asarray(intersect.box_candidate_t(
        jnp.asarray(minv, jnp.float32), jnp.asarray(trans, jnp.float32),
        jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32),
        jnp.full((256,), 1e-3, jnp.float32),
        jnp.full((256,), 1e30, jnp.float32)))
    m = minv.reshape(-1, 3, 3)
    o_l = np.einsum("cij,nj->nci", m, o) + trans[None]
    d_l = np.einsum("cij,nj->nci", m, d)
    t0, t1 = (-1.0 - o_l) / d_l, (1.0 - o_l) / d_l
    tn = np.minimum(t0, t1).max(-1)
    tf = np.maximum(t0, t1).min(-1)
    t = np.where(tn > 1e-3, tn, tf)
    valid = (tn < tf) & (t > 1e-3)
    ref = np.where(valid, t, 1e30)
    # Knife-edge rays (entry == exit within f32 resolution) may flip.
    clear = np.abs(tf - tn) > 1e-3 * np.maximum(np.abs(tf), 1.0)
    assert valid.sum() > 50
    np.testing.assert_array_equal((got < 1e30)[clear], valid[clear])
    both = valid & (got < 1e30)
    np.testing.assert_allclose(got[both], ref[both], rtol=2e-5, atol=2e-5)


def test_box_record_matches_float64(rng):
    """_box_record_from (local hit point, face normal, UV, tangent through
    one-hot row sums) against a float64 NumPy evaluation of the same
    cube.hpp:100-142 rules."""
    minv, trans = _box_table(rng, 64)
    # A hit point on a random face of each box: local p_l, world p.
    face_axis = rng.integers(0, 3, 64)
    sign = rng.choice([-1.0, 1.0], 64)
    p_l = rng.uniform(-0.8, 0.8, (64, 3))
    p_l[np.arange(64), face_axis] = sign
    m = minv.reshape(-1, 3, 3)
    p = np.einsum("nij,nj->ni", np.linalg.inv(m), p_l - trans)
    o = p + rng.normal(0, 1, (64, 3)) * 3.0
    d = p - o
    g = np.concatenate([minv, trans, np.zeros((64, 1))], axis=1)
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    pp, normal, tangent, _, front, u, v, _ = intersect._box_record_from(
        f32(g), f32(o), f32(d), jnp.ones((64,), jnp.float32))
    l = np.einsum("nij,nj->ni", m, p) + trans
    np.testing.assert_allclose(np.asarray(pp), p, rtol=1e-5, atol=1e-5)
    face = face_axis * 2 + (sign > 0)
    out = sign[:, None] * m[np.arange(64), face_axis]
    out /= np.linalg.norm(out, axis=-1, keepdims=True)
    fr = np.einsum("ni,ni->n", d, out) < 0.0
    np.testing.assert_array_equal(np.asarray(front), fr)
    np.testing.assert_allclose(np.asarray(normal),
                               np.where(fr[:, None], out, -out), atol=1e-5)
    fu = np.asarray(intersect._BOX_FACE_U, np.float64)[face]
    fv = np.asarray(intersect._BOX_FACE_V, np.float64)[face]
    np.testing.assert_allclose(np.asarray(u), (l * fu).sum(-1) * 0.5 + 0.5,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(v), (l * fv).sum(-1) * 0.5 + 0.5,
                               atol=1e-5)
    tan = np.einsum("ni,nij->nj",
                    np.asarray(intersect._BOX_FACE_TAN, np.float64)[face], m)
    tan /= np.linalg.norm(tan, axis=-1, keepdims=True)
    np.testing.assert_allclose(np.asarray(tangent), tan, atol=1e-5)
