"""S7 gradient parity: jax.grad of the render vs central finite differences
(BASELINE.md "gradient parity" row), plus an end-to-end inverse-rendering
fit. Everything runs a tiny deterministic config so the loss surface is an
exact function and FD is a valid oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer_project_tpu.diff import (
    RenderState,
    extract_params,
    fit,
    render_beauty,
)
from raytracer_project_tpu.diff.inverse import finite_difference_grad, make_loss_fn
from raytracer_project_tpu.models import camera as cam_mod
from raytracer_project_tpu.models import environment as env_mod
from raytracer_project_tpu.models.scene import SceneBuilder
from raytracer_project_tpu.ops import integrator


def _tiny_state(env_mode):
    b = SceneBuilder()
    red = b.materials.lambertian("red", (0.7, 0.2, 0.1))
    gray = b.materials.lambertian("gray", (0.5, 0.5, 0.5))
    lamp = b.materials.diffuse_light("lamp", (4.0, 4.0, 4.0))
    metal = b.materials.metal("mirror", (0.9, 0.9, 0.9), fuzz=0.1)
    b.geometry.add_sphere((0.0, 1.0, 0.0), 1.0, red)
    b.geometry.add_sphere((0.0, -100.0, 0.0), 100.0, gray)
    b.geometry.add_sphere((2.2, 1.0, -1.0), 0.7, metal)
    b.geometry.add_sphere((-2.0, 2.5, 1.0), 0.5, lamp)
    scene = b.build(with_bvh=False)

    cam = cam_mod.make_camera(
        image_width=24, image_height=16, vfov=40.0,
        lookfrom=(0.0, 2.0, 8.0), lookat=(0.0, 1.0, 0.0),
        defocus_angle=0.0,
    )
    env = env_mod.make_environment(
        background_color=(0.3, 0.5, 0.9),
        sun_direction=(0.4, 0.8, 0.2), sun_intensity=4.0,
    )
    cfg = integrator.RenderConfig(
        width=24, height=16, samples_per_pixel=2, max_depth=4,
        env_mode=env_mode,
        use_albedo=False, use_normal=False, use_z_depth=False,
    )
    return RenderState(scene=scene, cam=cam, env=env), cfg


def _fd_check(state, cfg, key, path, index, rtol=0.08, eps=1e-3):
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    loss_fn, params = make_loss_fn(state, cfg, target, [path])
    g = jax.grad(loss_fn)(params, key)[path]
    g_i = float(jnp.ravel(g)[index])
    fd = finite_difference_grad(loss_fn, params, path, index, key, eps=eps)
    assert np.isfinite(g_i) and np.isfinite(fd)
    # Both near zero is a pass; otherwise relative agreement.
    if abs(fd) < 1e-6 and abs(g_i) < 1e-6:
        return
    np.testing.assert_allclose(g_i, fd, rtol=rtol, atol=1e-5)


@pytest.mark.slow
def test_grad_albedo_matches_fd(key):
    state, cfg = _tiny_state(env_mod.SOLID_COLOR)
    # red channel of material 0 ("red" lambertian)
    _fd_check(state, cfg, key, "scene.materials.albedo", 0)


def test_grad_emission_matches_fd(key):
    state, cfg = _tiny_state(env_mod.SOLID_COLOR)
    # lamp emission green channel: albedo row 2 (lamp id), col 1
    _fd_check(state, cfg, key, "scene.materials.albedo", 2 * 3 + 1)


def test_grad_background_matches_fd(key):
    state, cfg = _tiny_state(env_mod.SOLID_COLOR)
    _fd_check(state, cfg, key, "env.background_color", 2)


def test_grad_sun_intensity_matches_fd(key):
    state, cfg = _tiny_state(env_mod.PHYSICAL_SUN)
    _fd_check(state, cfg, key, "env.sun_intensity", 0)


def test_grad_metal_fuzz_matches_fd(key):
    state, cfg = _tiny_state(env_mod.SOLID_COLOR)
    # fuzz of the mirror material (param row 3)
    _fd_check(state, cfg, key, "scene.materials.param", 3, rtol=0.15)


@pytest.mark.slow
def test_grad_geometry_finite(key):
    """Gradients w.r.t. sphere centers/radii must be finite (the safe_sqrt
    double-where in the intersection kernels): detached-sampling ignores
    silhouette terms but the interior geometry term must not be NaN.

    Uses the sun-sky mode: with a direction-*independent* solid background
    and untextured diffuse materials the continuous geometry gradient is
    legitimately zero (normals only steer directions); the sky gradient
    makes escaping radiance direction-dependent, so centers get signal."""
    state, cfg = _tiny_state(env_mod.PHYSICAL_SUN)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    loss_fn, params = make_loss_fn(
        state, cfg, target,
        ["scene.spheres.center", "scene.spheres.radius"],
    )
    grads = jax.grad(loss_fn)(params, key)
    for path, g in grads.items():
        assert bool(jnp.all(jnp.isfinite(g))), f"non-finite grad in {path}"
    # The visible hero sphere's center must actually receive signal.
    assert float(jnp.max(jnp.abs(grads["scene.spheres.center"]))) > 0.0


@pytest.mark.slow
def test_grad_showcase_scale_matches_fd(key):
    """Detached-traversal AD at full showcase scale (SURVEY §7/S7): the
    1,400+-primitive scene keeps its BVH — the traversal runs detached,
    the chosen-hit t is re-derived differentiably — and jax.grad still
    matches finite differences."""
    from raytracer_project_tpu.models import presets

    scene = presets.showcase_scene(with_bvh=True, with_meshes=True)
    assert scene.bvh is not None
    cam = cam_mod.make_camera(
        image_width=16, image_height=12, vfov=30.0,
        lookfrom=(12.0, 2.5, 6.0), lookat=(0.0, 1.0, 0.0),
    )
    env = env_mod.make_environment(sun_direction=(0.4, 0.7, 0.2),
                                   sun_intensity=6.0)
    cfg = integrator.RenderConfig(
        width=16, height=12, samples_per_pixel=1, max_depth=3,
        env_mode=env_mod.PHYSICAL_SUN, differentiable=True,
        use_albedo=False, use_normal=False, use_z_depth=False,
    )
    state = RenderState(scene=scene, cam=cam, env=env)
    _fd_check(state, cfg, key, "env.sun_intensity", 0, rtol=0.1)
    # Material albedo of the ground material also gets signal.
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    loss_fn, params = make_loss_fn(state, cfg, target,
                                   ["scene.materials.albedo"])
    g = jax.grad(loss_fn)(params, key)["scene.materials.albedo"]
    assert bool(jnp.all(jnp.isfinite(g)))
    assert float(jnp.max(jnp.abs(g))) > 0.0


def test_detached_intersect_t_grad_matches_fd():
    """The interior geometry term of detached-sampling: d t / d center from
    intersect_detached must match finite differences of the hit distance
    for rays that stay on the same primitive under the perturbation.

    (Image-level FD is NOT a valid oracle for geometry translations — the
    silhouette term detached-sampling deliberately drops dominates it; the
    continuous term is pinned here at the intersection level instead.)"""
    from raytracer_project_tpu.core.constants import T_MIN
    from raytracer_project_tpu.models.scene import SceneBuilder
    from raytracer_project_tpu.ops import intersect as isect

    def build(dy=0.0):
        b = SceneBuilder()
        m = b.materials.lambertian("m", (0.5, 0.5, 0.5))
        b.geometry.add_sphere((0.0, 1.0 + dy, 0.0), 1.0, m)
        b.geometry.add_box((-3.0, -0.5, -3.0), (3.0, 0.0 + dy, 3.0), m)
        v = np.array([[-1.0, 2.5 + dy, -2.0]], np.float32)
        b.geometry.add_triangles(v, v + [[2.0, 0.0, 0.0]],
                                 v + [[1.0, 1.5, 0.0]], m)
        return b.build(with_bvh=False)

    # Rays aimed square at each primitive (no grazing hits).
    o = jnp.asarray([[0.0, 1.0, 5.0], [0.5, 3.0, 0.5], [0.0, 2.9, 3.0]],
                    jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]],
                    jnp.float32)

    def mean_t(dy):
        scene = build(0.0)
        # Differentiable perturbation applied to the raw tables.
        # World-space +dy translation of every primitive: boxes store the
        # world->local affine, so trans shifts by -minv @ offset.
        off = jnp.asarray([0.0, dy, 0.0])
        m = scene.boxes.minv.reshape(-1, 3, 3)
        scene = scene._replace(
            spheres=scene.spheres._replace(
                center=scene.spheres.center + off),
            triangles=scene.triangles._replace(
                v0=scene.triangles.v0 + off),
            boxes=scene.boxes._replace(
                trans=scene.boxes.trans - jnp.einsum("bij,j->bi", m, off)),
        )
        h = isect.intersect_detached(scene, o, d, T_MIN)
        assert h.hit.shape == (3,)
        return jnp.sum(jnp.where(h.hit, h.t, 0.0))

    g = float(jax.grad(mean_t)(0.0))
    eps = 1e-3
    fd = float((mean_t(eps) - mean_t(-eps)) / (2 * eps))
    assert np.isfinite(g)
    assert abs(fd) > 0.1  # the rays really do hit and t really moves
    np.testing.assert_allclose(g, fd, rtol=5e-3)


@pytest.mark.slow
def test_inverse_rendering_recovers_albedo(key):
    """End-to-end fit: start from a wrong albedo, recover the target image's
    material color by gradient descent (the reference has no equivalent —
    this is the differentiable-framework capability)."""
    pytest.importorskip("optax")
    state, cfg = _tiny_state(env_mod.SOLID_COLOR)
    target = render_beauty(state, key, cfg)

    # Perturb the hero albedo far from the truth.
    wrong = state.scene.materials.albedo.at[0].set(jnp.asarray([0.1, 0.8, 0.9]))
    start = state._replace(
        scene=state.scene._replace(
            materials=state.scene.materials._replace(albedo=wrong)
        )
    )

    def project(params):
        return {k: jnp.clip(v, 0.0, 8.0) for k, v in params.items()}

    fitted, losses = fit(
        start, key, cfg, target, ["scene.materials.albedo"],
        steps=60, learning_rate=5e-2, project=project,
    )
    assert losses[-1] < losses[0] * 0.05, (losses[0], losses[-1])
    got = np.asarray(fitted.scene.materials.albedo[0])
    want = np.asarray(state.scene.materials.albedo[0])
    np.testing.assert_allclose(got, want, atol=0.08)


def test_extract_apply_roundtrip(key):
    state, _ = _tiny_state(env_mod.SOLID_COLOR)
    paths = ["scene.materials.albedo", "env.sun_intensity", "cam.center"]
    params = extract_params(state, paths)
    from raytracer_project_tpu.diff import apply_params

    state2 = apply_params(state, {k: v + 1.0 for k, v in params.items()})
    for p in paths:
        np.testing.assert_allclose(
            np.asarray(extract_params(state2, [p])[p]),
            np.asarray(params[p]) + 1.0,
        )
