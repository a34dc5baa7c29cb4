"""Pooled-wavefront integrator (ops/wavefront.py): equivalence with the
chunked path. Per-sample values are bit-identical by construction (same
(key, sample, pixel, bounce) randomness); per-pixel sums may differ by
float addition order only, so comparisons use a tight tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer_project_tpu.models import camera as cam_mod
from raytracer_project_tpu.models import environment as env_mod
from raytracer_project_tpu.models import presets
from raytracer_project_tpu.models.scene import SceneBuilder
from raytracer_project_tpu.ops import integrator


def _scene():
    b = SceneBuilder()
    red = b.materials.lambertian("red", (0.7, 0.2, 0.1))
    gray = b.materials.lambertian("gray", (0.5, 0.5, 0.5))
    glass = b.materials.dielectric("glass", 1.5)
    mirror = b.materials.metal("mirror", (0.9, 0.9, 0.9), fuzz=0.02)
    lamp = b.materials.diffuse_light("lamp", (5.0, 5.0, 5.0))
    b.geometry.add_sphere((0.0, -100.5, 0.0), 100.0, gray)
    b.geometry.add_sphere((0.0, 0.5, 0.0), 0.5, glass)
    b.geometry.add_sphere((-1.2, 0.5, 0.0), 0.5, mirror)
    b.geometry.add_sphere((1.2, 0.5, 0.0), 0.5, red)
    b.geometry.add_sphere((0.0, 3.0, 0.0), 0.8, lamp)
    return b.build(with_bvh=False)


def _cam(w, h):
    return cam_mod.make_camera(image_width=w, image_height=h, vfov=40.0,
                               lookfrom=(0.0, 1.0, 4.0), lookat=(0.0, 0.5, 0.0))


def _render(scene, cfg, key):
    cam = _cam(cfg.width, cfg.height)
    env = env_mod.make_environment(sun_direction=(0.3, 0.8, 0.2),
                                   sun_intensity=4.0)
    return jax.jit(integrator.render, static_argnames="config")(
        scene, cam, env, key, cfg
    )


def _assert_buffers_close(a, b, rtol=3e-4, atol=3e-5):
    for k in a:
        np.testing.assert_allclose(
            np.asarray(a[k]), np.asarray(b[k]), rtol=rtol, atol=atol,
            err_msg=f"buffer {k}",
        )


def test_pool_matches_chunked_all_buffers(key):
    scene = _scene()
    base = dict(width=32, height=24, samples_per_pixel=6, max_depth=5,
                env_mode=env_mod.PHYSICAL_SUN,
                use_reflection=True, use_refraction=True)
    r1 = _render(scene, integrator.RenderConfig(**base), key)
    r2 = _render(
        scene,
        integrator.RenderConfig(**base, wavefront=True, pool_lanes=640),
        key,
    )
    for k, v in r2.items():
        assert bool(jnp.all(jnp.isfinite(v))), k
    _assert_buffers_close(r1, r2)


def test_pool_pixel_window_matches_full_frame(key):
    """The identity pixel-window mode (one shard's slice of the frame, as
    parallel.render drives it) sums exactly the full frame's samples for
    those pixels; trailing lanes past the frame clamp to the last pixel."""
    scene = _scene()
    cfg = integrator.RenderConfig(
        width=12, height=8, samples_per_pixel=3, max_depth=4,
        env_mode=env_mod.PHYSICAL_SUN, wavefront=True, pool_lanes=256,
    )
    cam = _cam(12, 8)
    env = env_mod.make_environment()
    full = integrator.accumulate_samples(scene, cam, env, key, cfg, None)
    n_local, off = 40, 64   # window [64, 104) overhangs the 96-pixel frame
    win = integrator.accumulate_samples(
        scene, cam, env, key, cfg, None, pixel_offset=off,
        n_pixels_local=n_local)
    ids = np.minimum(np.arange(off, off + n_local), cfg.n_pixels - 1)
    for name in full._fields:
        np.testing.assert_allclose(
            np.asarray(getattr(win, name)),
            np.asarray(getattr(full, name))[ids],
            rtol=3e-4, atol=3e-5, err_msg=name,
        )


def test_pool_bigger_than_work(key):
    """Pool larger than the total work list: tail handling / idle lanes."""
    scene = _scene()
    base = dict(width=8, height=6, samples_per_pixel=2, max_depth=4,
                env_mode=env_mod.SOLID_COLOR)
    r1 = _render(scene, integrator.RenderConfig(**base), key)
    r2 = _render(
        scene,
        integrator.RenderConfig(**base, wavefront=True, pool_lanes=4096),
        key,
    )
    _assert_buffers_close(r1, r2)


def test_pool_progressive_offset_matches(key):
    """accumulate_samples contract: sums with a sample_offset line up so
    progressive sessions can mix pooled and chunked steps."""
    scene = _scene()
    cfg = integrator.RenderConfig(
        width=16, height=12, samples_per_pixel=3, max_depth=4,
        env_mode=env_mod.PHYSICAL_SUN, wavefront=True, pool_lanes=512,
    )
    cfg_chunked = integrator.RenderConfig(
        width=16, height=12, samples_per_pixel=3, max_depth=4,
        env_mode=env_mod.PHYSICAL_SUN,
    )
    cam = _cam(16, 12)
    env = env_mod.make_environment()
    ids = jnp.arange(16 * 12, dtype=jnp.int32)
    acc_pool = integrator.accumulate_samples(
        scene, cam, env, key, cfg, ids, sample_offset=5
    )
    acc_chunk = integrator.accumulate_samples(
        scene, cam, env, key, cfg_chunked, ids, sample_offset=5
    )
    for name in acc_pool._fields:
        np.testing.assert_allclose(
            np.asarray(getattr(acc_pool, name)),
            np.asarray(getattr(acc_chunk, name)),
            rtol=3e-4, atol=3e-5, err_msg=name,
        )


def test_pool_with_volumes(key):
    """Fog volumes ride the same stochastic keys in both schedulers."""
    b = SceneBuilder()
    gray = b.materials.lambertian("gray", (0.6, 0.6, 0.6))
    b.geometry.add_sphere((0.0, -100.5, 0.0), 100.0, gray)
    b.geometry.add_sphere((0.0, 0.5, 0.0), 0.5, gray)
    b.add_fog_sphere((0.0, 0.5, 0.0), 2.0, 0.4, (0.8, 0.8, 0.8))
    scene = b.build(with_bvh=False)
    base = dict(width=16, height=12, samples_per_pixel=4, max_depth=5,
                env_mode=env_mod.SOLID_COLOR)
    r1 = _render(scene, integrator.RenderConfig(**base), key)
    r2 = _render(
        scene, integrator.RenderConfig(**base, wavefront=True, pool_lanes=256),
        key,
    )
    _assert_buffers_close(r1, r2)
