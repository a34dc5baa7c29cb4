"""Golden-image regression harness (BASELINE.md "image parity" row).

Policy
------
* Each of the four BASELINE.json render configs has a thumbnail-scale
  deterministic render checked in under tests/goldens/ (generated by
  tools/make_goldens.py on the CPU backend with PRNGKey(0); the lane RNG is
  a pure counter hash of (seed, pixel, sample, bounce) — core/rng.py — so the
  renders are schedule- and shard-invariant by construction).
* Tolerance: allclose atol=2e-4 — renders are replayed on the same CPU
  backend, so the only wiggle is XLA fusion/reassociation noise across jax
  versions, far below 1e-4 in practice. Regenerate goldens only for an
  intentional image-affecting change, and say so in the commit message.
* The reference-quirk knobs built for A/B comparison against the C++ engine
  are exercised here so they prove their keep:
    - ops/bvh.py `median_random_axis` (the reference's actual build
      algorithm, /root/reference/bvh.hpp:15-42) must produce the *same
      image* as the default binned-SAH tree — a BVH changes traversal
      order, never the closest hit.
    - models/geometry.py `rotate_y_radians` reproduces the reference's
      radians/degrees quirk (/root/reference/rotate_y.hpp:9-13 takes
      radians, /root/reference/scene_management.hpp:116 passes degrees):
      rotate_y_radians(x) == rotate_y(degrees(x)), and feeding degrees to
      it reproduces the reference's visual result, distinct from the
      documented intent.
"""

import os

import jax
import numpy as np
import pytest

from raytracer_project_tpu.models import camera as cam_mod
from raytracer_project_tpu.models import environment as env_mod
from raytracer_project_tpu.models import geometry, presets
from raytracer_project_tpu.ops import integrator

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")

KEY = 0  # jax.random.PRNGKey seed for every golden render
ATOL = 2e-4


def _render(scene, cam, env, cfg):
    # Goldens pin the CHUNKED oracle they were generated with: the pooled
    # engine (the product default) is equivalence-tested against it in
    # tests/test_wavefront.py, and its per-pixel sums
    # differ from the chunked path only by float accumulation order —
    # which is exactly what an atol this tight would spuriously flag.
    import dataclasses

    cfg = dataclasses.replace(cfg, wavefront=False)
    return integrator.render(scene, cam, env, jax.random.PRNGKey(KEY), cfg)


def render_shirley():
    """Config 1: Shirley final scene, solid-sky, CPU-runnable baseline."""
    scene = presets.shirley_final_scene(grid=5, with_bvh=True)
    cfg = integrator.RenderConfig(
        width=64, height=36, samples_per_pixel=16, max_depth=8,
        env_mode=env_mod.SOLID_COLOR,
        use_albedo=False, use_normal=False, use_z_depth=False,
    )
    cam = cam_mod.make_camera(
        image_width=64, image_height=36, vfov=20.0,
        lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0),
        defocus_angle=0.6, focus_dist=10.0,
    )
    env = env_mod.make_environment(background_color=(0.70, 0.80, 1.00))
    return _render(scene, cam, env, cfg)


def render_cornell():
    """Config 2: Cornell-style box, emissive area light + fog."""
    scene = presets.cornell_box_scene(with_bvh=True, with_fog=True,
                                      fog_density=0.002)
    cfg = integrator.RenderConfig(
        width=64, height=64, samples_per_pixel=16, max_depth=8,
        env_mode=env_mod.SOLID_COLOR,
        use_albedo=False, use_normal=False, use_z_depth=False,
    )
    cam = cam_mod.make_camera(
        image_width=64, image_height=64, vfov=40.0,
        lookfrom=(278.0, 278.0, -800.0), lookat=(278.0, 278.0, 0.0),
    )
    env = env_mod.make_environment(background_color=(0.0, 0.0, 0.0))
    return _render(scene, cam, env, cfg)


def render_showcase():
    """Config 3: OBJ mesh under BVH, textured PBR + bump maps."""
    scene = presets.showcase_scene(with_bvh=True, with_meshes=True, grid=6)
    cfg = integrator.RenderConfig(
        width=64, height=36, samples_per_pixel=8, max_depth=6,
        env_mode=env_mod.PHYSICAL_SUN,
        use_albedo=False, use_normal=False, use_z_depth=False,
    )
    cam = cam_mod.make_camera(
        image_width=64, image_height=36, vfov=30.0,
        lookfrom=(12.0, 2.5, 6.0), lookat=(0.0, 1.0, 0.0),
    )
    env = env_mod.make_environment(sun_direction=(0.4, 0.7, 0.2),
                                   sun_intensity=6.0)
    return _render(scene, cam, env, cfg)


def _procedural_hdr(h=32, w=64):
    """Tiny deterministic equirect: sky gradient + one hot 'sun' texel
    block — stands in for the 4K .hdr assets stripped from the mount
    (/root/reference/.MISSING_LARGE_BLOBS)."""
    v = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None, None]
    img = (1.0 - v) * np.array([[0.35, 0.55, 1.2]], np.float32) \
        + v * np.array([[0.9, 0.7, 0.5]], np.float32)
    img = np.broadcast_to(img, (h, w, 3)).copy()
    img[h // 4:h // 4 + 2, w // 3:w // 3 + 3] = (40.0, 36.0, 30.0)
    return img


def render_hdri():
    """Config 4: HDRI IBL with yaw/tilt/roll rotation + thin-lens DoF."""
    scene = presets.shirley_final_scene(grid=3, with_bvh=True)
    cfg = integrator.RenderConfig(
        width=64, height=36, samples_per_pixel=16, max_depth=6,
        env_mode=env_mod.HDR_MAP,
        use_albedo=False, use_normal=False, use_z_depth=False,
    )
    cam = cam_mod.make_camera(
        image_width=64, image_height=36, vfov=20.0,
        lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0),
        defocus_angle=2.0, focus_dist=10.0,
    )
    env = env_mod.make_environment(
        hdr_image=_procedural_hdr(),
        hdri_rotation=0.7, hdri_tilt=0.2, hdri_roll=0.1,
    )
    return _render(scene, cam, env, cfg)


RENDERS = {
    "shirley": render_shirley,
    "cornell": render_cornell,
    "showcase": render_showcase,
    "hdri": render_hdri,
}


@pytest.mark.parametrize("name", sorted(RENDERS))
def test_golden(name):
    path = os.path.join(GOLDEN_DIR, f"{name}.npz")
    assert os.path.exists(path), (
        f"golden missing — run `python tools/make_goldens.py` ({path})"
    )
    golden = np.load(path)["beauty"]
    img = np.asarray(RENDERS[name]()["beauty"], np.float32)
    assert img.shape == golden.shape
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img, golden, atol=ATOL, rtol=0)


def test_bvh_mode_hit_invariant():
    """The reference's median/random-axis build (bvh.hpp:15-42) and the
    default binned-SAH build resolve the same closest hits — the A/B knob
    changes tree shape and performance, never the picture."""
    from raytracer_project_tpu.core.constants import T_MIN
    from raytracer_project_tpu.ops import bvh as bvh_mod, traverse

    scene = presets.shirley_final_scene(grid=4, with_bvh=False)
    rng_np = np.random.default_rng(5)
    n = 512
    o = jax.numpy.asarray(rng_np.uniform(-14, 14, (n, 3)), jax.numpy.float32)
    d = jax.numpy.asarray(rng_np.normal(size=(n, 3)), jax.numpy.float32)

    hits = {}
    for mode in ("sah", "median_random_axis"):
        s = scene._replace(bvh=bvh_mod.build_bvh(scene, mode=mode, seed=9))
        h = traverse.intersect_bvh(s, o, d, T_MIN)
        hits[mode] = (np.asarray(h.t), np.asarray(h.prim_type),
                      np.asarray(h.prim_idx), np.asarray(h.hit))
    for a, b in zip(hits["sah"], hits["median_random_axis"]):
        np.testing.assert_array_equal(a, b)


def test_rotate_y_radians_quirk():
    """rotate_y_radians reproduces the reference's radians/degrees quirk:
    the matrix equals rotate_y(degrees(x)), and 'rotate by 30' differs
    visibly between the quirk (30 rad) and the intent (30 deg)."""
    x = 0.61
    np.testing.assert_allclose(
        geometry.rotate_y_radians(x), geometry.rotate_y(np.degrees(x)),
        atol=1e-12,
    )
    # Image-level A/B: a single rotated box under each interpretation.
    def box_scene(xform):
        from raytracer_project_tpu.models.scene import SceneBuilder
        b = SceneBuilder()
        mid = b.materials.lambertian("m", (0.8, 0.3, 0.2))
        b.geometry.add_box((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), mid,
                           transform=xform)
        return b.build(with_bvh=False)

    cfg = integrator.RenderConfig(
        width=32, height=32, samples_per_pixel=4, max_depth=3,
        env_mode=env_mod.SOLID_COLOR,
        use_albedo=False, use_normal=False, use_z_depth=False,
    )
    cam = cam_mod.make_camera(image_width=32, image_height=32, vfov=40.0,
                              lookfrom=(4.0, 3.0, 4.0),
                              lookat=(0.0, 0.0, 0.0))
    env = env_mod.make_environment(background_color=(0.2, 0.2, 0.2))
    key = jax.random.PRNGKey(KEY)

    quirk = np.asarray(integrator.render(
        box_scene(geometry.rotate_y_radians(30.0)), cam, env, key, cfg
    )["beauty"])
    intent = np.asarray(integrator.render(
        box_scene(geometry.rotate_y(30.0)), cam, env, key, cfg
    )["beauty"])
    assert np.isfinite(quirk).all() and np.isfinite(intent).all()
    # 30 rad ≡ 30 - 9.55π ≈ -0.31 rad vs 0.52 rad: visibly different edge.
    assert np.abs(quirk - intent).max() > 0.05
