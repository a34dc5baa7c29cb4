#!/usr/bin/env python
"""Throughput probe: renders the showcase scene on one GPU and reports
throughput as one JSON line.

Headline metric (`value`): MEASURED path segments per second — actual
traced path segments (the pooled wavefront's on-device counter,
ops/wavefront.py) / wall_time. `detail.rays_per_s_upper_bound` additionally
reports the reference UI's width*height*spp*max_depth / wall_time estimator
(/root/reference/main.cpp:101-113) for comparability in kind; it overstates
throughput by the spp*max_depth / segments ratio (~4x on the showcase).

The output names the device (platform, device_kind, count, the cards'
name and power limit from nvidia-smi) and XLA_FLAGS. Without a GPU it
exits nonzero and prints no result. Correctness is gated separately by
chip_smoke.py.
"""

import json
import os
import sys
import time


def main():
    from raytracer_project_tpu.utils import device

    devs = device.require_gpu()
    cards = device.card_lines()

    import jax

    from raytracer_project_tpu.models import camera as cam_mod
    from raytracer_project_tpu.models import environment as env_mod
    from raytracer_project_tpu.models import presets
    from raytracer_project_tpu.ops import integrator

    width = int(os.environ.get("BENCH_WIDTH", 800))
    height = int(os.environ.get("BENCH_HEIGHT", 450))
    spp = int(os.environ.get("BENCH_SPP", 32))
    max_depth = int(os.environ.get("BENCH_DEPTH", 10))

    # BENCH_SCENE=funnel benches the 25k-primitive BVH stress world
    # (sub-linear-intersection evidence); default is the showcase.
    if os.environ.get("BENCH_SCENE") == "funnel":
        scene = presets.bvh_stress_scene(n_spheres=8192, mesh_detail=2)
    else:
        scene = presets.showcase_scene(with_bvh=True, with_meshes=True)
    cfg = integrator.RenderConfig(
        width=width, height=height, samples_per_pixel=spp, max_depth=max_depth,
        env_mode=env_mod.PHYSICAL_SUN,
        use_albedo=False, use_normal=False, use_z_depth=False,
        # Pooled-wavefront scheduling (ops/wavefront.py): terminated lanes
        # respawn immediately.
        wavefront=not os.environ.get("BENCH_NO_WAVEFRONT"),
    )
    if os.environ.get("BENCH_SCENE") == "funnel":
        cam = cam_mod.make_camera(
            image_width=width, image_height=height, vfov=35.0,
            lookfrom=(5.0, 6.0, 6.0), lookat=(5.0, 4.0, -12.0),
        )
    else:
        cam = cam_mod.make_camera(
            image_width=width, image_height=height, vfov=30.0,
            lookfrom=(12.0, 2.5, 6.0), lookat=(0.0, 1.0, 0.0),
            defocus_angle=0.0, focus_dist=10.0,
        )
    env = env_mod.make_environment(sun_direction=(0.4, 0.7, 0.2),
                                   sun_intensity=6.0)
    key = jax.random.PRNGKey(0)

    render = jax.jit(integrator.render,
                     static_argnames=("config", "with_stats"))

    import numpy as np

    # Warmup / compile; np.asarray closes each timing through a
    # materialized result.
    out, stats = render(scene, cam, env, key, cfg, with_stats=True)
    np.asarray(out["beauty"])

    dt = float("inf")
    for rep in (1, 2):
        t0 = time.perf_counter()
        out, stats = render(scene, cam, env, jax.random.PRNGKey(rep), cfg,
                            with_stats=True)
        np.asarray(out["beauty"])
        dt = min(dt, time.perf_counter() - t0)

    rays = width * height * spp * max_depth
    upper_bound = rays / dt
    segments = (float(stats["segments"])
                if stats.get("segments") is not None else None)
    measured = (segments / dt) if segments else None
    rays_per_s = measured if measured is not None else upper_bound

    # Which closest-hit route serves the hot path (ops/intersect.py).
    from raytracer_project_tpu.ops import intersect as isect_mod
    hot_path = isect_mod.intersect_dispatch(scene)

    # --- north-star configuration datapoint (BASELINE.md: 1080p @ 1k spp)
    # Measured at BENCH_1080P_SPP (default 32) with the wall for the full
    # 1k spp projected from the measured segment rate.
    hd = None
    if not os.environ.get("BENCH_SKIP_1080P"):
        import dataclasses

        hd_spp = int(os.environ.get("BENCH_1080P_SPP", 32))
        hd_cfg = dataclasses.replace(cfg, width=1920, height=1080,
                                     samples_per_pixel=hd_spp)
        hd_cam = cam_mod.make_camera(
            image_width=1920, image_height=1080, vfov=30.0,
            lookfrom=(12.0, 2.5, 6.0), lookat=(0.0, 1.0, 0.0),
            defocus_angle=0.0, focus_dist=10.0,
        )
        out_hd, st_hd = render(scene, hd_cam, env, key, hd_cfg,
                               with_stats=True)
        np.asarray(out_hd["beauty"])  # force materialization (compile)
        t0 = time.perf_counter()
        out_hd, st_hd = render(scene, hd_cam, env, jax.random.PRNGKey(3),
                               hd_cfg, with_stats=True)
        np.asarray(out_hd["beauty"])
        hd_dt = time.perf_counter() - t0
        hd_seg = (float(st_hd["segments"])
                  if st_hd.get("segments") is not None else None)
        hd_measured = (hd_seg / hd_dt) if hd_seg else None
        hd = {
            "width": 1920, "height": 1080, "spp": hd_spp,
            "wall_s": hd_dt,
            "rays_per_s_measured": hd_measured,
            "segments_traced": hd_seg,
            "projected_wall_s_at_1024spp": (hd_dt * 1024 / hd_spp),
        }

    print(json.dumps({
        "metric": "rays_per_second_showcase",
        "value": rays_per_s,
        "unit": "rays/s",
        "device": device.device_summary(devs),
        "cards": cards,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "detail": {
            "width": width, "height": height, "spp": spp,
            "max_depth": max_depth, "wall_s": dt,
            "primitives": int(scene.primitive_count),
            "intersector": hot_path,
            "rays_per_s_upper_bound": upper_bound,
            "rays_per_s_measured": measured,
            "segments_traced": segments,
            "pool_steps": (int(stats["steps"])
                           if stats.get("steps") is not None else None),
            "north_star_1080p": hd,
        },
    }))


if __name__ == "__main__":
    sys.exit(main())
