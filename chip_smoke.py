#!/usr/bin/env python
"""On-card check that the renderer runs, and is right, on a GPU.

    python chip_smoke.py          # one card: phases 1-5 below
    python chip_smoke.py --four   # four cards: the sharded render only

One process imports JAX once. It exits nonzero, printing no result line,
when JAX finds no GPU or when any phase fails: every phase raises on
failure and nothing is caught to let the run go on. Earlier lines give
the cards' `name, power.limit` (nvidia-smi), compile and wall seconds per
phase, measured path segments per second, peak device memory, the chosen
closest-hit route, and each measured value beside its budget. The last
line is {"ok": true, "device": {"platform": ..., "kind": ..., "count": N}}.

Phases (one card):
  1 hit-agree     the production closest-hit route on the GPU vs the
                  brute-force oracle run on the host CPU, 262,144 showcase
                  rays (camera rays plus one bounce), all float32.
  2 bvh-traverse  threaded BVH traversal vs the brute-force scan on the
                  ~25k-primitive funnel, 262,144 rays, both on the GPU.
  3 goldens       pooled renders vs the committed CPU goldens
                  (tests/goldens/smoke_*.npz), run twice: both diffs and
                  the run-to-run diff that scatter-add order causes.
  4 main-path     `cli.main(["render", ...])` at 1920x1080 @ 16 spp with
                  rgb,albedo,normals through RenderSession; the funnel at
                  800x450 @ 16 spp; pooled vs chunked at 400x225 @ 16 spp.
  5 gradient      jax.grad of the diff.inverse loss w.r.t. a material
                  albedo on a 64x36 frame vs central finite differences.

The phase functions take their sizes as arguments, so the CPU tests run
them at tiny sizes (tests/test_chip_smoke.py).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")
WORK_DIR = os.path.join(REPO, "build", "chip_smoke")

# --- budgets (each printed beside its measured value) -----------------------
# Calibrated on one H200 (700 W); the measured values are in PERF.md.
# hit-agree: a real bug (wrong table, dropped term, TF32 contraction) puts
# 30-100% of rays off; float32 knife edges (grazing rays, self-hits at
# t_min) flip a few in 10^4. Same-winner t agrees to ~1e-5 at p99, except
# on the r=1000 ground sphere: its c = |oc|^2 - r^2 cancels catastrophically
# in float32 (|oc|^2 ~ 1e6, one ulp ~ 0.06) and the GPU contracts it into
# fused multiply-adds where the CPU does not, so its t gets a looser bound.
HIT_FLIP_MAX = 1e-3
WINNER_FLIP_MAX = 1e-2
T_REL_P99_MAX = 1e-4           # rays whose winner is not the ground sphere
T_REL_P99_ALL_MAX = 1e-3       # all rays
# bvh-traverse: same float32 tests in another order.
BVH_RTOL = BVH_ATOL = 2e-4
# goldens: path tracing is chaotic under float reassociation (an ulp of t
# flips a hit, reroutes the lane's random stream, and yields an independent
# sample), so a GPU render differs from the CPU golden by speckle (measured
# mean|d| <= 0.0024, <= 0.5% of pixels off by > 0.05); a systematically
# wrong image runs mean >= 0.1 with 30-100% of pixels off.
GOLDEN_MEAN_MAX = 0.01
GOLDEN_FRAC_MAX = 0.02
# Pooled vs chunked at 16 spp: the same samples summed in another order by
# another program (measured mean|d| 0.00022, 0.19% of pixels > 0.05).
POOL_CHUNK_MEAN_MAX = 0.002
POOL_CHUNK_FRAC_MAX = 0.01
# Four cards vs one: the same samples, summed by another program.
FOUR_MEAN_MAX = 0.005
FOUR_FRAC_MAX = 0.02
# gradient: tests/test_gradients.py's tolerance.
GRAD_RTOL, GRAD_ATOL, FD_EPS = 0.08, 1e-5, 1e-3


class SmokeFailure(RuntimeError):
    """A phase's result is outside its budget."""


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


def peak_bytes(dev) -> int:
    return int((dev.memory_stats() or {}).get("peak_bytes_in_use", 0))


def compiled(fn, *args):
    """(compiled executable, compile seconds) for jax.jit(fn)(*args)."""
    import jax

    t0 = time.perf_counter()
    exe = jax.jit(fn).lower(*args).compile()
    return exe, time.perf_counter() - t0


def run_timed(exe, *args):
    """(result, wall seconds), the result materialized on the device."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(exe(*args))
    return out, time.perf_counter() - t0


# --- scenes and rays ----------------------------------------------------------

SHOWCASE_CAM = dict(vfov=30.0, lookfrom=(12.0, 2.5, 6.0),
                    lookat=(0.0, 1.0, 0.0), defocus_angle=0.0,
                    focus_dist=10.0)
FUNNEL_CAM = dict(vfov=35.0, lookfrom=(5.0, 6.0, 6.0),
                  lookat=(5.0, 4.0, -12.0))
SUN = dict(sun_direction=(0.4, 0.7, 0.2), sun_intensity=6.0)


def showcase(width, height, **scene_kw):
    from raytracer_project_tpu.models import camera as cam_mod
    from raytracer_project_tpu.models import environment as env_mod
    from raytracer_project_tpu.models import presets

    scene = presets.showcase_scene(with_bvh=True, with_meshes=True,
                                   **scene_kw)
    cam = cam_mod.make_camera(image_width=width, image_height=height,
                              **SHOWCASE_CAM)
    return scene, cam, env_mod.make_environment(**SUN)


def funnel(width, height, n_spheres=8192, mesh_detail=2):
    from raytracer_project_tpu.models import camera as cam_mod
    from raytracer_project_tpu.models import environment as env_mod
    from raytracer_project_tpu.models import presets

    scene = presets.bvh_stress_scene(n_spheres=n_spheres,
                                     mesh_detail=mesh_detail)
    cam = cam_mod.make_camera(image_width=width, image_height=height,
                              **FUNNEL_CAM)
    return scene, cam, env_mod.make_environment(**SUN)


def camera_and_bounce_rays(scene, cam, width, height):
    """2 * width * height rays as host arrays: one camera ray per pixel,
    then each one's first bounce (shade.scatter from its closest hit; a
    camera ray that missed or was absorbed stands in for its own bounce)."""
    import jax
    import jax.numpy as jnp

    from raytracer_project_tpu.core import rng as rng_mod
    from raytracer_project_tpu.core.constants import T_MIN
    from raytracer_project_tpu.models import camera as cam_mod
    from raytracer_project_tpu.ops import intersect, shade

    n = width * height
    pix = jnp.arange(n, dtype=jnp.int32)

    @jax.jit
    def rays(scene, cam):
        lr = rng_mod.lane_rng(jax.random.PRNGKey(0), pix).with_ctx(0, 0)
        o, d = cam_mod.generate_rays(cam, lr, pix, width, n)
        hit = intersect.intersect(scene, o, d, T_MIN)
        rec = intersect.make_record(scene, o, d, hit)
        sc = shade.scatter(scene, rec, d, lr.with_ctx(1))
        ok = (rec.hit & sc.scattered)[:, None]
        return (jnp.concatenate([o, jnp.where(ok, sc.origin, o)]),
                jnp.concatenate([d, jnp.where(ok, sc.direction, d)]))

    o, d = rays(scene, cam)
    return np.asarray(o), np.asarray(d)


def hit_stats(got, ref) -> dict:
    """Hit-set flips, winner flips (among rays both hit), and the relative
    t error among rays where the same primitive won."""
    gh, rh = np.asarray(got.hit), np.asarray(ref.hit)
    both = gh & rh
    same = ((np.asarray(got.prim_idx) == np.asarray(ref.prim_idx))
            & (np.asarray(got.prim_type) == np.asarray(ref.prim_type)))
    sw = both & same
    tg, tr = np.asarray(got.t)[sw], np.asarray(ref.t)[sw]
    rel = np.abs(tg - tr) / np.maximum(np.abs(tr), 1e-3)
    ptype = np.asarray(ref.prim_type)[sw]
    by_type = {name: float(np.quantile(rel[ptype == k], 0.99))
               for k, name in enumerate(("sphere", "triangle", "box"))
               if (ptype == k).any()}
    return {
        "rays": int(gh.size), "hits": int(rh.sum()),
        "hit_flips": float((gh != rh).mean()),
        "winner_flips": float((both & ~same).sum() / max(both.sum(), 1)),
        "t_rel_p99": float(np.quantile(rel, 0.99)) if rel.size else 0.0,
        "t_rel_max": float(rel.max()) if rel.size else 0.0,
        "t_rel_p99_by_type": by_type,
        "t_allclose_frac_off": float(
            (~np.isclose(tg, tr, rtol=BVH_RTOL, atol=BVH_ATOL)).mean())
        if tg.size else 0.0,
    }


# --- phases -------------------------------------------------------------------

def phase_hit_agree(width=512, height=256, oracle_device=None):
    """Production route (intersect.intersect, default device) vs the
    brute-force oracle on `oracle_device` (the host CPU by default)."""
    import jax

    from raytracer_project_tpu.core.constants import T_MIN
    from raytracer_project_tpu.ops import intersect

    scene, cam, _ = showcase(width, height)
    route = intersect.intersect_dispatch(scene)
    o, d = camera_and_bounce_rays(scene, cam, width, height)
    exe, comp_s = compiled(
        lambda s, o, d: intersect.intersect(s, o, d, T_MIN), scene, o, d)
    got, wall_s = run_timed(exe, scene, o, d)
    oracle_device = oracle_device or jax.devices("cpu")[0]
    with jax.default_device(oracle_device):
        t0 = time.perf_counter()
        ref = jax.block_until_ready(jax.jit(
            lambda s, o, d: intersect.intersect_brute(s, o, d, T_MIN))(
                jax.device_put(scene, oracle_device), o, d))
        oracle_s = time.perf_counter() - t0
    st = hit_stats(got, ref)
    # The r=1000 ground sphere's c = |oc|^2 - r^2 cancels catastrophically
    # in float32 (|oc|^2 ~ 1e6, one ulp ~ 0.06), and the GPU contracts it
    # into fused multiply-adds where the CPU does not: its t differs most.
    big = np.asarray(scene.spheres.radius)[
        np.clip(np.asarray(ref.prim_idx), 0, scene.spheres.count - 1)] > 100
    big &= np.asarray(ref.prim_type) == 0
    rest = hit_stats(*(h._replace(hit=h.hit & ~big) for h in (got, ref)))
    st["t_rel_p99_without_ground"] = rest["t_rel_p99"]
    say(f"hit-agree: route={route} prims={scene.primitive_count} "
        f"rays={st['rays']} hits={st['hits']} oracle=intersect_brute on "
        f"{oracle_device.platform}; compile_s={comp_s:.3f} "
        f"wall_s={wall_s:.4f} oracle_s={oracle_s:.3f}")
    say(f"hit-agree: hit_flips={st['hit_flips']:.3e} (budget "
        f"{HIT_FLIP_MAX:g}) winner_flips={st['winner_flips']:.3e} (budget "
        f"{WINNER_FLIP_MAX:g}) same-winner t_rel_p99 without the ground "
        f"sphere={st['t_rel_p99_without_ground']:.3e} (budget "
        f"{T_REL_P99_MAX:g}), all={st['t_rel_p99']:.3e} (budget "
        f"{T_REL_P99_ALL_MAX:g}); t_rel_max={st['t_rel_max']:.3e}; "
        f"t_rel_p99 by winner type {st['t_rel_p99_by_type']}")
    check(st["hit_flips"] <= HIT_FLIP_MAX, f"hit-agree: hit flips {st}")
    check(st["winner_flips"] <= WINNER_FLIP_MAX,
          f"hit-agree: winner flips {st}")
    check(st["t_rel_p99_without_ground"] <= T_REL_P99_MAX,
          f"hit-agree: t error {st}")
    check(st["t_rel_p99"] <= T_REL_P99_ALL_MAX, f"hit-agree: t error {st}")
    return dict(st, route=route, compile_s=comp_s, wall_s=wall_s)


def phase_bvh_traverse(width=512, height=256, n_spheres=8192,
                       mesh_detail=2):
    """traverse.intersect_bvh vs intersect_brute on the funnel."""
    from raytracer_project_tpu.core.constants import T_MIN
    from raytracer_project_tpu.ops import intersect, traverse

    scene, cam, _ = funnel(width, height, n_spheres, mesh_detail)
    o, d = camera_and_bounce_rays(scene, cam, width, height)
    exe_b, comp_b = compiled(
        lambda s, o, d: traverse.intersect_bvh(s, o, d, T_MIN), scene, o, d)
    exe_o, comp_o = compiled(
        lambda s, o, d: intersect.intersect_brute(s, o, d, T_MIN),
        scene, o, d)
    got, wall_b = run_timed(exe_b, scene, o, d)
    ref, wall_o = run_timed(exe_o, scene, o, d)
    st = hit_stats(got, ref)
    say(f"bvh-traverse: prims={scene.primitive_count} rays={st['rays']} "
        f"hits={st['hits']} route={intersect.intersect_dispatch(scene)}; "
        f"compile_s bvh={comp_b:.3f} brute={comp_o:.3f}; wall_s "
        f"bvh={wall_b:.4f} brute={wall_o:.4f}")
    say(f"bvh-traverse: hit_flips={st['hit_flips']:.3e} (budget "
        f"{HIT_FLIP_MAX:g}) winner_flips={st['winner_flips']:.3e} (budget "
        f"{WINNER_FLIP_MAX:g}) same-winner t off allclose(rtol=atol="
        f"{BVH_RTOL:g})={st['t_allclose_frac_off']:.3e} (budget "
        f"{HIT_FLIP_MAX:g})")
    check(st["hit_flips"] <= HIT_FLIP_MAX, f"bvh-traverse: hit flips {st}")
    check(st["winner_flips"] <= WINNER_FLIP_MAX,
          f"bvh-traverse: winner flips {st}")
    check(st["t_allclose_frac_off"] <= HIT_FLIP_MAX,
          f"bvh-traverse: t mismatch {st}")
    return dict(st, wall_bvh_s=wall_b, wall_brute_s=wall_o)


def golden_renders():
    """The smoke goldens' configurations: (golden name, scene, camera,
    environment, RenderConfig, buffer)."""
    from raytracer_project_tpu.models import environment as env_mod
    from raytracer_project_tpu.ops import integrator

    plain = dict(env_mode=env_mod.PHYSICAL_SUN, max_depth=10,
                 use_albedo=False, use_normal=False, use_z_depth=False)
    s64, c64, env = showcase(64, 36)
    s128, c128, _ = showcase(128, 72)
    fog, _, _ = showcase(64, 36, use_fog=True, fog_density=0.02)
    cfg64 = integrator.RenderConfig(width=64, height=36,
                                    samples_per_pixel=2, **plain)
    cfg128 = integrator.RenderConfig(width=128, height=72,
                                     samples_per_pixel=4, **plain)
    # Fog + every optional channel: AOVs and reflection/refraction passes.
    cfg_f = integrator.RenderConfig(
        width=64, height=36, samples_per_pixel=4, max_depth=10,
        env_mode=env_mod.PHYSICAL_SUN, use_reflection=True,
        use_refraction=True)
    return [
        ("smoke_fused_64x36", s64, c64, env, cfg64, "beauty"),
        ("smoke_pool_128x72", s128, c128, env, cfg128, "beauty"),
        ("smoke_features_beauty_64x36", fog, c64, env, cfg_f, "beauty"),
        ("smoke_features_albedo_64x36", fog, c64, env, cfg_f, "albedo"),
        ("smoke_features_reflection_64x36", fog, c64, env, cfg_f,
         "reflection"),
    ]


def render_golden_images(cases, key_seed=0):
    """{golden name: float32 image} through integrator.render (the pool);
    one render per distinct configuration."""
    import jax

    from raytracer_project_tpu.ops import integrator

    render = jax.jit(integrator.render, static_argnames="config")
    done, out = {}, {}
    for name, scene, cam, env, cfg, buf in cases:
        k = (id(scene), cfg)
        if k not in done:
            done[k] = render(scene, cam, env, jax.random.PRNGKey(key_seed),
                             cfg)
        out[name] = np.asarray(done[k][buf], np.float32)
    return out


def image_diff(a, b):
    d = np.abs(a - b)
    return float(d.mean()), float((d.max(axis=-1) > 0.05).mean())


def phase_goldens(names=None, runs=2):
    cases = [c for c in golden_renders() if names is None or c[0] in names]
    t0 = time.perf_counter()
    images = [render_golden_images(cases) for _ in range(runs)]
    wall = time.perf_counter() - t0
    result = {}
    for name, *_ in cases:
        ref = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))["beauty"]
        row = {}
        for r, imgs in enumerate(images):
            img = imgs[name]
            check(img.shape == ref.shape,
                  f"goldens: {name} shape {img.shape} != {ref.shape}")
            check(bool(np.isfinite(img).all()), f"goldens: {name} non-finite")
            check(img.max() > 0.0, f"goldens: {name} all black")
            row[f"run{r}"] = image_diff(img, ref)
        if runs > 1:
            row["run_to_run"] = image_diff(images[0][name], images[1][name])
        say(f"goldens: {name}: " + " ".join(
            f"{k} mean|d|={m:.5f} frac(>0.05)={f:.4f}"
            for k, (m, f) in row.items())
            + f" (budget mean {GOLDEN_MEAN_MAX} frac {GOLDEN_FRAC_MAX})")
        for k, (m, f) in row.items():
            check(m <= GOLDEN_MEAN_MAX and f <= GOLDEN_FRAC_MAX,
                  f"goldens: {name} {k} mean={m:.5f} frac={f:.4f}")
        result[name] = row
    say(f"goldens: {len(cases)} images x {runs} runs, wall_s={wall:.3f} "
        f"(compile included)")
    return result


def check_image(img, shape, what):
    check(img.shape == shape, f"{what}: shape {img.shape} != {shape}")
    check(bool(np.isfinite(img).all()), f"{what}: non-finite values")
    check(float(img.max()) > 0.0, f"{what}: all black")


def cli_render(width, height, spp, out_dir):
    """cli.main(["render", ...]) in-process; returns (its log, captured
    from stdout, and the wall seconds)."""
    from raytracer_project_tpu import cli

    argv = ["render", "--preset", "showcase", "--width", str(width),
            "--height", str(height), "--spp", str(spp),
            "--passes", "rgb,albedo,normals", "--out", out_dir,
            "--checkpoint", os.path.join(out_dir, "checkpoint.npz")]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    check(rc == 0, f"main-path: cli.main returned {rc}")
    return buf.getvalue(), wall


def phase_main_path(width=1920, height=1080, spp=16, funnel_size=(800, 450),
                    funnel_kw=None, pool_size=(400, 225), out_dir=None):
    import jax

    from raytracer_project_tpu.ops import integrator
    from raytracer_project_tpu.utils.session import RenderSession

    dev = jax.devices()[0]
    out_dir = out_dir or os.path.join(WORK_DIR, f"showcase_{width}x{height}")
    # Warm-up at 4 spp compiles the session's step; the timed run at `spp`
    # reuses it (4-spp chunks either way).
    _, warm_s = cli_render(width, height, min(4, spp), out_dir)
    log, wall = cli_render(width, height, spp, out_dir)
    m = re.search(r"Rendered (\d+) spp in ([\d.]+)s .*?([\d.]+) path "
                  r"segments traced", log)
    check(m is not None, f"main-path: no render summary in CLI log {log!r}")
    done, render_s, segs = int(m.group(1)), float(m.group(2)), float(
        m.group(3))
    check(done == spp, f"main-path: rendered {done} spp, asked {spp}")
    ck = np.load(os.path.join(out_dir, "checkpoint.npz"))
    aux = min(integrator.RenderConfig(samples_per_pixel=spp).aux_samples, spp)
    for buf, div in (("beauty", spp), ("albedo", aux), ("normal", aux)):
        img = ck[buf].reshape(height, width, 3) / div
        check_image(img, (height, width, 3), f"main-path showcase {buf}")
    for name in ("rgb", "albedo", "normals"):
        path = os.path.join(out_dir, f"render_{name}.png")
        check(os.path.getsize(path) > 0, f"main-path: {path} empty")
    say(f"main-path: showcase {width}x{height} @ {spp} spp via cli.main: "
        f"warm-up (compile + 4 spp) wall_s={warm_s:.3f}; render_s="
        f"{render_s:.3f} cli_wall_s={wall:.3f} segments={segs:.0f} "
        f"segments_per_s={segs / render_s:.4e} peak_bytes={peak_bytes(dev)}")

    fw, fh = funnel_size
    scene, cam, env = funnel(fw, fh, **(funnel_kw or {}))
    cfg = integrator.RenderConfig(width=fw, height=fh,
                                  samples_per_pixel=spp)
    sess = RenderSession(scene, cam, env, cfg, chunk_samples=spp)
    t0 = time.perf_counter()
    sess.step(spp)
    f_wall = time.perf_counter() - t0
    for buf, img in sess.buffers().items():
        if buf in ("beauty", "albedo", "normal", "z_depth"):
            check_image(np.asarray(img), (fh, fw, 3), f"main-path funnel {buf}")
    say(f"main-path: funnel {fw}x{fh} @ {spp} spp prims="
        f"{scene.primitive_count} via RenderSession: wall_s={f_wall:.3f} "
        f"(compile included) segments={sess.segments_traced:.0f}")

    pw, ph = pool_size
    scene, cam, env = showcase(pw, ph)
    base = integrator.RenderConfig(width=pw, height=ph,
                                   samples_per_pixel=spp, use_albedo=False,
                                   use_normal=False, use_z_depth=False)
    render = jax.jit(integrator.render, static_argnames="config")
    key = jax.random.PRNGKey(5)
    pooled = np.asarray(render(scene, cam, env, key, base)["beauty"])
    chunked = np.asarray(render(scene, cam, env, key, dataclasses.replace(
        base, wavefront=False))["beauty"])
    check_image(pooled, (ph, pw, 3), "main-path pooled")
    mean_d, frac = image_diff(pooled, chunked)
    say(f"main-path: pooled vs chunked {pw}x{ph} @ {spp} spp: mean|d|="
        f"{mean_d:.5f} frac(>0.05)={frac:.4f} (budget mean "
        f"{POOL_CHUNK_MEAN_MAX} frac {POOL_CHUNK_FRAC_MAX})")
    check(mean_d <= POOL_CHUNK_MEAN_MAX and frac <= POOL_CHUNK_FRAC_MAX,
          f"main-path: pooled vs chunked mean|d|={mean_d} frac={frac}")
    return {"segments_per_s": segs / render_s, "render_s": render_s,
            "warm_s": warm_s, "pool_vs_chunk": mean_d}


def phase_gradient(width=64, height=36):
    """d loss / d albedo[red material, R] by jax.grad vs central FD."""
    import jax
    import jax.numpy as jnp

    from raytracer_project_tpu.diff import RenderState
    from raytracer_project_tpu.diff.inverse import (
        finite_difference_grad, make_loss_fn)
    from raytracer_project_tpu.models import camera as cam_mod
    from raytracer_project_tpu.models import environment as env_mod
    from raytracer_project_tpu.models.scene import SceneBuilder
    from raytracer_project_tpu.ops import integrator

    b = SceneBuilder()
    red = b.materials.lambertian("red", (0.7, 0.2, 0.1))
    gray = b.materials.lambertian("gray", (0.5, 0.5, 0.5))
    lamp = b.materials.diffuse_light("lamp", (4.0, 4.0, 4.0))
    b.geometry.add_sphere((0.0, 1.0, 0.0), 1.0, red)
    b.geometry.add_sphere((0.0, -100.0, 0.0), 100.0, gray)
    b.geometry.add_sphere((-2.0, 2.5, 1.0), 0.5, lamp)
    state = RenderState(
        scene=b.build(with_bvh=False),
        cam=cam_mod.make_camera(image_width=width, image_height=height,
                                vfov=40.0, lookfrom=(0.0, 2.0, 8.0),
                                lookat=(0.0, 1.0, 0.0)),
        env=env_mod.make_environment(background_color=(0.3, 0.5, 0.9)))
    cfg = integrator.RenderConfig(
        width=width, height=height, samples_per_pixel=2, max_depth=4,
        env_mode=env_mod.SOLID_COLOR, use_albedo=False, use_normal=False,
        use_z_depth=False)
    path = "scene.materials.albedo"
    loss_fn, params = make_loss_fn(
        state, cfg, jnp.zeros((height, width, 3), jnp.float32), [path])
    key = jax.random.PRNGKey(0)
    t0 = time.perf_counter()
    g = float(jnp.ravel(jax.jit(jax.grad(loss_fn))(params, key)[path])[0])
    grad_s = time.perf_counter() - t0
    fd = finite_difference_grad(jax.jit(loss_fn), params, path, 0, key,
                                eps=FD_EPS)
    ok = np.isfinite(g) and np.isfinite(fd) and (
        abs(g - fd) <= GRAD_ATOL + GRAD_RTOL * abs(fd))
    say(f"gradient: {width}x{height} d loss/d {path}[0]: grad={g:.6e} "
        f"fd={fd:.6e} (rtol {GRAD_RTOL}, atol {GRAD_ATOL}, eps {FD_EPS}); "
        f"grad wall_s={grad_s:.3f} (compile included)")
    check(bool(ok), f"gradient: grad {g} vs finite difference {fd}")
    return {"grad": g, "fd": fd}


def phase_four(width=800, height=448, spp=8):
    """Showcase sharded over four devices vs the same frame on one."""
    import jax

    from raytracer_project_tpu.ops import integrator
    from raytracer_project_tpu.parallel import render as prender

    devs = jax.devices()
    check(len(devs) >= 4, f"four: {len(devs)} devices visible, need 4")
    scene, cam, env = showcase(width, height)
    cfg = integrator.RenderConfig(width=width, height=height,
                                  samples_per_pixel=spp, use_albedo=False,
                                  use_normal=False, use_z_depth=False)
    key = jax.random.PRNGKey(0)
    mesh4 = prender.make_mesh(4)
    ids = prender._padded_pixel_ids(cfg.n_pixels, 4)
    step4 = jax.jit(lambda s, c, e, k: prender.sharded_accumulate(
        s, c, e, k, cfg, ids, 0, mesh=mesh4, with_stats=True))
    t0 = time.perf_counter()
    acc4, st4 = jax.block_until_ready(step4(scene, cam, env, key))
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    acc4, st4 = jax.block_until_ready(step4(scene, cam, env, key))
    wall4 = time.perf_counter() - t0
    shard_devs = {s.device for s in acc4.beauty.addressable_shards}
    check(len(shard_devs) == 4,
          f"four: beauty shards live on {len(shard_devs)} devices")
    peaks = [peak_bytes(d) for d in devs[:4]]
    # (The CPU backend keeps no memory statistics.)
    check(all(p > 0 for p in peaks) or devs[0].platform == "cpu",
          f"four: peak bytes {peaks}")

    render1 = jax.jit(integrator.render, static_argnames=("config",
                                                          "with_stats"))
    with jax.default_device(devs[0]):
        out1, st1 = jax.block_until_ready(render1(scene, cam, env, key, cfg,
                                                  with_stats=True))
        t0 = time.perf_counter()
        out1, st1 = jax.block_until_ready(render1(scene, cam, env, key, cfg,
                                                  with_stats=True))
        wall1 = time.perf_counter() - t0
    img4 = np.asarray(integrator.finalize_buffers(
        jax.tree.map(lambda x: x[:cfg.n_pixels], acc4), cfg)["beauty"])
    img1 = np.asarray(out1["beauty"])
    check_image(img4, (height, width, 3), "four: sharded beauty")
    mean_d, frac = image_diff(img4, img1)
    say(f"four: showcase {width}x{height} @ {spp} spp on 4 devices: "
        f"compile+first wall_s={first_s:.3f} wall_s={wall4:.4f} segments="
        f"{float(st4['segments']):.0f}; 1 device wall_s={wall1:.4f} "
        f"segments={float(st1['segments']):.0f}; peak_bytes={peaks}")
    say(f"four: 4 vs 1 device mean|d|={mean_d:.3e} frac(>0.05)={frac:.4f} "
        f"(budget mean {FOUR_MEAN_MAX} frac {FOUR_FRAC_MAX})")
    check(mean_d <= FOUR_MEAN_MAX and frac <= FOUR_FRAC_MAX,
          f"four: 4 vs 1 mean|d|={mean_d} frac={frac}")
    return {"wall4": wall4, "wall1": wall1, "mean_d": mean_d}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded render and its "
                         "one-card comparison")
    args = ap.parse_args(argv)

    from raytracer_project_tpu import native
    from raytracer_project_tpu.utils import device

    devs = device.require_gpu()
    import jax

    cards = device.card_lines()
    for line in cards:
        say(f"card: {line}")
    say(f"jax {jax.__version__}; devices {devs}; XLA_FLAGS="
        f"{os.environ.get('XLA_FLAGS', '')!r}; native library in use: "
        f"{native.available()}")
    os.makedirs(WORK_DIR, exist_ok=True)
    phases = ([("four", phase_four)] if args.four else
              [("hit-agree", phase_hit_agree),
               ("bvh-traverse", phase_bvh_traverse),
               ("goldens", phase_goldens),
               ("main-path", phase_main_path),
               ("gradient", phase_gradient)])
    for name, fn in phases:
        t0 = time.perf_counter()
        fn()
        say(f"phase {name}: PASS in {time.perf_counter() - t0:.1f}s, "
            f"peak_bytes_in_use={peak_bytes(devs[0])}")
    print(json.dumps({"ok": True,
                      "device": device.device_summary(jax.devices())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
