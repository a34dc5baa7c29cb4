"""Wavefront path-tracing integrator.

Replacement for the reference's per-pixel recursive/iterative
integrator (/root/reference/camera.hpp:430-544, 928-1004). The whole image
is one ray wavefront: a single `lax.while_loop` advances every lane one
bounce per iteration with masked (inactive) lanes instead of early returns.
Russian roulette and the weak-ray cutoff are masked stochastic kills with
the reference's exact constants.

Structure mirrors the reference's sampling loop:
  * one shared first hit per camera ray (camera.hpp:459)
  * beauty = emitted + attenuation * continuation (ray_color_from_hit,
    camera.hpp:989-1004)
  * AOVs (albedo / view-space normal / z-depth) from the first hit
    (camera.hpp:463-487)
  * reflection/refraction split pass re-scatters the first hit and
    classifies specular lanes (camera.hpp:490-517)
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import rng, vecmath
from ..core.constants import (
    RR_P_MAX,
    RR_P_MIN,
    RR_START_BOUNCE,
    T_MIN,
    WEAK_RAY_EPS,
    Z_DEPTH_MAX_DIST,
)
from ..models import camera as camera_mod
from ..models import environment as env_mod
from ..models.scene import Scene
from . import intersect, shade, volumes as volumes_mod


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render knobs (hashable; becomes a jit static argument).

    Defaults follow the reference (camera.hpp:26-57).
    """

    width: int = 400
    height: int = 225
    samples_per_pixel: int = 30
    max_depth: int = 10
    env_mode: int = env_mod.PHYSICAL_SUN
    use_albedo: bool = True
    use_normal: bool = True
    use_z_depth: bool = True
    use_reflection: bool = False
    use_refraction: bool = False
    z_depth_max_dist: float = Z_DEPTH_MAX_DIST
    # Samples fused into one wavefront per device step (None = auto-sized to
    # ~400k lanes). Bigger batches amortize the lock-step traversal's
    # sequential node steps across more lanes — the wavefront analog of
    # the reference's per-pixel sample loop (camera.hpp:454).
    samples_per_batch: int | None = None
    # Reverse-mode differentiable bounce loop: replaces the early-exit
    # `lax.while_loop` with a bounded `fori_loop` (scan-convertible, so
    # jax.grad works — see diff/). Slightly slower forward (no all-lanes-dead
    # exit). Intersection runs detached-traversal (intersect_detached): the
    # discrete closest-hit search uses whatever fast path applies on
    # stop_gradient'd inputs, then t is recomputed differentiably for the
    # chosen primitive — so differentiable renders scale to BVH-sized
    # scenes (only silhouette-boundary gradient terms are dropped).
    differentiable: bool = False
    # Pooled-wavefront scheduling (ops/wavefront.py): lanes whose path ended
    # respawn the next (pixel, sample) immediately instead of idling until
    # max_depth, so intersection work tracks actual path segments. Same
    # per-sample values; per-pixel sums differ from the chunked path only in
    # float addition order. Ignored when differentiable=True.
    # Default ON: the pool is the production engine the session/CLI ship.
    # Auto-disabled when differentiable=True (reverse-mode needs the
    # fixed-depth chunked loop); the chunked path remains the oracle the
    # pool is equivalence-tested against.
    wavefront: bool = True
    # Lane-pool size for wavefront mode (None = auto).
    pool_lanes: int | None = None

    @property
    def aux_samples(self) -> int:
        """AOV sample budget: clamp(spp/8, 64, 1024) re-capped at spp
        (camera.hpp:433,535)."""
        return min(max(self.samples_per_pixel // 8, 64), 1024)

    @property
    def n_pixels(self) -> int:
        return self.width * self.height


class _PathState(NamedTuple):
    bounce: jax.Array       # i32 scalar
    origin: jax.Array       # f32[N,3]
    direction: jax.Array    # f32[N,3]
    throughput: jax.Array   # f32[N,3]
    radiance: jax.Array     # f32[N,3]
    active: jax.Array       # bool[N]


def trace(scene: Scene, env, origin, direction, lane_rng: rng.LaneRng, *,
          max_bounces: int, env_mode: int, throughput=None, radiance=None,
          active=None, differentiable: bool = False, spec: int = 0):
    """Iterative bounce loop (camera.hpp:928-986) over a ray wavefront.

    lane_rng: per-lane stateless random stream; each bounce sets the
    context to the *absolute* segment index (loop bounce + 1; the camera
    segment is 0), so path randomness depends only on
    (seed, pixel, sample, bounce, spec) — shard- and schedule-invariant
    (the pooled wavefront replays identical draws). Initial
    throughput/radiance/active let a caller continue a path that already
    scattered once (ray_color_from_hit). Returns final radiance f32[N,3].
    """
    n = origin.shape[0]
    if throughput is None:
        throughput = jnp.ones((n, 3), jnp.float32)
    if radiance is None:
        radiance = jnp.zeros((n, 3), jnp.float32)
    if active is None:
        active = jnp.ones((n,), bool)

    def cond(s: _PathState):
        return (s.bounce < max_bounces) & jnp.any(s.active)

    def body(s: _PathState):
        lr = lane_rng.with_ctx(s.bounce + 1, spec)

        if differentiable:
            # Detached traversal + differentiable hit distance: any fast
            # intersector (BVH or scan) is usable under reverse-mode AD
            # because no tangent enters its discrete search.
            hit = intersect.intersect_detached(
                scene, s.origin, s.direction, T_MIN
            )
        else:
            hit = intersect.intersect(scene, s.origin, s.direction, T_MIN)
        rec = intersect.make_record(scene, s.origin, s.direction, hit)
        if scene.volumes is not None:
            # Stochastic media interaction may preempt the surface hit
            # (constant_medium.hpp:39-77).
            rec = volumes_mod.apply_to_record(
                scene.volumes, s.origin, s.direction, hit, rec, lr
            )

        # Miss -> add environment radiance and retire the lane
        # (camera.hpp:937-941).
        bg = env_mod.background_color(env, s.direction, env_mode)
        miss = s.active & ~rec.hit
        radiance = s.radiance + jnp.where(miss[:, None], s.throughput * bg, 0.0)
        active = s.active & rec.hit

        # Hit -> emission + scatter (camera.hpp:944-973).
        sc = shade.scatter(scene, rec, s.direction, lr)
        radiance = radiance + jnp.where(active[:, None], s.throughput * sc.emitted, 0.0)
        throughput = jnp.where(
            (active & sc.scattered)[:, None],
            s.throughput * sc.attenuation,
            s.throughput,
        )
        active = active & sc.scattered

        # Weak-ray cutoff after bounce 10 (camera.hpp:967-970).
        late = s.bounce > RR_START_BOUNCE
        weak = late & (vecmath.length(throughput) < WEAK_RAY_EPS)
        active = active & ~weak

        # Russian roulette (camera.hpp:976-983).
        p = jnp.clip(jnp.max(throughput, axis=-1), RR_P_MIN, RR_P_MAX)
        u = rng.draw_uniform(lr, rng.STREAM_RR)
        killed = late & (u > p)
        active = active & ~killed
        throughput = jnp.where(
            (late & active)[:, None], throughput / p[:, None], throughput
        )

        origin = jnp.where(active[:, None], sc.origin, s.origin)
        direction = jnp.where(active[:, None], sc.direction, s.direction)
        return _PathState(
            bounce=s.bounce + 1,
            origin=origin,
            direction=direction,
            throughput=throughput,
            radiance=radiance,
            active=active,
        )

    init = _PathState(
        bounce=jnp.asarray(0, jnp.int32),
        origin=origin,
        direction=direction,
        throughput=throughput,
        radiance=radiance,
        active=active,
    )
    if differentiable:
        # Bounded loop (static trip count) lowers to scan: reverse-mode OK.
        final = jax.lax.fori_loop(0, max_bounces, lambda _, s: body(s), init)
    else:
        final = jax.lax.while_loop(cond, body, init)
    return final.radiance


class SampleBuffers(NamedTuple):
    """Per-sample contributions, all f32[N,3] (N = W*H, row-major)."""

    beauty: jax.Array
    albedo: jax.Array
    normal: jax.Array
    z_depth: jax.Array
    reflection: jax.Array
    refraction: jax.Array


def render_sample(scene: Scene, cam: camera_mod.Camera, env, key,
                  config: RenderConfig, pixel_ids=None,
                  sample_ids=None) -> SampleBuffers:
    """One wavefront of (pixel, sample) lanes: beauty + AOV contributions.

    Follows the reference's per-sample structure (camera.hpp:454-527) with
    the first hit computed once and shared by all passes.

    pixel_ids (optional i32[n]): global row-major pixel indices per lane —
    the sharding hook. sample_ids (optional i32[n]): per-lane sample index
    (0 when omitted). Every draw is a pure counter hash of
    (seed, pixel, sample, bounce, stream) — see core/rng.py — so any
    batching, sharding, or chunking produces bit-identical contributions.
    """
    if pixel_ids is None:
        pixel_ids = jnp.arange(config.n_pixels, dtype=jnp.int32)
    n = pixel_ids.shape[0]
    zeros = jnp.zeros((n, 3), jnp.float32)

    lr = rng.lane_rng(key, pixel_ids,
                      0 if sample_ids is None else sample_ids)
    lr0 = lr.with_ctx(0, 0)  # camera segment, beauty pass

    o, d = camera_mod.generate_rays(cam, lr0, pixel_ids, config.width,
                                    config.n_pixels)

    if config.differentiable:
        first = intersect.intersect_detached(scene, o, d, T_MIN)
    else:
        first = intersect.intersect(scene, o, d, T_MIN)
    rec = intersect.make_record(scene, o, d, first)
    if scene.volumes is not None:
        rec = volumes_mod.apply_to_record(scene.volumes, o, d, first, rec, lr0)
    hit_mask = rec.hit
    bg = env_mod.background_color(env, d, config.env_mode)

    # --- beauty: first-hit reuse (camera.hpp:989-1004) ---
    sc = shade.scatter(scene, rec, d, lr0)
    continue_active = hit_mask & sc.scattered
    beauty = trace(
        scene, env, sc.origin, sc.direction, lr,
        max_bounces=config.max_depth - 1, env_mode=config.env_mode,
        throughput=sc.attenuation,
        radiance=jnp.zeros((n, 3), jnp.float32),
        active=continue_active,
        differentiable=config.differentiable,
    )
    beauty = jnp.where(hit_mask[:, None], sc.emitted + beauty, bg)

    # --- AOVs from the first hit (camera.hpp:463-487, 518-526) ---
    albedo = zeros
    if config.use_albedo:
        albedo = jnp.where(hit_mask[:, None], shade.get_albedo(scene, rec), 0.0)

    normal = zeros
    if config.use_normal:
        normal = jnp.where(
            hit_mask[:, None],
            camera_mod.view_space_normal_color(cam, rec.normal),
            jnp.asarray([0.5, 0.5, 1.0]),  # miss sentinel (camera.hpp:523)
        )

    z_depth = zeros
    if config.use_z_depth:
        zval = 1.0 - jnp.clip(rec.t / config.z_depth_max_dist, 0.0, 1.0)
        z_depth = jnp.where(hit_mask[:, None], zval[:, None], 0.0) * jnp.ones((1, 3))

    # --- reflection/refraction split pass (camera.hpp:490-517) ---
    reflection = zeros
    refraction = zeros
    if config.use_reflection or config.use_refraction:
        sc2 = shade.scatter(scene, rec, d, lr.with_ctx(0, 1))
        spec_active = hit_mask & sc2.scattered
        scattered_color = trace(
            scene, env, sc2.origin, sc2.direction, lr,
            max_bounces=config.max_depth - 1, env_mode=config.env_mode,
            active=spec_active,
            differentiable=config.differentiable, spec=1,
        )
        # Firefly clamp: luma = 0.2126 * |color| capped at 2
        # (camera.hpp:499-504; the reference really uses vector length).
        luma = 0.2126 * vecmath.length(scattered_color)
        scale = jnp.where(luma > 2.0, 2.0 / jnp.maximum(luma, 1e-12), 1.0)
        scattered_color = scattered_color * scale[:, None]

        reflected_dir = vecmath.reflect(vecmath.normalize(d), vecmath.normalize(rec.normal))
        is_specular = vecmath.dot(vecmath.normalize(sc2.direction), reflected_dir) > 0.9
        contrib = sc2.attenuation * scattered_color
        if config.use_reflection:
            reflection = jnp.where(
                (spec_active & is_specular)[:, None], contrib, 0.0
            )
        if config.use_refraction:
            entering = vecmath.dot(sc2.direction, rec.normal) < 0.0
            refraction = jnp.where(
                (spec_active & ~is_specular & entering)[:, None], contrib, 0.0
            )

    return SampleBuffers(
        beauty=beauty, albedo=albedo, normal=normal, z_depth=z_depth,
        reflection=reflection, refraction=refraction,
    )


# Auto-sizing target for fused (pixel x sample) wavefronts. Each lane's
# brute-force scan step materializes [lanes, CHUNK]-shaped temporaries
# (~50 B/pair at peak); 400k lanes keeps that under ~2.5 GB of device
# memory.
_TARGET_LANES = 400_000


def accumulate_samples(scene: Scene, cam: camera_mod.Camera, env, key,
                       config: RenderConfig, pixel_ids,
                       sample_offset=0, with_stats: bool = False,
                       pixel_offset=0, n_pixels_local: int | None = None):
    """Sum `samples_per_pixel` sample passes for the given pixels.

    Samples are fused into wavefront batches of (pixel, sample) lanes —
    the sequential cost of the masked traversal loop is paid once per
    *batch*, not once per sample. Returns *sums* (not averages) so
    progressive sessions and sharded renders keep accumulating; lane keys
    are (key, sample, pixel)-derived, so any chunking is bit-identical.

    with_stats (static): also return a stats dict. The pooled wavefront
    reports measured path segments ({"segments", "steps"}); the chunked
    path has no on-device counter, so it reports {"segments": None}.

    pixel_ids=None statically means the identity full frame (see
    wavefront.render_pool), which lets the pool skip its per-spawn pixel
    gather. With n_pixels_local it means the
    identity pixel WINDOW [pixel_offset, pixel_offset + n_pixels_local)
    (clamped to the frame) — the sharded path's per-shard slice;
    pixel_offset may be traced (axis_index inside shard_map).
    """
    if config.wavefront and not config.differentiable:
        from . import wavefront

        return wavefront.render_pool(
            scene, cam, env, key, config, pixel_ids, sample_offset,
            pool_lanes=config.pool_lanes, with_stats=with_stats,
            pixel_offset=pixel_offset, n_pixels_local=n_pixels_local,
        )
    if pixel_ids is None:
        if n_pixels_local is not None:
            pixel_ids = jnp.minimum(
                jnp.asarray(pixel_offset, jnp.int32)
                + jnp.arange(n_pixels_local, dtype=jnp.int32),
                config.n_pixels - 1,
            )
        else:
            pixel_ids = np.arange(config.n_pixels, dtype=np.int32)
    spp = config.samples_per_pixel
    aux = min(config.aux_samples, spp)
    n = pixel_ids.shape[0]

    batch = config.samples_per_batch or max(1, _TARGET_LANES // max(n, 1))
    batch = min(batch, spp)
    n_chunks = -(-spp // batch)

    sample_offset = jnp.asarray(sample_offset, jnp.int32)
    lane_pix = jnp.tile(pixel_ids, batch)
    lane_rel = jnp.repeat(jnp.arange(batch, dtype=jnp.int32), n)

    def chunk(ci, acc):
        lane_samp = sample_offset + ci * batch + lane_rel
        valid = lane_samp < sample_offset + spp  # tail-chunk mask
        buf = render_sample(scene, cam, env, key, config, lane_pix, lane_samp)
        is_aux = lane_samp < aux  # AOV budget (camera.hpp:433,464)

        def reduce(x, mask):
            return jnp.where(mask[:, None], x, 0.0).reshape(batch, n, 3).sum(0)

        return SampleBuffers(
            beauty=acc.beauty + reduce(buf.beauty, valid),
            albedo=acc.albedo + reduce(buf.albedo, valid & is_aux),
            normal=acc.normal + reduce(buf.normal, valid & is_aux),
            z_depth=acc.z_depth + reduce(buf.z_depth, valid & is_aux),
            reflection=acc.reflection + reduce(buf.reflection, valid),
            refraction=acc.refraction + reduce(buf.refraction, valid),
        )

    zeros = jnp.zeros((n, 3), jnp.float32)
    init = SampleBuffers(zeros, zeros, zeros, zeros, zeros, zeros)
    if n_chunks == 1:
        out = chunk(jnp.asarray(0, jnp.int32), init)
    else:
        out = jax.lax.fori_loop(0, n_chunks, chunk, init)
    if with_stats:
        return out, {"segments": None, "steps": n_chunks}
    return out


def finalize_buffers(acc: SampleBuffers, config: RenderConfig,
                     total_samples=None) -> dict:
    """Averages per the reference's per-buffer sample budgets
    (camera.hpp:529-541). Returns dict of [H, W, 3] images."""
    spp = total_samples if total_samples is not None else config.samples_per_pixel
    aux = min(config.aux_samples, spp)
    shape = (config.height, config.width, 3)
    return {
        "beauty": (acc.beauty / spp).reshape(shape),
        "albedo": (acc.albedo / aux).reshape(shape),
        "normal": (acc.normal / aux).reshape(shape),
        "z_depth": (acc.z_depth / aux).reshape(shape),
        "reflection": (acc.reflection / spp).reshape(shape),
        "refraction": (acc.refraction / spp).reshape(shape),
    }


def render(scene: Scene, cam: camera_mod.Camera, env, key,
           config: RenderConfig, with_stats: bool = False):
    """Full single-device render: spp passes accumulated on device.

    Returns dict of [H, W, 3] averaged buffers; with_stats (static) also
    returns the accumulate_samples stats dict (measured segment counts on
    the pooled-wavefront path).
    """
    # None = static identity marker, so downstream code can prove the ids
    # are the identity at trace time and skip per-spawn pixel gathers.
    pixel_ids = None
    if with_stats:
        acc, stats = accumulate_samples(scene, cam, env, key, config,
                                        pixel_ids, with_stats=True)
        return finalize_buffers(acc, config), stats
    acc = accumulate_samples(scene, cam, env, key, config, pixel_ids)
    return finalize_buffers(acc, config)
