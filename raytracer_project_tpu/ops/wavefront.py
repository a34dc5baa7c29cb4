"""Pooled-wavefront integrator: dead lanes respawn new samples immediately.

The chunked integrator (integrator.accumulate_samples) advances a fixed
(pixel x sample) wavefront in lock-step for all `max_depth` bounces: lanes
whose path terminated early (sky miss, absorption, Russian roulette) idle as
masked no-ops while the stragglers finish, so late bounce iterations run at
a few percent occupancy — most of the brute-force intersection work is
wasted on dead lanes.

This module implements the classic wavefront-pool design: a fixed-size
lane pool where every step (a) advances all live paths one bounce and
(b) *refills* lanes whose path just ended with the next (pixel, sample)
work item. Occupancy stays ~100%, so total intersection work is
proportional to the actual number of path segments (~2-4 per sample)
instead of samples x max_depth (reference default 10, camera.hpp:30).
Everything is static-shaped: respawn is a masked prefix-sum assignment,
accumulation is scatter-add.

All per-lane vectors ride the loop as SoA component tuples (core/soa.py):
component [P] arrays have exactly one layout and every vector op is dense
elementwise.

Per-sample radiance is bit-identical to integrator.render_sample up to
float reassociation: lane randomness is keyed on (base key, sample, pixel,
bounce) exactly as there, so pooling only changes the *order* in which
finished samples are added into each pixel's accumulator. On a GPU the
scatter-adds may run as atomics, so that order (and the last bits of each
pixel sum) can also change from run to run.

Reference parity notes: bounce-0 lanes reproduce the first-hit-reuse
structure of camera.hpp:454-527 (shared first hit feeding beauty + AOVs +
reflection/refraction split passes); later bounces reproduce the iterative
ray_color loop (camera.hpp:928-986) including the weak-ray cutoff and
Russian roulette constants.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import rng, soa
from ..core.constants import (
    RR_P_MAX,
    RR_P_MIN,
    RR_START_BOUNCE,
    T_MIN,
    WEAK_RAY_EPS,
)
from ..models import camera as camera_mod
from ..models import environment as env_mod
from ..models.scene import Scene
from . import intersect, shade, volumes as volumes_mod
from .integrator import RenderConfig, SampleBuffers

# Default lane-pool size: big enough to keep intersection batches wide,
# small enough that the respawn tail (< one pool of partially-idle steps)
# stays negligible for real sample counts. Not yet re-derived on the GPU.
DEFAULT_POOL_SIZE = 262_144



class _PoolState(NamedTuple):
    # Work scheduling.
    next_work: jax.Array   # i32 [] next unclaimed work index
    live: jax.Array        # bool[P]
    # Path identity.
    li: jax.Array          # i32[P] local pixel slot (row in the accumulators)
    pix: jax.Array         # i32[P] global pixel id (keys + camera)
    samp: jax.Array        # i32[P] absolute sample index
    bounce: jax.Array      # i32[P] 0 = camera segment
    is_spec: jax.Array     # bool[P] reflection/refraction split-pass path
    # Ray state: (x, y, z) component tuples of f32[P] (core/soa.py).
    origin: tuple
    direction: tuple
    throughput: tuple
    radiance: tuple
    # Spec-pass routing decided at the first hit (camera.hpp:492-517).
    attn0: tuple           # first-hit attenuation
    to_refl: jax.Array     # bool[P]
    to_refr: jax.Array     # bool[P]
    # Enabled accumulators only (sums), stored as THREE 1-D [n_pixels + 1]
    # channel arrays per buffer (keys "beauty.x" etc.) with one overflow
    # slot for masked scatter-adds; see make_pool.
    acc: dict
    # Measured work: path segments actually traced (sum of live lanes per
    # step; f32 — bit-exact to 2^24 per-step increments, ~1e-7 relative
    # beyond, fine for a throughput metric) and loop steps taken. This is
    # the *actual* count the reference's UI estimator approximates from
    # above (main.cpp:101-113).
    segments: jax.Array    # f32 []
    steps: jax.Array       # i32 []


def _spawn(scene: Scene, cam, seed, config: RenderConfig, pixel_ids,
           sample_offset, n_beauty, work_id, identity_pixels=False):
    """Decode work item -> fresh lane state (bounce 0, camera ray).

    Work layout: [0, n_beauty) are beauty paths in sample-major order
    (w = s * n + li); [n_beauty, 2 * n_beauty) are the reflection/refraction
    split-pass paths in the same order.
    """
    n = pixel_ids.shape[0]
    is_spec = work_id >= n_beauty
    w = jnp.where(is_spec, work_id - n_beauty, work_id)
    samp_rel = w // n
    li = w - samp_rel * n
    samp = sample_offset + samp_rel
    if identity_pixels:
        # Full-frame render: pixel_ids is arange(n), so the gather is the
        # identity.
        pix = li
    else:
        pix = pixel_ids[li]

    # Camera draws always use ctx (bounce 0, beauty): the spec-pass path of
    # a (pixel, sample) re-traces the *same* camera ray as its beauty path
    # (camera.hpp:455,492), exactly like integrator.render_sample.
    lr0 = rng.LaneRng(seed, pix.astype(jnp.uint32), samp.astype(jnp.uint32),
                      jnp.uint32(0))
    o, d = camera_mod.generate_rays_soa(cam, lr0, pix, config.width,
                                        config.n_pixels)
    return li, pix, samp, is_spec, o, d


def _volumes_soa(volumes, o, d, hit, rec, lr):
    """Participating-media pass through the AoS implementation: pack the
    SoA record at this (cold, volumes-only) boundary and unpack the result.
    Scenes without volumes never reach this."""
    o_a, d_a = soa.pack(o), soa.pack(d)
    rec_a = intersect.HitRecord(
        t=rec.t, p=soa.pack(rec.p), normal=soa.pack(rec.normal),
        tangent=soa.pack(rec.tangent), bitangent=soa.pack(rec.bitangent),
        front_face=rec.front_face, u=rec.u, v=rec.v, mat=rec.mat,
        hit=rec.hit,
    )
    out = volumes_mod.apply_to_record(volumes, o_a, d_a, hit, rec_a, lr)
    return intersect.HitRecordSoa(
        t=out.t, p=soa.unpack(out.p), normal=soa.unpack(out.normal),
        tangent=soa.unpack(out.tangent),
        bitangent=soa.unpack(out.bitangent),
        front_face=out.front_face, u=out.u, v=out.v, mat=out.mat,
        hit=out.hit,
    )


def make_pool(scene: Scene, cam: camera_mod.Camera, env, key,
              config: RenderConfig, pixel_ids, sample_offset=0,
              pool_lanes: int | None = None):
    """Build the pooled-wavefront loop: returns (state0, cond, body).

    Exposed separately from render_pool so profiling harnesses can time a
    single `body` step under jit without running the full while_loop.
    """
    n = pixel_ids.shape[0]
    spp = config.samples_per_pixel
    aux = min(config.aux_samples, spp)
    want_spec = config.use_reflection or config.use_refraction
    n_beauty = n * spp
    total_work = n_beauty * (2 if want_spec else 1)
    p = pool_lanes or min(total_work, DEFAULT_POOL_SIZE)
    sample_offset = jnp.asarray(sample_offset, jnp.int32)
    seed = rng.seed_from_key(key)
    # Static identity check: render() passes arange(n_pixels) for full
    # frames, making the per-spawn pixel-id gather a no-op.
    import numpy as np
    identity_pixels = (
        isinstance(pixel_ids, np.ndarray) or not isinstance(pixel_ids, jax.Array)
    ) and n == config.n_pixels and bool(
        np.array_equal(np.asarray(pixel_ids), np.arange(n))
    )

    # Accumulators: only the config-enabled buffers ride the loop carry,
    # and each is pre-padded with one overflow row so masked scatter-adds
    # need no per-step concatenate/slice copies.
    acc_fields = ["beauty"]
    if config.use_albedo:
        acc_fields.append("albedo")
    if config.use_normal:
        acc_fields.append("normal")
    if config.use_z_depth:
        acc_fields.append("z_depth")
    if want_spec:
        acc_fields += ["reflection", "refraction"]
    acc0 = {f"{f}.{c}": jnp.zeros((n + 1,), jnp.float32)
            for f in acc_fields for c in "xyz"}

    # --- initial fill: work items [0, p) ---
    w0 = jnp.arange(p, dtype=jnp.int32)
    li, pix, samp, is_spec, o, d = _spawn(
        scene, cam, seed, config, pixel_ids, sample_offset, n_beauty, w0,
        identity_pixels,
    )
    f = jnp.zeros((p,), bool)
    ones3 = lambda: tuple(jnp.ones((p,), jnp.float32) for _ in range(3))
    zeros3 = lambda: tuple(jnp.zeros((p,), jnp.float32) for _ in range(3))
    state = _PoolState(
        next_work=jnp.asarray(min(p, total_work), jnp.int32),
        live=w0 < total_work,
        li=li, pix=pix, samp=samp,
        bounce=jnp.zeros((p,), jnp.int32),
        is_spec=is_spec,
        origin=o, direction=d,
        throughput=ones3(),
        radiance=zeros3(),
        attn0=ones3(),
        to_refl=f, to_refr=f,
        acc=acc0,
        segments=jnp.zeros((), jnp.float32),
        steps=jnp.zeros((), jnp.int32),
    )

    def scatter_add(acc, name, mask, slot, val):
        """acc[name.{xyz}][n+1] += val[c] where mask (masked lanes hit
        the overflow slot); val is an (x, y, z) component tuple."""
        tgt = jnp.where(mask, slot, n)
        for ci, c in enumerate("xyz"):
            acc[f"{name}.{c}"] = acc[f"{name}.{c}"].at[tgt].add(
                jnp.where(mask, val[ci], 0.0)
            )
        return acc

    def cond(s: _PoolState):
        return jnp.any(s.live)

    def body(s: _PoolState):
        at0 = s.bounce == 0
        # Per-lane stateless stream at this lane's (bounce, pass) context —
        # identical draws to integrator.render_sample/trace by construction.
        lr = rng.LaneRng(
            seed, s.pix.astype(jnp.uint32), s.samp.astype(jnp.uint32),
            (s.bounce.astype(jnp.uint32) << jnp.uint32(1))
            | s.is_spec.astype(jnp.uint32),
        )

        hit = intersect.intersect_soa(scene, s.origin, s.direction, T_MIN)
        rec = intersect.make_record_soa(scene, s.origin, s.direction, hit)
        if scene.volumes is not None:
            rec = _volumes_soa(scene.volumes, s.origin, s.direction, hit,
                               rec, lr)
        bg = env_mod.background_color_soa(env, s.direction, config.env_mode)
        sc = shade.scatter_soa(scene, rec, s.direction, lr)

        # --- radiance / path-state update (trace body semantics) ---
        # Spec paths skip first-hit emission: their trace starts *after* the
        # first scatter with throughput 1 (camera.hpp:494-498).
        emit_ok = ~(at0 & s.is_spec)
        miss = s.live & ~rec.hit
        radiance = tuple(
            s.radiance[k]
            + jnp.where(miss, s.throughput[k] * bg[k], 0.0)
            for k in range(3)
        )
        active = s.live & rec.hit
        emit_lanes = active & emit_ok
        radiance = tuple(
            radiance[k]
            + jnp.where(emit_lanes, s.throughput[k] * sc.emitted[k], 0.0)
            for k in range(3)
        )
        gain = active & sc.scattered & emit_ok
        throughput = soa.where(gain, soa.mul(s.throughput, sc.attenuation),
                               s.throughput)
        active = active & sc.scattered

        # Weak-ray cutoff + Russian roulette: late = trace-local bounce
        # (bounce - 1) strictly past RR_START_BOUNCE (camera.hpp:967-983);
        # never fires on the camera segment.
        late = (s.bounce - 1) > RR_START_BOUNCE
        weak = late & (soa.length(throughput) < WEAK_RAY_EPS)
        active = active & ~weak
        p_rr = jnp.clip(
            jnp.maximum(throughput[0],
                        jnp.maximum(throughput[1], throughput[2])),
            RR_P_MIN, RR_P_MAX,
        )
        u = rng.draw_uniform(lr, rng.STREAM_RR)
        active = active & ~(late & (u > p_rr))
        throughput = soa.where(late & active,
                               soa.scale(throughput, 1.0 / p_rr), throughput)

        # Depth exhausted: the continuation runs bounces 1..max_depth-1.
        active = active & (s.bounce + 1 < config.max_depth)

        # --- spec-pass routing flags, decided at the first hit ---
        # (compiled out entirely when neither specular AOV is enabled)
        to_refl, to_refr, attn0 = s.to_refl, s.to_refr, s.attn0
        if want_spec:
            spec0 = at0 & s.is_spec & s.live
            unit_d = soa.normalize(s.direction)
            refl_dir = soa.reflect(unit_d, soa.normalize(rec.normal))
            is_specular = soa.dot(soa.normalize(sc.direction), refl_dir) > 0.9
            entering = soa.dot(sc.direction, rec.normal) < 0.0
            spec_live = rec.hit & sc.scattered
            to_refl = jnp.where(
                spec0, spec_live & is_specular & config.use_reflection, s.to_refl
            )
            to_refr = jnp.where(
                spec0,
                spec_live & ~is_specular & entering & config.use_refraction,
                s.to_refr,
            )
            attn0 = soa.where(spec0, sc.attenuation, s.attn0)
            # Spec paths routed to neither buffer are dead work: kill now.
            active = active & ~(spec0 & ~(to_refl | to_refr))

        # --- AOV contributions from beauty camera segments ---
        acc = dict(s.acc)
        cam0 = at0 & ~s.is_spec & s.live
        is_aux = cam0 & (s.samp < aux)
        zero = jnp.zeros_like(rec.u)
        if config.use_albedo:
            alb = shade.get_albedo_soa(scene, rec)
            albedo = soa.where(rec.hit, alb, (zero, zero, zero))
            acc = scatter_add(acc, "albedo", is_aux, s.li, albedo)
        if config.use_normal:
            nc = camera_mod.view_space_normal_color_soa(cam, rec.normal)
            half = jnp.full_like(rec.u, 0.5)
            one = jnp.ones_like(rec.u)
            normal = soa.where(rec.hit, nc, (half, half, one))
            acc = scatter_add(acc, "normal", is_aux, s.li, normal)
        if config.use_z_depth:
            zval = 1.0 - jnp.clip(rec.t / config.z_depth_max_dist, 0.0, 1.0)
            zval = jnp.where(rec.hit, zval, 0.0)
            acc = scatter_add(acc, "z_depth", is_aux, s.li,
                              (zval, zval, zval))

        # --- finished paths -> accumulators ---
        done = s.live & ~active
        done_beauty = done & ~s.is_spec
        acc = scatter_add(acc, "beauty", done_beauty, s.li, radiance)
        if want_spec:
            # Firefly clamp on the continuation color, then modulate by the
            # stored first-hit attenuation (camera.hpp:499-509).
            luma = 0.2126 * soa.length(radiance)
            scale = jnp.where(luma > 2.0, 2.0 / jnp.maximum(luma, 1e-12), 1.0)
            contrib = soa.mul(attn0, soa.scale(radiance, scale))
            acc = scatter_add(acc, "reflection", done & to_refl, s.li, contrib)
            acc = scatter_add(acc, "refraction", done & to_refr, s.li, contrib)

        # --- respawn finished/idle lanes with fresh work ---
        free = ~s.live | done
        rank = jnp.cumsum(free.astype(jnp.int32)) - 1
        new_w = s.next_work + rank
        can_spawn = free & (new_w < total_work)
        n_spawned = jnp.minimum(
            jnp.sum(free.astype(jnp.int32)),
            total_work - s.next_work,
        )
        sli, spix, ssamp, sspec, so, sd = _spawn(
            scene, cam, seed, config, pixel_ids, sample_offset, n_beauty,
            jnp.clip(new_w, 0, total_work - 1), identity_pixels,
        )
        sel = lambda fresh, old: jnp.where(can_spawn, fresh, old)
        sel3 = lambda fresh, old: soa.where(can_spawn, fresh, old)
        one3 = tuple(jnp.ones((p,), jnp.float32) for _ in range(3))
        zero3 = tuple(jnp.zeros((p,), jnp.float32) for _ in range(3))
        return _PoolState(
            next_work=s.next_work + n_spawned,
            live=(s.live & active) | can_spawn,
            li=sel(sli, s.li),
            pix=sel(spix, s.pix),
            samp=sel(ssamp, s.samp),
            bounce=jnp.where(can_spawn, 0, s.bounce + 1),
            is_spec=sel(sspec, s.is_spec),
            origin=sel3(so, soa.where(active, sc.origin, s.origin)),
            direction=sel3(sd, soa.where(active, sc.direction, s.direction)),
            throughput=sel3(one3, throughput),
            radiance=sel3(zero3, radiance),
            attn0=sel3(one3, attn0),
            to_refl=sel(f, to_refl),
            to_refr=sel(f, to_refr),
            acc=acc,
            segments=s.segments + jnp.sum(s.live.astype(jnp.float32)),
            steps=s.steps + 1,
        )

    return state, cond, body


def render_pool(scene: Scene, cam: camera_mod.Camera, env, key,
                config: RenderConfig, pixel_ids, sample_offset=0,
                pool_lanes: int | None = None, with_stats: bool = False,
                pixel_offset=0, n_pixels_local: int | None = None):
    """Pooled-wavefront accumulation: drop-in for accumulate_samples.

    Returns per-pixel *sums* over `config.samples_per_pixel` samples, same
    contract (and same per-sample values up to float reassociation) as
    integrator.accumulate_samples. Requires the non-differentiable path
    (uses while_loop + scatter-add).

    with_stats: also return {"segments", "steps"} — the measured number of
    path segments traced (the quantity the reference UI's
    W·H·spp·max_depth/Δt metric upper-bounds, main.cpp:101-113) and the
    number of pool steps taken.

    pixel_ids=None means "the identity full frame" statically — the only
    way a jitted caller (e.g. the progressive session) can assert identity
    at trace time, where any array argument is a tracer. With
    n_pixels_local it means the identity pixel WINDOW
    [pixel_offset, pixel_offset + n_pixels_local), clamped to the frame.
    """
    import numpy as np

    if pixel_ids is None:
        if n_pixels_local is None:
            pixel_ids = np.arange(config.n_pixels, dtype=np.int32)
        else:
            # Clamped identity slice — same padding semantics as
            # parallel.render._padded_pixel_ids (trailing lanes re-render
            # pixel n-1, dropped on unpad).
            pixel_ids = jnp.minimum(
                jnp.asarray(pixel_offset, jnp.int32)
                + jnp.arange(n_pixels_local, dtype=jnp.int32),
                config.n_pixels - 1,
            )
    else:
        assert n_pixels_local is None, \
            "pixel window mode requires pixel_ids=None"

    state, cond, body = make_pool(
        scene, cam, env, key, config, pixel_ids, sample_offset, pool_lanes
    )
    final = jax.lax.while_loop(cond, body, state)
    n = pixel_ids.shape[0]
    zeros3 = jnp.zeros((n, 3), jnp.float32)
    get = lambda f: (
        jnp.stack([final.acc[f"{f}.{c}"][:n] for c in "xyz"], axis=-1)
        if f"{f}.x" in final.acc else zeros3
    )
    out = SampleBuffers(
        beauty=get("beauty"), albedo=get("albedo"), normal=get("normal"),
        z_depth=get("z_depth"), reflection=get("reflection"),
        refraction=get("refraction"),
    )
    if with_stats:
        return out, {"segments": final.segments, "steps": final.steps}
    return out
