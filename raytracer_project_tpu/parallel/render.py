"""Multi-chip rendering: pixel-tile sharding over a jax device mesh.

JAX-native replacement for the reference's row-block std::thread fan-out
(/root/reference/camera.hpp:556-573): the image's pixel axis is sharded over
a 1-D `tiles` mesh axis with `jax.shard_map`; the scene/BVH/materials are
replicated into every device's memory (the scenes are small — the
reference likewise shares the scene across threads, §SURVEY 5.8).

Because all randomness is keyed on (base_key, global pixel id, sample)
(see core/rng.py), every pixel of an N-device render sums the same
samples as the 1-device render. On the CPU the two are bit-identical (the
shard-invariance property the test suite asserts); on a GPU the pool's
scatter-add order may differ between runs, so they agree to float
rounding.

Multi-host: parallel/distributed.py owns the process group
(`init_distributed` -> jax.distributed.initialize, `make_global_mesh`,
`gather_to_host0`); the same shard_map here runs over the global mesh,
statistics reduce with psum
(analyze_sharded), and only the final gather for preview/export crosses
to host 0. tests/test_distributed.py runs this for real with 2 processes
x 4 virtual devices.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import integrator

TILE_AXIS = "tiles"


def make_mesh(n_devices: int | None = None) -> Mesh:
    """1-D device mesh over the pixel-tile axis."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), axis_names=(TILE_AXIS,))


def _padded_pixel_ids(n_pixels: int, n_shards: int) -> np.ndarray:
    """Global pixel ids padded to a multiple of the shard count.

    Padding lanes re-render pixel (n-1); their results are dropped on
    unpad. Wasted lanes <= n_shards - 1. Returned as HOST numpy so
    sharded_accumulate can prove the clamped-identity pattern at trace
    time and render each shard as a pixel window.
    """
    padded = -(-n_pixels // n_shards) * n_shards
    return np.minimum(np.arange(padded, dtype=np.int32), n_pixels - 1)


def render_sharded(scene, cam, env, key, config: integrator.RenderConfig,
                   mesh: Mesh) -> dict:
    """Full render with pixels sharded across `mesh`; returns [H, W, 3]
    buffer dict identical to integrator.render()."""
    n = config.n_pixels
    ids = _padded_pixel_ids(n, mesh.devices.size)
    acc = sharded_accumulate(scene, cam, env, key, config, ids, 0,
                             mesh=mesh)
    acc = jax.tree.map(lambda x: x[:n], acc)
    return integrator.finalize_buffers(acc, config)


def render_sharded_jit(config: integrator.RenderConfig, mesh: Mesh):
    """jit-compiled sharded renderer closed over static config + mesh."""
    fn = functools.partial(render_sharded, config=config, mesh=mesh)
    return jax.jit(fn)


def sharded_accumulate(scene, cam, env, key, config: integrator.RenderConfig,
                       ids_padded, sample_offset, *, mesh: Mesh,
                       with_stats: bool = False):
    """accumulate_samples with the pixel axis sharded over `mesh`.

    ids_padded: global pixel ids, length a multiple of the shard count
    (see _padded_pixel_ids). Returns per-pixel SUMS (padded length) so a
    progressive session can keep adding chunks; with_stats additionally
    returns {"segments", "steps"} psum'd across shards. This is the
    product-surface step function RenderSession uses when given a mesh —
    the counterpart of the reference's render-thread row fan-out
    (/root/reference/main.cpp:1520-1531, camera.hpp:556-573).

    When ids_padded is a host array with the clamped-identity pattern
    (what _padded_pixel_ids builds), each shard renders its slice as an
    identity pixel WINDOW (pixel_offset = shard * n_local). Arbitrary id
    arrays take the gather-based pool.
    """
    n_shards = mesh.devices.size
    n = config.n_pixels
    ids_np = (np.asarray(ids_padded)
              if not isinstance(ids_padded, jax.Array) else None)
    identity_window = (
        ids_np is not None
        and ids_np.shape[0] % n_shards == 0
        and bool(np.array_equal(
            ids_np, np.minimum(np.arange(ids_np.shape[0]), n - 1)))
    )

    def _stats_reduce(out):
        buf, stats = out
        segments = stats.get("segments")
        return buf, {
            "segments": (jax.lax.psum(segments, TILE_AXIS)
                         if segments is not None else jnp.zeros(())),
            "steps": jax.lax.pmax(
                jnp.asarray(stats["steps"], jnp.int32), TILE_AXIS),
        }

    out_specs = ((P(TILE_AXIS), {"segments": P(), "steps": P()})
                 if with_stats else P(TILE_AXIS))

    if identity_window:
        n_local = ids_np.shape[0] // n_shards

        @functools.partial(
            jax.shard_map, mesh=mesh,
            in_specs=(P(), P(), P(), P(), P()),
            out_specs=out_specs, check_vma=False,
        )
        def shard_fn_window(scene_, cam_, env_, key_, off_):
            poff = jax.lax.axis_index(TILE_AXIS).astype(jnp.int32) * n_local
            out = integrator.accumulate_samples(
                scene_, cam_, env_, key_, config, None, off_,
                with_stats=with_stats, pixel_offset=poff,
                n_pixels_local=n_local,
            )
            return _stats_reduce(out) if with_stats else out

        return shard_fn_window(scene, cam, env, key,
                               jnp.asarray(sample_offset, jnp.int32))

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(TILE_AXIS), P()),
        out_specs=out_specs,
        check_vma=False,
    )
    def shard_fn(scene_, cam_, env_, key_, ids_local, off_):
        out = integrator.accumulate_samples(
            scene_, cam_, env_, key_, config, ids_local, off_,
            with_stats=with_stats,
        )
        return _stats_reduce(out) if with_stats else out

    return shard_fn(scene, cam, env, key, jnp.asarray(ids_padded),
                    jnp.asarray(sample_offset, jnp.int32))


def analyze_sharded(image_flat, mesh: Mesh):
    """psum'd image statistics over a pixel-sharded flat [N, 3] buffer.

    Stats reduce on-device with collectives (no full-image host gather) —
    closes the 'the caller psums' IOU in ops/post.analyze_framebuffer.
    """
    from ..ops import post as post_mod

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=P(TILE_AXIS),
        out_specs=P(),
        check_vma=False,
    )
    def fn(local):
        return post_mod.analyze_framebuffer_psum(local, TILE_AXIS)

    return fn(image_flat)
