"""Counter-based RNG sampling primitives.

The reference uses one process-wide Mersenne-Twister shared (racily) across
all render threads (/root/reference/common.hpp:29-34). The JAX-native design
replaces it with JAX threefry counter-based keys derived from
(frame, pixel, sample, bounce) so every sample is deterministic,
shard-invariant, and replayable — required for golden-image tests, gradient
checks, and N-device == 1-device invariance.

Distributions match the reference's samplers in law (not in draw order):
 - unit sphere vectors  (vec3.hpp:184-191, rejection)  -> gaussian-normalize
 - unit disk points     (vec3.hpp:174-181, rejection)  -> polar warp
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# Stateless lane RNG (ChaCha-round counter hash) — the hot-path sampler
# ---------------------------------------------------------------------------
#
# The integrator's inner loop draws a handful of uniforms per (pixel, sample,
# bounce). Deriving those through per-lane threefry keys (fold_in/split per
# lane) costs dozens of u32 rounds per draw plus [n, 6, 2] key arrays. The
# mix here is three ChaCha quarter-rounds (Bernstein 2008) on the four
# counter words: adds/xors/rotates only, with full avalanche (a
# quarter-round chain reaches complete diffusion after two rounds).
#
# Every draw is a pure function of (seed, pixel, sample, context, stream):
#   seed    u32 scalar   render-level (from the user's PRNGKey)
#   pixel   u32 [n]      global pixel id        — shard invariance
#   sample  u32 [n]      absolute sample index  — progressive invariance
#   context u32 [n]      (absolute bounce << 1) | spec-pass flag
#   stream  static int   draw site (camera / scatter / RR / volume)
# so any batching, pooling, sharding, or chunking is bit-identical, exactly
# like the threefry scheme it replaces (the *law* of each sampler is
# unchanged; individual draws differ).

# numpy scalars on purpose: module-level jnp scalars would be created on
# the default device at import time.
_C0 = np.uint32(0x9E3779B9)  # golden-ratio / Murmur3 odd constants: they
_C1 = np.uint32(0x85EBCA6B)  # break the all-zero fixed point of the
_C2 = np.uint32(0xC2B2AE35)  # quarter-round and decorrelate the word roles
_C3 = np.uint32(0x27D4EB2F)

# Draw-site stream ids (static; must stay < _N_STREAMS).
STREAM_CAMERA = 0
STREAM_SCATTER = 1
STREAM_RR = 2
STREAM_VOLUME = 3
_N_STREAMS = 16


class LaneRng(NamedTuple):
    """Per-lane stateless random stream (see module docstring).

    seed is a u32 scalar; pix/samp/ctx are u32 arrays of the lane batch
    shape (ctx may also be a scalar when every lane shares the context).
    """

    seed: jax.Array
    pix: jax.Array
    samp: jax.Array
    ctx: jax.Array

    def with_ctx(self, bounce, spec=None) -> "LaneRng":
        """Context from an absolute bounce index (+ optional spec flag)."""
        b = jnp.asarray(bounce, jnp.uint32)
        ctx = b << jnp.uint32(1)
        if spec is not None:
            ctx = ctx | jnp.asarray(spec, jnp.uint32)
        return self._replace(ctx=ctx)


def seed_from_key(key) -> jax.Array:
    """u32 scalar seed from a jax PRNGKey (new-style or raw [2]u32)."""
    data = jax.random.key_data(key).reshape(-1).astype(jnp.uint32)
    return data[0] + data[-1] * jnp.uint32(0x9E3779B9)


def lane_rng(key, pix, samp=0, ctx=0) -> LaneRng:
    """Build a LaneRng; key may be a PRNGKey or an existing u32 seed."""
    seed = key if (getattr(key, "dtype", None) == jnp.uint32
                   and jnp.ndim(key) == 0) else seed_from_key(key)
    u32 = lambda x: jnp.asarray(x, jnp.uint32)
    return LaneRng(seed=seed, pix=u32(pix), samp=u32(samp), ctx=u32(ctx))


def _rotl(x, r: int):
    return (x << jnp.uint32(r)) | (x >> jnp.uint32(32 - r))


def _mix4(a, b, c, d):
    """Counter mix: four u32 words in, four decorrelated u32 words out.

    Three ChaCha quarter-rounds over the 4-word state — add/xor/rotate
    only (see the comment above). Constants _C0.._C3 are mixed
    in first so the all-zero counter does not fix the add/xor lattice.
    """
    a = a ^ _C0
    b = b + _C1
    c = c ^ _C2
    d = d + _C3
    for _ in range(3):
        a = a + b
        d = _rotl(d ^ a, 16)
        c = c + d
        b = _rotl(b ^ c, 12)
        a = a + b
        d = _rotl(d ^ a, 8)
        c = c + d
        b = _rotl(b ^ c, 7)
    return a, b, c, d


def bits4(lr: LaneRng, stream: int, salt: int = 0):
    """Four u32 words for this lane batch at the given draw site."""
    word = lr.ctx * jnp.uint32(_N_STREAMS) + jnp.uint32(stream)
    # Mask to 32 bits BEFORE the jnp.uint32 cast: salt >= 2 makes the
    # Python product exceed uint32 and jnp.uint32() raises OverflowError
    # (hit by any scene with two or more fog volumes).
    seed = lr.seed + jnp.uint32((salt * 0x85EBCA6B) & 0xFFFFFFFF)
    n = jnp.broadcast_shapes(jnp.shape(lr.pix), jnp.shape(lr.samp),
                             jnp.shape(word))
    return _mix4(jnp.broadcast_to(lr.pix, n), jnp.broadcast_to(lr.samp, n),
                  jnp.broadcast_to(word, n), jnp.broadcast_to(seed, n))


def _u01(bits) -> jax.Array:
    """u32 -> f32 uniform in [0, 1): top 24 bits, exact integer convert."""
    return (bits >> jnp.uint32(8)).astype(jnp.int32).astype(jnp.float32) * (
        1.0 / 16777216.0
    )


def draw_uniform(lr: LaneRng, stream: int, salt: int = 0) -> jax.Array:
    """One f32 uniform in [0,1) per lane."""
    a, _, _, _ = bits4(lr, stream, salt)
    return _u01(a)


def draw_unit_vector_and_uniform(lr: LaneRng, stream: int):
    """(uniform unit sphere vector [n,3], uniform [n]) from one hash.

    Sphere law matches the reference's rejection sampler
    (vec3.hpp:184-191) via the (cos-theta, phi) parameterization.
    """
    a, b, c, _ = bits4(lr, stream)
    z = 1.0 - 2.0 * _u01(a)
    phi = (2.0 * jnp.pi) * _u01(b)
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    vec = jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)
    return vec, _u01(c)


def draw_unit_vector_and_uniform_soa(lr: LaneRng, stream: int):
    """SoA twin of draw_unit_vector_and_uniform: ((x, y, z), uniform).

    Identical draws (same hash, same warp); only the output container
    differs — component tuples keep the hot loop free of [N, 3] layouts
    (see core/soa.py)."""
    a, b, c, _ = bits4(lr, stream)
    z = 1.0 - 2.0 * _u01(a)
    phi = (2.0 * jnp.pi) * _u01(b)
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    return (r * jnp.cos(phi), r * jnp.sin(phi), z), _u01(c)


def draw_camera(lr: LaneRng, stream: int = STREAM_CAMERA):
    """(sub-pixel jitter [n,2] in [-0.5,0.5]^2, unit-disk point [n,2])
    from one hash — the two camera draws (camera.hpp:784-794)."""
    a, b, c, d = bits4(lr, stream)
    jitter = jnp.stack([_u01(a) - 0.5, _u01(b) - 0.5], axis=-1)
    r = jnp.sqrt(_u01(c))
    theta = (2.0 * jnp.pi) * _u01(d)
    disk = jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)
    return jitter, disk


def per_lane_keys(base_key: jax.Array, lane_ids: jax.Array) -> jax.Array:
    """Derive one key per lane by folding in a *global* lane id.

    This is the shard-invariance keystone: a pixel's randomness depends only
    on (base_key, pixel_id), never on batch position, so a sharded render is
    bit-identical to a single-device render.
    """
    return jax.vmap(lambda i: jax.random.fold_in(base_key, i))(lane_ids)


def fold_each(keys: jax.Array, data) -> jax.Array:
    """fold_in applied per-lane; `data` is a scalar or [n] array."""
    if jnp.ndim(data) == 0:
        return jax.vmap(lambda k: jax.random.fold_in(k, data))(keys)
    return jax.vmap(jax.random.fold_in)(keys, data)


def split_each(keys: jax.Array, num: int) -> tuple[jax.Array, ...]:
    """Per-lane key split: [n,2] -> num arrays of [n,2]."""
    out = jax.vmap(lambda k: jax.random.split(k, num))(keys)
    return tuple(out[:, i] for i in range(num))


def uniform_each(keys: jax.Array, lo=0.0, hi=1.0) -> jax.Array:
    """One uniform scalar per lane; [n]."""
    return jax.vmap(
        lambda k: jax.random.uniform(k, (), minval=lo, maxval=hi,
                                     dtype=jnp.float32)
    )(keys)


def unit_vector_each(keys: jax.Array) -> jax.Array:
    """One uniform unit sphere vector per lane; [n, 3]."""
    g = jax.vmap(lambda k: jax.random.normal(k, (3,), dtype=jnp.float32))(keys)
    norm = jnp.sqrt(jnp.sum(g * g, axis=-1, keepdims=True))
    return g / jnp.maximum(norm, 1e-12)


def in_unit_disk_each(keys: jax.Array) -> jax.Array:
    """One uniform unit-disk point per lane; [n, 3] (z = 0)."""
    u = jax.vmap(lambda k: jax.random.uniform(k, (2,), dtype=jnp.float32))(keys)
    r = jnp.sqrt(u[:, 0])
    theta = 2.0 * jnp.pi * u[:, 1]
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta),
                      jnp.zeros_like(r)], axis=-1)


def square_jitter_each(keys: jax.Array) -> jax.Array:
    """One [-0.5, 0.5]^2 jitter per lane; [n, 2] (camera.hpp:817-819)."""
    return jax.vmap(
        lambda k: jax.random.uniform(k, (2,), minval=-0.5, maxval=0.5,
                                     dtype=jnp.float32)
    )(keys)


def uniform(key, shape=(), lo=0.0, hi=1.0):
    return jax.random.uniform(key, shape, minval=lo, maxval=hi, dtype=jnp.float32)


def unit_vector(key, shape=()):
    """Uniform direction on the unit sphere; shape [..., 3].

    Matches the law of the reference's rejection sampler (vec3.hpp:184-191)
    via normalized gaussians — branchless.
    """
    g = jax.random.normal(key, tuple(shape) + (3,), dtype=jnp.float32)
    norm = jnp.sqrt(jnp.sum(g * g, axis=-1, keepdims=True))
    return g / jnp.maximum(norm, 1e-12)


def in_unit_disk(key, shape=()):
    """Uniform point in the unit disk (z=0); shape [..., 3].

    Same law as the reference's rejection sampler (vec3.hpp:174-181)
    via the polar square-root warp.
    """
    k1, k2 = jax.random.split(key)
    r = jnp.sqrt(uniform(k1, shape))
    theta = uniform(k2, shape, 0.0, 2.0 * jnp.pi)
    zeros = jnp.zeros_like(r)
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta), zeros], axis=-1)


def square_jitter(key, shape=()):
    """Sub-pixel jitter in [-0.5, 0.5]^2 (camera.hpp:817-819); shape [..., 2]."""
    return jax.random.uniform(
        key, tuple(shape) + (2,), minval=-0.5, maxval=0.5, dtype=jnp.float32
    )
