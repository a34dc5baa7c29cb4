"""Texture system: padded image atlas + procedural checker, SoA-sampled.

JAX-native re-expression of the reference's polymorphic `texture` classes
(/root/reference/texture.hpp). Virtual `value(u, v, p)` dispatch becomes a
branchless gather from a fixed-shape atlas selected by integer texture id,
so any number of textures is one fused lookup on device.

Sampling semantics match texture.hpp:50-78: nearest-neighbor, u wraps
(u - floor(u)), v is clamped, rows are top-to-bottom. A failed image load is
the solid-cyan sentinel (texture.hpp:52-54). The 3-D checker matches
texture.hpp:118-126.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# Texture kinds.
KIND_IMAGE = 0
KIND_CHECKER = 1
KIND_MISSING = 2  # failed load -> cyan sentinel

# numpy on purpose: a module-level jnp array would be created on the
# default device at import time.
_CYAN = np.asarray([0.0, 1.0, 1.0], np.float32)


class TextureBank(NamedTuple):
    """All scene textures packed into one padded atlas (a pytree).

    K = number of textures, (AH, AW) = atlas pad size.
      data            f32[K, AH, AW, 3]  image texels (linear RGB)
      grad            f32[K, AH, AW, 2]  per-texel channel-0 neighbor deltas
                      (h[j,(i+1)%w]-h[j,i], h[min(j+1,h-1),i]-h[j,i]) — lets
                      the bump shader's three nearest-neighbor taps
                      (material.hpp:40-48) collapse into ONE gather: with
                      nearest sampling, h(u+du)-h(u) is either 0 (same
                      texel) or exactly the precomputed neighbor delta.
      size            i32[K, 2]          actual (width, height)
      kind            i32[K]             KIND_* tag
      checker_inv_scale f32[K]
      checker_even    f32[K, 3]
      checker_odd     f32[K, 3]
    """

    data: jax.Array
    grad: jax.Array
    size: jax.Array
    kind: jax.Array
    checker_inv_scale: jax.Array
    checker_even: jax.Array
    checker_odd: jax.Array

    @property
    def count(self) -> int:
        return self.kind.shape[0]


def sample(bank: TextureBank, tex_id, u, v, p, default):
    """Branchless batched texture lookup.

    tex_id i32[N]; u, v f32[N]; p f32[N,3]; default f32[N,3] returned where
    tex_id < 0 (the solid-albedo path). Returns f32[N,3].
    """
    tid = jnp.maximum(tex_id, 0)
    # One wide-row gather for all per-texture scalars: the metadata is
    # packed into a single [K, 10] f32 matrix. Sizes/kinds are tiny ints —
    # exact in f32.
    meta = jnp.concatenate(
        [bank.kind.astype(jnp.float32)[:, None],
         bank.size.astype(jnp.float32),
         bank.checker_inv_scale[:, None],
         bank.checker_even, bank.checker_odd], axis=1,
    )[tid]
    kind = meta[:, 0].astype(jnp.int32)
    w = meta[:, 1].astype(jnp.int32)
    h = meta[:, 2].astype(jnp.int32)

    # Image path (texture.hpp:56-75): wrap u, scale, clamp to edge.
    uu = u - jnp.floor(u)
    i = jnp.clip((uu * w).astype(jnp.int32), 0, jnp.maximum(w - 1, 0))
    j = jnp.clip((v * h).astype(jnp.int32), 0, jnp.maximum(h - 1, 0))
    # Flat single-axis row gather from the atlas; the reshape is a free
    # bitcast hoisted out of the loop.
    ah, aw = bank.data.shape[1], bank.data.shape[2]
    row = (tid * ah + j) * aw + i
    image_color = bank.data.reshape(-1, 3)[row]

    # Checker path (texture.hpp:118-126): parity of floored world coords.
    inv_scale = meta[:, 3][..., None]
    cells = jnp.floor(inv_scale * p).astype(jnp.int32)
    is_even = (cells[..., 0] + cells[..., 1] + cells[..., 2]) % 2 == 0
    checker_color = jnp.where(is_even[..., None], meta[:, 4:7], meta[:, 7:10])

    kind_b = kind[..., None]
    color = jnp.where(kind_b == KIND_IMAGE, image_color, checker_color)
    color = jnp.where(kind_b == KIND_MISSING, _CYAN, color)
    return jnp.where(tex_id[..., None] < 0, default, color)


def sample_soa(bank: TextureBank, tex_id, u, v, p, default):
    """SoA twin of sample: p and default are (x, y, z) component tuples of
    [N] arrays; returns an (r, g, b) tuple.

    Per-texture metadata and texel colors come from 1-D gathers out of
    transposed loop-invariant tables.
    """
    tid = jnp.maximum(tex_id, 0)
    f32 = jnp.float32
    meta_cols = (
        bank.kind.astype(f32), bank.size[:, 0].astype(f32),
        bank.size[:, 1].astype(f32), bank.checker_inv_scale,
        bank.checker_even[:, 0], bank.checker_even[:, 1],
        bank.checker_even[:, 2], bank.checker_odd[:, 0],
        bank.checker_odd[:, 1], bank.checker_odd[:, 2],
    )
    m = tuple(jnp.asarray(c, f32)[tid] for c in meta_cols)
    kind = m[0].astype(jnp.int32)
    w = m[1].astype(jnp.int32)
    h = m[2].astype(jnp.int32)

    # Image path (texture.hpp:56-75): wrap u, scale, clamp to edge.
    uu = u - jnp.floor(u)
    i = jnp.clip((uu * w).astype(jnp.int32), 0, jnp.maximum(w - 1, 0))
    j = jnp.clip((v * h).astype(jnp.int32), 0, jnp.maximum(h - 1, 0))
    ah, aw = bank.data.shape[1], bank.data.shape[2]
    row = (tid * ah + j) * aw + i
    flat = jnp.reshape(jnp.transpose(bank.data, (3, 0, 1, 2)), (3, -1))
    image_color = tuple(flat[c][row] for c in range(3))

    # Checker path (texture.hpp:118-126): parity of floored world coords.
    inv_scale = m[3]
    is_even = (
        jnp.floor(inv_scale * p[0]).astype(jnp.int32)
        + jnp.floor(inv_scale * p[1]).astype(jnp.int32)
        + jnp.floor(inv_scale * p[2]).astype(jnp.int32)
    ) % 2 == 0
    checker_color = tuple(
        jnp.where(is_even, m[4 + c], m[7 + c]) for c in range(3)
    )

    is_image = kind == KIND_IMAGE
    missing = kind == KIND_MISSING
    out = []
    for c in range(3):
        col = jnp.where(is_image, image_color[c], checker_color[c])
        col = jnp.where(missing, float(_CYAN[c]), col)
        out.append(jnp.where(tex_id < 0, default[c], col))
    return tuple(out)


def sample_bump_deltas(bank: TextureBank, tex_id, u, v, delta):
    """Finite-difference bump taps (h(u+delta,v)-h(u,v), h(u,v+delta)-h(u,v))
    with ONE texel gather.

    Bit-identical to three nearest-neighbor `sample` taps of channel 0
    (material.hpp:40-48 semantics) as long as delta spans at most one texel
    (delta * max(w, h) <= 1, true for the reference's 1/1024 step on its
    256-px bump maps): the difference is zero when the offset tap lands in
    the same texel and exactly the precomputed neighbor delta when it
    crosses (u wraps, v clamps — baked into TextureBank.grad).
    Returns (f_u [N], f_v [N]); zero where tex_id < 0.
    """
    tid = jnp.maximum(tex_id, 0)
    # Per-component 1-D gathers (see ops.intersect.make_record_soa).
    f32 = jnp.float32
    w = jnp.asarray(bank.size[:, 0], f32)[tid].astype(jnp.int32)
    h = jnp.asarray(bank.size[:, 1], f32)[tid].astype(jnp.int32)

    uu = u - jnp.floor(u)
    i = jnp.clip((uu * w).astype(jnp.int32), 0, jnp.maximum(w - 1, 0))
    j = jnp.clip((v * h).astype(jnp.int32), 0, jnp.maximum(h - 1, 0))
    ah, aw = bank.grad.shape[1], bank.grad.shape[2]
    gflat = jnp.reshape(jnp.transpose(bank.grad, (3, 0, 1, 2)), (2, -1))
    row = (tid * ah + j) * aw + i
    g_u = gflat[0][row]
    g_v = gflat[1][row]

    u2 = u + delta
    uu2 = u2 - jnp.floor(u2)
    i2 = jnp.clip((uu2 * w).astype(jnp.int32), 0, jnp.maximum(w - 1, 0))
    j2 = jnp.clip(((v + delta) * h).astype(jnp.int32), 0,
                  jnp.maximum(h - 1, 0))
    f_u = jnp.where((i2 != i) & (tex_id >= 0), g_u, 0.0)
    f_v = jnp.where((j2 != j) & (tex_id >= 0), g_v, 0.0)
    return f_u, f_v


class TextureBankBuilder:
    """Host-side accumulation of textures; `pack()` pads into the atlas."""

    def __init__(self):
        self._images: list[np.ndarray | None] = []
        self._kinds: list[int] = []
        self._checker: list[tuple[float, tuple, tuple]] = []

    def _push(self, kind, image=None, checker=(1.0, (0, 0, 0), (0, 0, 0))) -> int:
        tid = len(self._kinds)
        self._kinds.append(kind)
        self._images.append(image)
        self._checker.append(checker)
        return tid

    def add_image(self, pixels: np.ndarray) -> int:
        """pixels: float [H, W, 3] linear RGB, row 0 = top."""
        arr = np.asarray(pixels, np.float32)
        if arr.ndim != 3 or arr.shape[-1] != 3:
            raise ValueError(f"expected [H,W,3] image, got {arr.shape}")
        return self._push(KIND_IMAGE, image=arr)

    def add_checker(self, scale: float, even, odd) -> int:
        return self._push(KIND_CHECKER,
                          checker=(1.0 / scale, tuple(even), tuple(odd)))

    def add_missing(self) -> int:
        """Failed-load sentinel slot -> cyan (texture.hpp:52-54)."""
        return self._push(KIND_MISSING)

    def pack(self) -> TextureBank:
        kinds = self._kinds or [KIND_MISSING]
        images = self._images or [None]
        checker = self._checker or [(1.0, (0, 0, 0), (0, 0, 0))]

        ah = max([1] + [im.shape[0] for im in images if im is not None])
        aw = max([1] + [im.shape[1] for im in images if im is not None])
        k = len(kinds)
        data = np.zeros((k, ah, aw, 3), np.float32)
        grad = np.zeros((k, ah, aw, 2), np.float32)
        size = np.ones((k, 2), np.int32)
        for t, im in enumerate(images):
            if im is not None:
                h, w = im.shape[:2]
                data[t, :h, :w] = im
                size[t] = (w, h)
                hh = im[:, :, 0]
                grad[t, :h, :w, 0] = np.roll(hh, -1, axis=1) - hh  # u wraps
                grad[t, :h - 1, :w, 1] = hh[1:] - hh[:-1]          # v clamps
        return TextureBank(
            data=data,
            grad=grad,
            size=size,
            kind=np.asarray(kinds, np.int32),
            checker_inv_scale=np.asarray([c[0] for c in checker], np.float32),
            checker_even=np.asarray([c[1] for c in checker], np.float32),
            checker_odd=np.asarray([c[2] for c in checker], np.float32),
        )
