"""Thin-lens perspective camera.

JAX-native equivalent of the reference camera's viewport setup and ray
generation (/root/reference/camera.hpp:358-402, 784-825). Instead of a
per-pixel `get_ray(i, j)` call, `generate_rays` produces the whole
[H*W]-ray wavefront in one fused op, jittered and defocus-sampled from
counter-based keys.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import rng, vecmath
from ..core.constants import degrees_to_radians


class Camera(NamedTuple):
    """Derived camera frame (all float32 jnp scalars/vectors; a pytree)."""

    center: jax.Array        # [3] lookfrom
    pixel00: jax.Array       # [3] center of pixel (0, 0)
    pixel_delta_u: jax.Array  # [3] step right one pixel
    pixel_delta_v: jax.Array  # [3] step down one pixel
    u: jax.Array             # [3] camera right
    v: jax.Array             # [3] camera up
    w: jax.Array             # [3] camera backward (lookfrom - lookat)
    defocus_disk_u: jax.Array  # [3] aperture disk basis (zero if no defocus)
    defocus_disk_v: jax.Array  # [3]


def make_camera(
    *,
    image_width: int,
    image_height: int,
    vfov: float = 30.0,
    lookfrom=(0.0, 0.0, 0.0),
    lookat=(0.0, 0.0, -1.0),
    vup=(0.0, 1.0, 0.0),
    defocus_angle: float = 0.0,
    focus_dist: float = 10.0,
) -> Camera:
    """Build the derived camera frame (camera.hpp:358-402 semantics)."""
    image_width = max(1, int(image_width))
    image_height = max(1, int(image_height))
    aspect = image_width / image_height

    lookfrom = np.asarray(lookfrom, np.float32)
    lookat = np.asarray(lookat, np.float32)
    vup = np.asarray(vup, np.float32)

    h = np.tan(degrees_to_radians(vfov) / 2.0)
    viewport_height = 2.0 * h * focus_dist
    viewport_width = viewport_height * aspect

    def _unit(x):
        n = np.linalg.norm(x)
        return x / n if n > 1e-12 else np.zeros_like(x)

    w = _unit(lookfrom - lookat)
    u = _unit(np.cross(vup, w))
    v = np.cross(w, u)

    viewport_u = viewport_width * u
    viewport_v = viewport_height * -v
    pixel_delta_u = viewport_u / image_width
    pixel_delta_v = viewport_v / image_height

    viewport_upper_left = lookfrom - focus_dist * w - viewport_u / 2 - viewport_v / 2
    pixel00 = viewport_upper_left + 0.5 * (pixel_delta_u + pixel_delta_v)

    # Branchless defocus: zero-radius disk == pinhole (camera.hpp:790).
    defocus_radius = focus_dist * np.tan(degrees_to_radians(max(defocus_angle, 0.0) / 2.0))
    if defocus_angle <= 0.0:
        defocus_radius = 0.0

    f32 = lambda x: jnp.asarray(x, jnp.float32)
    return Camera(
        center=f32(lookfrom),
        pixel00=f32(pixel00),
        pixel_delta_u=f32(pixel_delta_u),
        pixel_delta_v=f32(pixel_delta_v),
        u=f32(u),
        v=f32(v),
        w=f32(w),
        defocus_disk_u=f32(u * defocus_radius),
        defocus_disk_v=f32(v * defocus_radius),
    )


def pixel_rowcol_f32(pixel_ids: jax.Array, width: int,
                     n_pixels: int | None = None):
    """Row/col split of row-major pixel ids in f32: (col f32, row f32).

    The f32 estimate floor((pix+0.5)/w) can be off by one above ~5M pixels, so
    one exact integer correction follows: pf and jj*width are integers
    < 2^24, hence their f32 difference is exact and the remainder test is
    exact. PRECONDITION: pixel ids < 2^24 — beyond that pixel ids are not
    f32-representable and no correction can recover, so when the caller
    passes n_pixels >= 2^24 (e.g. 8K frames: 7680x4320 = 33.2M) this falls
    back to the exact i32 div/mod path.
    """
    if n_pixels is not None and n_pixels >= (1 << 24):
        jj_i = pixel_ids // width
        return (pixel_ids - jj_i * width).astype(jnp.float32), \
            jj_i.astype(jnp.float32)
    pf = pixel_ids.astype(jnp.float32)
    jj = jnp.floor((pf + 0.5) * (1.0 / width))
    ii = pf - jj * width
    jj = jnp.where(ii < 0.0, jj - 1.0, jnp.where(ii >= width, jj + 1.0, jj))
    ii = pf - jj * width
    return ii, jj


def generate_rays(cam: Camera, keys, pixel_ids: jax.Array, width: int,
                  n_pixels: int | None = None):
    """One jittered thin-lens ray per pixel (camera.hpp:784-794).

    keys: a core.rng.LaneRng (hot path — one counter hash yields both the
    sub-pixel jitter and the defocus-disk draw) or legacy per-pixel threefry
    keys [n, 2]. Each pixel's randomness depends only on its own lane
    identity, making ray generation shard-invariant. pixel_ids: global
    row-major pixel indices [n] (index = j * width + i). Pass the static
    frame pixel count as n_pixels so frames >= 2^24 pixels take the exact
    integer row/col path (see pixel_rowcol_f32).

    Returns (origins [n, 3], directions [n, 3]); directions are NOT
    normalized, matching the reference (hit math handles non-unit d).
    """
    if isinstance(keys, rng.LaneRng):
        offset, disk2 = rng.draw_camera(keys)
    else:
        jitter_keys, disk_keys = rng.split_each(keys, 2)
        offset = rng.square_jitter_each(jitter_keys)
        disk2 = rng.in_unit_disk_each(disk_keys)[:, :2]

    ii, jj = pixel_rowcol_f32(pixel_ids, width, n_pixels)
    px = (ii + offset[:, 0])[:, None]
    py = (jj + offset[:, 1])[:, None]
    pixel_sample = cam.pixel00 + px * cam.pixel_delta_u + py * cam.pixel_delta_v

    origin = (
        cam.center
        + disk2[:, 0:1] * cam.defocus_disk_u
        + disk2[:, 1:2] * cam.defocus_disk_v
    )
    direction = pixel_sample - origin
    return origin, direction


def generate_rays_soa(cam: Camera, keys, pixel_ids: jax.Array, width: int,
                      n_pixels: int | None = None):
    """SoA twin of generate_rays: ((ox,oy,oz), (dx,dy,dz)) component
    tuples of [n] arrays — identical math and draws, no [n, 3] arrays
    (see core/soa.py for why the hot loop avoids them)."""
    offset, disk2 = rng.draw_camera(keys)
    ii, jj = pixel_rowcol_f32(pixel_ids, width, n_pixels)
    px = ii + offset[:, 0]
    py = jj + offset[:, 1]
    du, dv, p00 = cam.pixel_delta_u, cam.pixel_delta_v, cam.pixel00
    u_, v_, c_ = cam.defocus_disk_u, cam.defocus_disk_v, cam.center
    r0, r1 = disk2[:, 0], disk2[:, 1]
    o = tuple(c_[k] + r0 * u_[k] + r1 * v_[k] for k in range(3))
    d = tuple(p00[k] + px * du[k] + py * dv[k] - o[k] for k in range(3))
    return o, d


def view_space_normal_color_soa(cam: Camera, n):
    """SoA twin of view_space_normal_color: n is (x, y, z), returns the
    same component tuple of [0,1]-mapped view-space colors."""
    from ..core import soa

    n = soa.normalize(n)
    out = []
    for basis in (cam.u, cam.v, cam.w):
        c = n[0] * basis[0] + n[1] * basis[1] + n[2] * basis[2]
        out.append((c + 1.0) * 0.5)
    return tuple(out)


def view_space_normal_color(cam: Camera, n):
    """World normal -> [0,1]-mapped view-space normal color (camera.hpp:470-481)."""
    n = vecmath.normalize(n)
    nx = vecmath.dot(n, cam.u)
    ny = vecmath.dot(n, cam.v)
    nz = vecmath.dot(n, cam.w)
    return jnp.stack([(nx + 1.0) * 0.5, (ny + 1.0) * 0.5, (nz + 1.0) * 0.5], axis=-1)
