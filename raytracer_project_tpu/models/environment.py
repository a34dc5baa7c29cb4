"""Environment lighting: solid color / HDRI equirect / procedural sun-sky.

JAX-native re-expression of the reference's EnvironmentSettings
(/root/reference/environment.hpp:8-77) and the environment shader inside the
camera (/root/reference/camera.hpp:828-925), plus the astronomical daylight
model from the UI layer (/root/reference/main.cpp:822-893).

The mode is a *static* field of the render config so XLA compiles only the
active shader; all continuous knobs (rotation, sun direction, intensity,
colors — and the HDR texels themselves) are differentiable pytree leaves.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import soa, vecmath
from ..core.constants import PI

# Environment modes (environment.hpp:9-13).
PHYSICAL_SUN = 0
HDR_MAP = 1
SOLID_COLOR = 2

# Default HDRI directory (environment.hpp:6); relative to the asset root
# (RAYTRACER_TPU_ASSETS env var, falling back to ./assets).
HDR_DIR = "hdr_maps"


def refresh_hdr_list(directory: str | None = None) -> list[str]:
    """Scan for environment maps; returns sorted absolute paths.

    Counterpart of camera::refresh_hdr_list's directory scan with live
    refresh (/root/reference/camera.hpp:123-140, main.cpp:713-716): call
    again anytime to pick up files added since. Looks in `directory`, or
    $RAYTRACER_TPU_ASSETS/hdr_maps, or ./assets/hdr_maps.
    """
    import os

    if directory is None:
        root = os.environ.get("RAYTRACER_TPU_ASSETS", "assets")
        directory = os.path.join(root, HDR_DIR)
    if not os.path.isdir(directory):
        return []
    out = [
        os.path.abspath(os.path.join(directory, f))
        for f in os.listdir(directory)
        if f.lower().endswith((".hdr", ".exr", ".png", ".jpg", ".jpeg"))
    ]
    return sorted(out)


def load_hdr_by_name(name: str, directory: str | None = None) -> np.ndarray:
    """Resolve a map by (base)name against refresh_hdr_list and load it;
    returns the black 1x1 fallback if absent (environment.hpp:64-68)."""
    from ..utils import image_io

    for path in refresh_hdr_list(directory):
        base = path.rsplit("/", 1)[-1]
        if name in (path, base, base.rsplit(".", 1)[0]):
            img = (image_io.load_hdr(path) if path.lower().endswith(".hdr")
                   else image_io.load_image(path))
            if img is not None:
                return np.asarray(img, np.float32)
    return np.zeros((1, 1, 3), np.float32)


class Environment(NamedTuple):
    """Dynamic environment parameters (a pytree).

    hdr_image is an equirect [H, W, 3] linear-radiance map (a 1x1 black
    placeholder when unused — matching the fallback-to-black of
    environment.hpp:64-68).
    """

    background_color: jax.Array  # [3] solid mode color
    intensity: jax.Array         # [] global multiplier (environment.hpp:33)
    hdr_image: jax.Array         # [H, W, 3]
    hdri_rotation: jax.Array     # [] yaw, radians (environment.hpp:39)
    hdri_tilt: jax.Array         # [] pitch, radians
    hdri_roll: jax.Array         # [] roll, radians
    sun_direction: jax.Array     # [3]
    sun_color: jax.Array         # [3]
    sun_intensity: jax.Array     # []
    sun_size: jax.Array          # [] UI-scale 0.1..10 (camera.hpp:914)


def make_environment(
    *,
    background_color=(0.5, 0.7, 1.0),
    intensity=1.0,
    hdr_image=None,
    hdri_rotation=0.0,
    hdri_tilt=0.0,
    hdri_roll=0.0,
    sun_direction=(0.5, 0.8, 0.3),
    sun_color=(1.0, 0.95, 0.9),
    sun_intensity=5.0,
    sun_size=1.0,
) -> Environment:
    if hdr_image is None:
        hdr_image = np.zeros((1, 1, 3), np.float32)  # black fallback
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    return Environment(
        background_color=f32(background_color),
        intensity=f32(intensity),
        hdr_image=f32(hdr_image),
        hdri_rotation=f32(hdri_rotation),
        hdri_tilt=f32(hdri_tilt),
        hdri_roll=f32(hdri_roll),
        sun_direction=f32(sun_direction),
        sun_color=f32(sun_color),
        sun_intensity=f32(sun_intensity),
        sun_size=f32(sun_size),
    )


# ---------------------------------------------------------------------------
# Shaders — each maps unit directions [N, 3] -> radiance [N, 3]
# ---------------------------------------------------------------------------

def shade_solid(env: Environment, unit_dir):
    """SOLID_COLOR mode (camera.hpp:832-834)."""
    n = unit_dir.shape[:-1]
    return jnp.broadcast_to(env.background_color * env.intensity, n + (3,))


def shade_hdr(env: Environment, unit_dir):
    """HDR_MAP mode: yaw/pitch/roll rotation + equirect nearest lookup
    (camera.hpp:837-870)."""
    d = unit_dir
    x, y, z = d[..., 0], d[..., 1], d[..., 2]

    cy, sy = jnp.cos(env.hdri_rotation), jnp.sin(env.hdri_rotation)
    x, z = cy * x + sy * z, -sy * x + cy * z

    cp, sp = jnp.cos(env.hdri_tilt), jnp.sin(env.hdri_tilt)
    y, z = cp * y - sp * z, sp * y + cp * z

    cr, sr = jnp.cos(env.hdri_roll), jnp.sin(env.hdri_roll)
    x, y = cr * x - sr * y, sr * x + cr * y

    phi = jnp.arctan2(z, x) + PI
    theta = vecmath.safe_arccos(y)  # grad-safe w.r.t. rotation at the poles
    u = phi / (2.0 * PI)
    v = theta / PI

    h, w = env.hdr_image.shape[0], env.hdr_image.shape[1]
    # Nearest-neighbor, u-wrap + clamp (texture.hpp:56-66 semantics).
    uu = u - jnp.floor(u)
    i = jnp.clip((uu * w).astype(jnp.int32), 0, w - 1)
    j = jnp.clip((v * h).astype(jnp.int32), 0, h - 1)
    return env.hdr_image[j, i] * env.intensity


def shade_sun_sky(env: Environment, unit_dir):
    """PHYSICAL_SUN mode: day/night curves, zenith/horizon gradient, sunset
    lerp, anti-aliased sun disc (camera.hpp:871-925)."""
    sun_dir = vecmath.normalize(env.sun_direction)
    sun_height = sun_dir[1]
    adjusted = sun_height - 0.05

    sky_exposure = jnp.clip(adjusted * 8.0 + 1.4, 0.0, 1.0)
    day_factor = jnp.clip(adjusted * 10.0 + 1.1, 0.0, 1.0)

    sunset_intensity = jnp.clip(1.0 - jnp.abs(adjusted + 0.05) * 30.0, 0.0, 1.0)
    sunset = jnp.where(adjusted > -0.1, sunset_intensity, 0.0)
    sunset = jnp.where(sun_height < 0.0, sunset * (sun_height * 10.0 + 1.0), sunset)
    sunset = jnp.clip(sunset, 0.0, 1.0)

    zenith = (jnp.asarray([0.01, 0.03, 0.1]) * (1.0 - day_factor)
              + jnp.asarray([0.2, 0.5, 1.0]) * day_factor)
    horizon = (jnp.asarray([0.05, 0.02, 0.01]) * (1.0 - day_factor)
               + jnp.asarray([0.6, 0.8, 1.0]) * day_factor)
    horizon = horizon * (1.0 - sunset) + jnp.asarray([1.0, 0.35, 0.1]) * sunset

    a = unit_dir[..., 1:2]
    sky = jnp.where(a > 0.0, (1.0 - a) * horizon + a * zenith, horizon * 0.1)
    final = sky * (env.intensity * 1.5) * sky_exposure

    sun_focus = vecmath.dot(unit_dir, sun_dir)
    threshold = 1.0 - env.sun_size * 0.001
    s_color = env.sun_color * (1.0 - sunset) + jnp.asarray([1.0, 0.3, 0.1]) * sunset
    visibility = jnp.clip(sun_height * 5.0 + 1.0, 0.0, 1.0)
    alpha = vecmath.smoothstep(threshold, threshold + 0.0002, sun_focus)
    disc_on = (sun_focus > threshold) & (adjusted > -0.1)
    final = final + jnp.where(
        disc_on[..., None],
        s_color * env.sun_intensity * visibility * alpha[..., None],
        0.0,
    )
    return final


_SHADERS = {PHYSICAL_SUN: shade_sun_sky, HDR_MAP: shade_hdr, SOLID_COLOR: shade_solid}


# ---------------------------------------------------------------------------
# SoA twins (component-tuple in/out; see core/soa.py). Same math as the
# [N, 3] shaders above; used by the pooled-wavefront hot loop.
# ---------------------------------------------------------------------------

def _shade_solid_soa(env: Environment, d):
    c = env.background_color * env.intensity
    one = jnp.ones_like(d[0])
    return c[0] * one, c[1] * one, c[2] * one


def _shade_hdr_soa(env: Environment, d):
    x, y, z = soa.normalize(d)
    cy, sy = jnp.cos(env.hdri_rotation), jnp.sin(env.hdri_rotation)
    x, z = cy * x + sy * z, -sy * x + cy * z
    cp, sp = jnp.cos(env.hdri_tilt), jnp.sin(env.hdri_tilt)
    y, z = cp * y - sp * z, sp * y + cp * z
    cr, sr = jnp.cos(env.hdri_roll), jnp.sin(env.hdri_roll)
    x, y = cr * x - sr * y, sr * x + cr * y
    phi = jnp.arctan2(z, x) + PI
    theta = vecmath.safe_arccos(y)
    h, w = env.hdr_image.shape[0], env.hdr_image.shape[1]
    uu = phi / (2.0 * PI)
    uu = uu - jnp.floor(uu)
    i = jnp.clip((uu * w).astype(jnp.int32), 0, w - 1)
    j = jnp.clip((theta / PI * h).astype(jnp.int32), 0, h - 1)
    texel = env.hdr_image[j, i] * env.intensity
    return texel[..., 0], texel[..., 1], texel[..., 2]


def _shade_sun_sky_soa(env: Environment, d):
    """SoA twin of shade_sun_sky (camera.hpp:871-925)."""
    ux, uy, uz = soa.normalize(d)
    sd = vecmath.normalize(env.sun_direction)
    sun_height = sd[1]
    adjusted = sun_height - 0.05

    sky_exposure = jnp.clip(adjusted * 8.0 + 1.4, 0.0, 1.0)
    day_factor = jnp.clip(adjusted * 10.0 + 1.1, 0.0, 1.0)

    sunset_intensity = jnp.clip(1.0 - jnp.abs(adjusted + 0.05) * 30.0, 0.0, 1.0)
    sunset = jnp.where(adjusted > -0.1, sunset_intensity, 0.0)
    sunset = jnp.where(sun_height < 0.0, sunset * (sun_height * 10.0 + 1.0), sunset)
    sunset = jnp.clip(sunset, 0.0, 1.0)

    # All of the above is scalar (env-only); per-lane work starts here.
    zen = [0.01, 0.03, 0.1]
    zday = [0.2, 0.5, 1.0]
    hor = [0.05, 0.02, 0.01]
    hday = [0.6, 0.8, 1.0]
    hsun = [1.0, 0.35, 0.1]
    scol_sunset = [1.0, 0.3, 0.1]
    visibility = jnp.clip(sun_height * 5.0 + 1.0, 0.0, 1.0)
    threshold = 1.0 - env.sun_size * 0.001
    sun_focus = ux * sd[0] + uy * sd[1] + uz * sd[2]
    alpha = vecmath.smoothstep(threshold, threshold + 0.0002, sun_focus)
    disc_on = (sun_focus > threshold) & (adjusted > -0.1)
    up = uy > 0.0
    gain = env.intensity * 1.5 * sky_exposure
    out = []
    for k in range(3):
        zenith = zen[k] * (1.0 - day_factor) + zday[k] * day_factor
        horizon = hor[k] * (1.0 - day_factor) + hday[k] * day_factor
        horizon = horizon * (1.0 - sunset) + hsun[k] * sunset
        sky = jnp.where(up, (1.0 - uy) * horizon + uy * zenith, horizon * 0.1)
        s_col = env.sun_color[k] * (1.0 - sunset) + scol_sunset[k] * sunset
        disc = jnp.where(disc_on,
                         s_col * env.sun_intensity * visibility * alpha, 0.0)
        out.append(sky * gain + disc)
    return tuple(out)


_SHADERS_SOA = {PHYSICAL_SUN: _shade_sun_sky_soa, HDR_MAP: _shade_hdr_soa,
                SOLID_COLOR: _shade_solid_soa}


def background_color_soa(env: Environment, direction, mode: int):
    """SoA twin of background_color: direction and result are (x, y, z)
    component tuples of [N] arrays."""
    return _SHADERS_SOA[mode](env, direction)


def background_color(env: Environment, direction, mode: int):
    """Radiance for rays that escape the scene (camera.hpp:828-925).

    `mode` is static; `direction` need not be normalized.
    """
    return _SHADERS[mode](env, vecmath.normalize(direction))


# ---------------------------------------------------------------------------
# Astronomical daylight (main.cpp:822-893)
# ---------------------------------------------------------------------------

def solar_position(latitude_deg, day_of_year, hour):
    """Solar (elevation, azimuth) in degrees from date/time/latitude
    (main.cpp:830-851)."""
    lat = jnp.deg2rad(jnp.asarray(latitude_deg, jnp.float32))
    decl = jnp.deg2rad(
        23.45 * jnp.sin(jnp.deg2rad(360.0 / 365.0 * (jnp.asarray(day_of_year, jnp.float32) - 81.0)))
    )
    hour_angle = jnp.deg2rad(15.0 * (jnp.asarray(hour, jnp.float32) - 12.0))
    sin_elev = (jnp.sin(lat) * jnp.sin(decl)
                + jnp.cos(lat) * jnp.cos(decl) * jnp.cos(hour_angle))
    elev = jnp.arcsin(jnp.clip(sin_elev, -1.0, 1.0))
    cos_az = (jnp.sin(decl) - jnp.sin(elev) * jnp.sin(lat)) / jnp.maximum(
        jnp.cos(elev) * jnp.cos(lat), 1e-6
    )
    az = jnp.arccos(jnp.clip(cos_az, -1.0, 1.0))
    az = jnp.where(hour_angle > 0.0, 2.0 * PI - az, az)
    return jnp.rad2deg(elev), jnp.rad2deg(az)


def sun_direction_from_time(latitude_deg, day_of_year, hour):
    """Sun direction via the astronomical model (main.cpp:853)."""
    elev, az = solar_position(latitude_deg, day_of_year, hour)
    return vecmath.direction_from_spherical(elev, az)


def auto_sun_color(elevation_deg):
    """Altitude-keyed warm shift (Rayleigh-ish; main.cpp:855-871)."""
    e = jnp.asarray(elevation_deg, jnp.float32)
    t = jnp.clip(e / 60.0, 0.0, 1.0)
    low = jnp.asarray([1.0, 0.45, 0.15])   # near horizon: warm
    high = jnp.asarray([1.0, 0.95, 0.9])   # high sun: near white
    color = low * (1.0 - t[..., None]) + high * t[..., None]
    return jnp.where(e[..., None] < 0.0, jnp.asarray([0.8, 0.35, 0.25]), color)
