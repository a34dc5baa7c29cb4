"""BVH wireframe debug visualization.

JAX-native re-expression of the reference's in-traversal debug rendering
(/root/reference/bvh.hpp:46-110, aabb.hpp:68-84, camera.hpp:937-953):
nodes at the selected tree level render neon box edges (depth-keyed color
`(0.4, min(depth*0.15, 1), 1-g) * 4`), geometry under a selected node gets
a dim volume tint `* 0.1`, other geometry renders dark (0.01), misses are
black. `level = -1` isolates leaves (bvh.hpp:67-69); thickness scales with
hit distance for perspective (bvh.hpp:66).

Divergence note: the reference returns the *first edge found in DFS
order*; this build returns the *nearest* edge along the ray — visually
cleaner and order-independent, same information.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.constants import T_MAX, T_MIN
from ..models import camera as camera_mod
from . import intersect


def _edge_color(level):
    """Depth-keyed neon (bvh.hpp:79-83)."""
    g = jnp.minimum(level.astype(jnp.float32) * 0.15, 1.0)
    return jnp.stack([jnp.full_like(g, 0.4), g, 1.0 - g], axis=-1)


def bvh_edge_scan(scene, o, d, *, level: int = -1,
                  thickness: float = 0.01):
    """Nearest selected-node box-edge crossing per ray.

    Returns (edge_t [N] — T_MAX where none, edge_lvl [N] i32,
    any_sel [N] bool — ray passed through some selected node's box).
    The traversal core shared by the standalone wireframe view and the
    composited-into-beauty overlay."""
    bvh = scene.bvh
    n = o.shape[0]
    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-20,
                            jnp.where(d < 0, -1e-20, 1e-20), d)

    def cond(state):
        node, *_ = state
        return jnp.any(node >= 0)

    def body(state):
        node, edge_t, edge_lvl, any_sel = state
        live = node >= 0
        ni = jnp.maximum(node, 0)

        nmin = bvh.node_min[ni]
        nmax = bvh.node_max[ni]
        t0 = (nmin - o) * inv_d
        t1 = (nmax - o) * inv_d
        t_near = jnp.maximum(jnp.max(jnp.minimum(t0, t1), axis=-1), T_MIN)
        t_far = jnp.min(jnp.maximum(t0, t1), axis=-1)
        box_hit = live & (t_near <= t_far)

        is_leaf = bvh.count[ni] > 0
        if level == -1:
            selected = is_leaf  # bvh.hpp:67-69 leaf isolation
        else:
            selected = bvh.node_level[ni] == level

        # Perspective-scaled thickness (bvh.hpp:66).
        thick = thickness * (0.05 + t_near * 0.1)

        def on_edge(p):
            # >= 2 near-planes => edge/corner (aabb.hpp:68-84).
            near_lo = jnp.abs(p - nmin) < thick[:, None]
            near_hi = jnp.abs(p - nmax) < thick[:, None]
            return jnp.sum((near_lo | near_hi).astype(jnp.int32), axis=-1) >= 2

        p_entry = o + (t_near + 1e-4)[:, None] * d
        p_exit = o + (t_far - 1e-4)[:, None] * d
        entry_edge = on_edge(p_entry)
        exit_edge = on_edge(p_exit)
        is_edge = box_hit & selected & (entry_edge | exit_edge)
        t_hit = jnp.where(entry_edge, t_near, t_far)

        better = is_edge & (t_hit < edge_t)
        edge_t = jnp.where(better, t_hit, edge_t)
        edge_lvl = jnp.where(better, bvh.node_level[ni], edge_lvl)
        any_sel = any_sel | (box_hit & selected)

        # Visit everything: descend internal hits, escape otherwise.
        nxt = jnp.where(box_hit & ~is_leaf, ni + 1, bvh.escape[ni])
        node = jnp.where(live, nxt, node)
        return node, edge_t, edge_lvl, any_sel

    init = (
        jnp.zeros((n,), jnp.int32),
        jnp.full((n,), T_MAX, jnp.float32),
        jnp.zeros((n,), jnp.int32),
        jnp.zeros((n,), bool),
    )
    _, edge_t, edge_lvl, any_sel = jax.lax.while_loop(cond, body, init)
    return edge_t, edge_lvl, any_sel


def bvh_debug_trace(scene, o, d, *, level: int = -1,
                    thickness: float = 0.01):
    """Wireframe radiance for each ray [N, 3]."""
    edge_t, edge_lvl, any_sel = bvh_edge_scan(scene, o, d, level=level,
                                              thickness=thickness)
    edge_hit = edge_t < T_MAX

    # Geometry beneath: dark or volume-tinted (bvh.hpp:98-102,
    # camera.hpp:947-953).
    geo = intersect.intersect(scene, o, d, T_MIN)
    geo_color = jnp.where(
        (geo.hit & any_sel)[:, None],
        _edge_color(edge_lvl) * 0.1,
        jnp.where(geo.hit[:, None], 0.01, 0.0),
    )

    return jnp.where(
        edge_hit[:, None], _edge_color(edge_lvl) * 4.0, geo_color
    )


def composite_wireframe(scene, cam: camera_mod.Camera, beauty, *,
                        level: int = -1, thickness: float = 0.01):
    """Blend the BVH wireframe INTO a rendered beauty buffer.

    The reference renders node edges as fabricated diffuse_light hits
    inside the traversal, so wires and geometry occlude each other by t
    and the wireframe appears over the LIVE render (bvh.hpp:56-109,
    blended at camera.hpp:937-953). This is that composite at primary
    visibility: pixels whose center ray crosses a selected node's box
    edge BEFORE its first surface hit take the emissive edge color (a
    diffuse_light hit terminates the path, so the pixel equals the wire
    emission exactly); everything else keeps the path-traced beauty.
    Divergence (documented): secondary bounces don't see the wire — a
    mirror won't reflect the debug lines.

    beauty: [H, W, 3] linear radiance (accumulator average, pre-post).
    Returns the composited [H, W, 3] linear buffer.
    """
    h, w = beauty.shape[0], beauty.shape[1]
    # Pixel-center rays (the reference's get_center_ray, camera.hpp:806):
    # deterministic, no jitter — debug overlay stability.
    ii = jnp.tile(jnp.arange(w, dtype=jnp.float32), h)
    jj = jnp.repeat(jnp.arange(h, dtype=jnp.float32), w)
    d = (cam.pixel00[None, :] + ii[:, None] * cam.pixel_delta_u[None, :]
         + jj[:, None] * cam.pixel_delta_v[None, :] - cam.center[None, :])
    o = jnp.broadcast_to(cam.center, d.shape)

    edge_t, edge_lvl, _ = bvh_edge_scan(scene, o, d, level=level,
                                        thickness=thickness)
    geo = intersect.intersect(scene, o, d, T_MIN)
    surf_t = jnp.where(geo.hit, geo.t, T_MAX)
    wire = (edge_t < T_MAX) & (edge_t < surf_t)
    out = jnp.where(wire[:, None], _edge_color(edge_lvl) * 4.0,
                    beauty.reshape(-1, 3))
    return out.reshape(h, w, 3)


def render_bvh_debug(scene, cam: camera_mod.Camera, key, config, *,
                     level: int = -1, thickness: float = 0.01):
    """Full-frame wireframe render [H, W, 3] (one sample; deterministic
    enough for a debug view)."""
    from ..core import rng

    pixel_ids = jnp.arange(config.n_pixels, dtype=jnp.int32)
    pkeys = rng.per_lane_keys(key, pixel_ids)
    o, d = camera_mod.generate_rays(cam, pkeys, pixel_ids, config.width,
                                    config.n_pixels)
    img = bvh_debug_trace(scene, o, d, level=level, thickness=thickness)
    return img.reshape(config.height, config.width, 3)
