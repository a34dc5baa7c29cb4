"""Stackless (threaded) BVH traversal over ray wavefronts.

Replacement for the reference's recursive bvh_node::hit
(/root/reference/bvh.hpp:46-119). Per-lane state is a single node index:
on an AABB hit an internal node falls through to its first child (i+1, DFS
layout); otherwise — and after leaf primitive tests — the lane jumps to the
node's escape link. The closest-hit t shrinks the slab interval exactly
like the reference's `ray_t.max` shrink (bvh.hpp:113-118).

All lanes advance in lock-step inside one `lax.while_loop`; finished lanes
(node == -1) are masked. Leaf tests gather up to `leaf_size` primitives and
evaluate sphere and triangle candidates branchlessly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import vecmath
from ..core.constants import T_MAX
from ..models.geometry import PRIM_BOX, PRIM_SPHERE
from .intersect import Hit, rows_dot


def _leaf_candidates(scene, bvh, slot_ids, o, d, tmin, tmax):
    """Candidate t for a [N, K] block of leaf slots (global leaf-table ids).

    slot_ids are clipped gathers; invalid slots must be masked by caller.
    Returns (t [N,K], ptype [N,K], prow [N,K]). Uses the BVH's leaf-ordered
    pre-gathered tables — one gather level, no row indirection.
    """
    ptype = bvh.prim_type[slot_ids]
    prow = bvh.prim_row[slot_ids]

    center = bvh.slot_center[slot_ids]  # [N,K,3]
    radius = bvh.slot_radius[slot_ids]  # [N,K] (0 for triangles -> miss)
    v0 = bvh.slot_v0[slot_ids]
    e1 = bvh.slot_e1[slot_ids]
    e2 = bvh.slot_e2[slot_ids]

    # Per-lane K-wide tests: reuse the [N,C] candidate kernels by treating
    # K as the chunk dim with per-lane tables (broadcast o/d per slot).
    oc = center - o[:, None, :]
    a = jnp.sum(d * d, axis=-1)[:, None]
    h = jnp.sum(oc * d[:, None, :], axis=-1)
    c = jnp.sum(oc * oc, axis=-1) - radius * radius
    disc = h * h - a * c
    sq = vecmath.safe_sqrt(disc)  # grad-safe at miss lanes (disc <= 0)
    inv_a = 1.0 / a
    r0 = (h - sq) * inv_a
    r1 = (h + sq) * inv_a
    ok0 = (r0 > tmin[:, None]) & (r0 < tmax[:, None])
    ok1 = (r1 > tmin[:, None]) & (r1 < tmax[:, None])
    t_sph = jnp.where((disc >= 0.0) & (ok0 | ok1) & (radius > 0.0),
                      jnp.where(ok0, r0, r1), T_MAX)

    d_b = d[:, None, :]
    pvec = jnp.cross(d_b, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    nz = jnp.abs(det) < 1e-12
    inv_det = 1.0 / jnp.where(nz, 1.0, det)
    tvec = o[:, None, :] - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d_b * qvec, axis=-1) * inv_det
    t_tri_raw = jnp.sum(e2 * qvec, axis=-1) * inv_det
    tri_ok = (~nz & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
              & (t_tri_raw > tmin[:, None]) & (t_tri_raw < tmax[:, None]))
    t_tri = jnp.where(tri_ok, t_tri_raw, T_MAX)

    # Affine-slab box (cube.hpp:44-86; see intersect.box_candidate_t).
    m = bvh.slot_minv[slot_ids].reshape(*slot_ids.shape, 3, 3)  # [N,K,3,3]
    trans = bvh.slot_trans[slot_ids]                            # [N,K,3]
    o_l = rows_dot(m, o[:, None, None, :]) + trans
    d_l = rows_dot(m, d[:, None, None, :])
    inv = 1.0 / jnp.where(jnp.abs(d_l) < 1e-30, 1e-30, d_l)
    b0 = (-1.0 - o_l) * inv
    b1 = (1.0 - o_l) * inv
    bt_near = jnp.max(jnp.minimum(b0, b1), axis=-1)
    bt_far = jnp.min(jnp.maximum(b0, b1), axis=-1)
    t_box_raw = jnp.where(bt_near > tmin[:, None], bt_near, bt_far)
    box_ok = ((bt_near < bt_far) & (t_box_raw > tmin[:, None])
              & (t_box_raw < tmax[:, None]))
    t_box = jnp.where(box_ok, t_box_raw, T_MAX)

    t = jnp.where(ptype == PRIM_SPHERE, t_sph,
                  jnp.where(ptype == PRIM_BOX, t_box, t_tri))
    return t, ptype, prow


def intersect_bvh(scene, o, d, tmin) -> Hit:
    """Closest hit via threaded-BVH traversal. o, d f32[N,3]."""
    bvh = scene.bvh
    n = o.shape[0]
    tmin = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (n,))
    leaf_k = bvh.leaf_size  # static gather width

    inv_d = 1.0 / jnp.where(jnp.abs(d) < 1e-20, jnp.where(d < 0, -1e-20, 1e-20), d)

    def cond(state):
        node, _, _, _ = state
        return jnp.any(node >= 0)

    def body(state):
        node, best_t, best_type, best_row = state
        live = node >= 0
        ni = jnp.maximum(node, 0)

        # Slab test (aabb.hpp:44-66) against the shrunken [tmin, best_t].
        nmin = bvh.node_min[ni]
        nmax = bvh.node_max[ni]
        t0 = (nmin - o) * inv_d
        t1 = (nmax - o) * inv_d
        t_near = jnp.max(jnp.minimum(t0, t1), axis=-1)
        t_far = jnp.min(jnp.maximum(t0, t1), axis=-1)
        t_near = jnp.maximum(t_near, tmin)
        t_far = jnp.minimum(t_far, best_t)
        box_hit = live & (t_near <= t_far)

        count = bvh.count[ni]
        is_leaf = count > 0
        test_leaf = box_hit & is_leaf

        # Leaf primitive tests (masked; slots beyond count invalidated).
        first = bvh.first[ni]
        slot = first[:, None] + jnp.arange(leaf_k, dtype=jnp.int32)[None, :]
        slot_valid = (jnp.arange(leaf_k, dtype=jnp.int32)[None, :] < count[:, None])
        slot_c = jnp.clip(slot, 0, bvh.prim_type.shape[0] - 1)
        t_cand, ptype, prow = _leaf_candidates(scene, bvh, slot_c, o, d, tmin, best_t)
        t_cand = jnp.where(slot_valid & test_leaf[:, None], t_cand, T_MAX)
        k_best = jnp.argmin(t_cand, axis=-1)
        lane = jnp.arange(n)
        cand_t = t_cand[lane, k_best]
        better = cand_t < best_t
        best_t = jnp.where(better, cand_t, best_t)
        best_type = jnp.where(better, ptype[lane, k_best], best_type)
        best_row = jnp.where(better, prow[lane, k_best], best_row)

        # Next node: descend on internal hit, else take the escape link.
        descend = box_hit & ~is_leaf
        nxt = jnp.where(descend, ni + 1, bvh.escape[ni])
        node = jnp.where(live, nxt, node)
        return node, best_t, best_type, best_row

    node0 = jnp.zeros((n,), jnp.int32)
    init = (
        node0,
        jnp.full((n,), T_MAX, jnp.float32),
        jnp.zeros((n,), jnp.int32),
        jnp.zeros((n,), jnp.int32),
    )
    _, best_t, best_type, best_row = jax.lax.while_loop(cond, body, init)
    return Hit(
        t=best_t,
        prim_type=best_type,
        prim_idx=best_row,
        hit=best_t < T_MAX,
    )
