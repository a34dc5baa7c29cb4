"""BVH construction: host-side builder -> flat, threaded (stackless) arrays.

JAX-native replacement for the reference's shared_ptr binary BVH
(/root/reference/bvh.hpp:9-149). The reference builds by sorting on a
*random* axis and median-splitting (bvh.hpp:15-42 — its README claims
"longest axis", the code says otherwise); this build uses binned SAH on the
largest-extent axis (strictly better traversal quality) with a
`median_random_axis` mode retained for A/B comparison against the
reference's exact tree shape.

The tree is emitted depth-first with *escape links* (threaded BVH): a ray
either descends into node i+1 on an AABB hit or jumps to `escape[i]`.
Device-side traversal state is then a single node index per lane — no
per-ray stack — which is what makes the traversal a tight masked
`while_loop` (see traverse.py).

Leaf primitives are reordered into a contiguous table so a leaf is one
gather of at most `leaf_size` rows.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..models.geometry import PRIM_BOX, PRIM_SPHERE, PRIM_TRIANGLE

# AABB padding (aabb-expand delta used throughout the reference,
# e.g. triangle.hpp:95, cube.hpp:35).
PAD = 1e-4

# Large leaves on purpose: lock-step wavefront traversal pays per *node
# step* (sequential while-loop iterations), while leaf primitive tests are
# wide vectorized ops. On the showcase scene leaf 16 cuts max node steps
# ~35% vs leaf 4 (a count of loop iterations, not a time).
DEFAULT_LEAF_SIZE = 16
SAH_BINS = 16


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FlatBVH:
    """Threaded flat BVH (a pytree). NN nodes in DFS order.

    node_min/max f32[NN,3]  AABB slabs
    escape       i32[NN]    node to jump to when this subtree is done/missed
                            (-1 terminates traversal)
    first        i32[NN]    leaf: offset into prim tables below; internal: -1
    count        i32[NN]    leaf: primitive count; internal: 0
    prim_type    i32[P]     PRIM_SPHERE / PRIM_TRIANGLE, leaf-contiguous order
    prim_row     i32[P]     row in the per-type table
    node_level   i32[NN]    depth of each node (root = 0; debug wireframe viz)

    Leaf-ordered pre-gathered primitive data (single-level gathers in the
    traversal inner loop — avoids the slot->row->table double indirection):
    slot_center  f32[P,3]  sphere center (zeros for others)
    slot_radius  f32[P]    sphere radius (0 for others -> guaranteed miss)
    slot_v0/e1/e2 f32[P,3] triangle data (zeros for others -> det 0 miss)
    slot_minv    f32[P,9]  box world->local rows (zeros for others)
    slot_trans   f32[P,3]  box translation (1e6 for others -> miss)

    n_levels     int        static tree depth
    leaf_size    int        static max primitives per leaf (gather width)
    """

    node_min: jax.Array
    node_max: jax.Array
    escape: jax.Array
    first: jax.Array
    count: jax.Array
    prim_type: jax.Array
    prim_row: jax.Array
    node_level: jax.Array
    slot_center: jax.Array
    slot_radius: jax.Array
    slot_v0: jax.Array
    slot_e1: jax.Array
    slot_e2: jax.Array
    slot_minv: jax.Array
    slot_trans: jax.Array
    # Static (non-pytree) metadata: keeps flax out of the core deps —
    # jax.tree_util.register_dataclass honors the "static" field metadata.
    n_levels: int = dataclasses.field(metadata=dict(static=True))
    leaf_size: int = dataclasses.field(metadata=dict(static=True))

    @property
    def node_count(self) -> int:
        return self.escape.shape[0]


def primitive_bounds(scene) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-primitive AABBs + (type, row) ids for the whole scene."""
    mins, maxs, types, rows = [], [], [], []

    sph = scene.spheres
    centers = np.asarray(sph.center)
    radii = np.asarray(sph.radius)
    valid = radii > 0.0
    if valid.any():
        c, r = centers[valid], radii[valid][:, None]
        mins.append(c - r)
        maxs.append(c + r)
        types.append(np.full(len(c), PRIM_SPHERE, np.int32))
        rows.append(np.nonzero(valid)[0].astype(np.int32))

    tri = scene.triangles
    v0 = np.asarray(tri.v0)
    e1 = np.asarray(tri.e1)
    e2 = np.asarray(tri.e2)
    degenerate = (np.linalg.norm(np.cross(e1, e2), axis=-1) < 1e-12)
    if (~degenerate).any():
        keep = ~degenerate
        p0, p1, p2 = v0[keep], v0[keep] + e1[keep], v0[keep] + e2[keep]
        mins.append(np.minimum(np.minimum(p0, p1), p2) - PAD)
        maxs.append(np.maximum(np.maximum(p0, p1), p2) + PAD)
        types.append(np.full(keep.sum(), PRIM_TRIANGLE, np.int32))
        rows.append(np.nonzero(keep)[0].astype(np.int32))

    if getattr(scene, "boxes", None) is not None:
        box = scene.boxes
        bmin = np.asarray(box.aabb_min)
        bmax = np.asarray(box.aabb_max)
        bvalid = (bmin <= bmax).all(axis=-1)  # dummy rows are inverted-inf
        if bvalid.any():
            mins.append(bmin[bvalid] - PAD)
            maxs.append(bmax[bvalid] + PAD)
            types.append(np.full(bvalid.sum(), PRIM_BOX, np.int32))
            rows.append(np.nonzero(bvalid)[0].astype(np.int32))

    if not mins:
        # Degenerate empty scene: single never-hit leaf.
        return (np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32),
                np.asarray([PRIM_SPHERE], np.int32), np.asarray([0], np.int32))
    return (np.concatenate(mins).astype(np.float32),
            np.concatenate(maxs).astype(np.float32),
            np.concatenate(types), np.concatenate(rows))


class _Node:
    __slots__ = ("mn", "mx", "left", "right", "prims")

    def __init__(self, mn, mx, prims=None):
        self.mn, self.mx = mn, mx
        self.left = self.right = None
        self.prims = prims  # None for internal nodes


def _build_tree(pmin, pmax, ids, leaf_size, mode, rng) -> _Node:
    centroids = (pmin + pmax) * 0.5

    def build(idxs) -> _Node:
        mn = pmin[idxs].min(axis=0)
        mx = pmax[idxs].max(axis=0)
        n = len(idxs)
        if n <= leaf_size:
            return _Node(mn, mx, prims=idxs)

        if mode == "median_random_axis":
            # Reference behavior (bvh.hpp:15-24): random axis, median split.
            axis = int(rng.integers(0, 3))
            order = np.argsort(centroids[idxs, axis], kind="stable")
            half = n // 2
            left_idx, right_idx = idxs[order[:half]], idxs[order[half:]]
        else:
            left_idx, right_idx = _sah_split(
                pmin[idxs], pmax[idxs], centroids[idxs], idxs, leaf_size
            )
            if left_idx is None:  # SAH says "don't split" but n > leaf
                axis = int(np.argmax(mx - mn))
                order = np.argsort(centroids[idxs, axis], kind="stable")
                half = n // 2
                left_idx, right_idx = idxs[order[:half]], idxs[order[half:]]

        node = _Node(mn, mx)
        node.left = build(left_idx)
        node.right = build(right_idx)
        return node

    return build(ids)


def _sah_split(bmin, bmax, cent, idxs, leaf_size):
    """Binned surface-area-heuristic split; returns (left_ids, right_ids) or
    (None, None) when no split beats the leaf cost."""
    n = len(idxs)
    ext = cent.max(axis=0) - cent.min(axis=0)
    axis = int(np.argmax(ext))
    if ext[axis] < 1e-12:
        return None, None

    lo = cent[:, axis].min()
    scale = SAH_BINS * (1.0 - 1e-6) / max(ext[axis], 1e-12)
    bin_of = np.minimum(((cent[:, axis] - lo) * scale).astype(np.int32), SAH_BINS - 1)

    bin_counts = np.bincount(bin_of, minlength=SAH_BINS)
    bin_min = np.full((SAH_BINS, 3), np.inf)
    bin_max = np.full((SAH_BINS, 3), -np.inf)
    for b in range(SAH_BINS):
        sel = bin_of == b
        if sel.any():
            bin_min[b] = bmin[sel].min(axis=0)
            bin_max[b] = bmax[sel].max(axis=0)

    def areas(mns, mxs):
        d = np.maximum(mxs - mns, 0.0)
        return 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0])

    lmin = np.minimum.accumulate(bin_min, axis=0)
    lmax = np.maximum.accumulate(bin_max, axis=0)
    rmin = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
    rmax = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]
    lcount = np.cumsum(bin_counts)
    rcount = n - lcount

    # Cost of splitting after bin b (b in 0..BINS-2).
    la = areas(lmin[:-1], lmax[:-1])
    ra = areas(rmin[1:], rmax[1:])
    valid = (lcount[:-1] > 0) & (rcount[:-1] > 0)
    cost = np.where(valid, la * lcount[:-1] + ra * rcount[:-1], np.inf)
    best = int(np.argmin(cost))
    if not np.isfinite(cost[best]):
        return None, None

    whole = areas(bmin.min(axis=0)[None], bmax.max(axis=0)[None])[0]
    if cost[best] >= whole * n and n <= 2 * leaf_size:
        return None, None  # leaf is cheaper

    go_left = bin_of <= best
    return idxs[go_left], idxs[~go_left]


def _subtree_sizes(root: _Node) -> dict[int, int]:
    """Iterative post-order node-count per subtree (keyed by id(node))."""
    sizes: dict[int, int] = {}
    stack = [(root, False)]
    while stack:
        node, expanded = stack.pop()
        if node.prims is not None:
            sizes[id(node)] = 1
        elif expanded:
            sizes[id(node)] = 1 + sizes[id(node.left)] + sizes[id(node.right)]
        else:
            stack.append((node, True))
            stack.append((node.left, False))
            stack.append((node.right, False))
    return sizes


def _flatten(root: _Node):
    """DFS emit + escape links (iterative; no recursion limit concerns).

    A node's left child sits at i+1; it escapes into the right child, which
    sits at i + 1 + size(left subtree); the right child escapes wherever the
    parent does.
    """
    nodes, leaf_prims = [], []
    sizes = _subtree_sizes(root)
    stack = [(root, -1, 0)]
    while stack:
        node, escape, level = stack.pop()
        rec = {"mn": node.mn, "mx": node.mx, "escape": escape,
               "first": -1, "count": 0, "level": level}
        i = len(nodes)
        nodes.append(rec)
        if node.prims is not None:
            rec["first"] = len(leaf_prims)
            rec["count"] = len(node.prims)
            leaf_prims.extend(node.prims.tolist())
        else:
            right_i = i + 1 + sizes[id(node.left)]
            # Push right first so left is emitted next (DFS order).
            stack.append((node.right, escape, level + 1))
            stack.append((node.left, right_i, level + 1))
    return nodes, np.asarray(leaf_prims, np.int64)


def _depth(root: _Node) -> int:
    stack = [(root, 1)]
    best = 1
    while stack:
        n, d = stack.pop()
        best = max(best, d)
        if n.left is not None:
            stack.append((n.left, d + 1))
            stack.append((n.right, d + 1))
    return best


def build_bvh(scene, leaf_size: int = DEFAULT_LEAF_SIZE, mode: str = "sah",
              seed: int = 0, as_numpy: bool = False,
              use_native: bool | None = None) -> FlatBVH:
    """Build the scene BVH on host. mode: "sah" (default) or
    "median_random_axis" (the reference's algorithm, bvh.hpp:15-42).

    The default SAH build runs in the zenith_native C++ library when the
    toolchain is available (10-100x faster for mesh-heavy scenes); the pure
    Python builder is the fallback and the reference-algorithm mode.
    as_numpy=True keeps host arrays (SceneBuilder converts the whole scene
    pytree in one pass); default converts to device arrays here."""
    import sys

    pmin, pmax, ptype, prow = primitive_bounds(scene)

    native_result = None
    if mode == "sah" and use_native is not False:
        from .. import native as native_mod

        native_result = native_mod.build_bvh(pmin, pmax, leaf_size, SAH_BINS)

    if native_result is not None:
        nodes = None
        leaf_order = native_result["leaf_order"]
        counts = native_result["count"].tolist()
        n_levels = native_result["n_levels"]
    else:
        ids = np.arange(len(ptype))
        rng = np.random.default_rng(seed)
        old_limit = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old_limit, 10000 + len(ids)))
        try:
            root = _build_tree(pmin, pmax, ids, leaf_size, mode, rng)
        finally:
            sys.setrecursionlimit(old_limit)
        nodes, leaf_order = _flatten(root)
        counts = [n["count"] for n in nodes]
        n_levels = _depth(root)

    slot_type = ptype[leaf_order]
    slot_row = prow[leaf_order]

    # Pre-gather leaf-ordered primitive data (numpy; tables may be jnp when
    # rebuilding an already-built scene — np.asarray handles both).
    sph_c = np.asarray(scene.spheres.center)
    sph_r = np.asarray(scene.spheres.radius)
    tri_v0 = np.asarray(scene.triangles.v0)
    tri_e1 = np.asarray(scene.triangles.e1)
    tri_e2 = np.asarray(scene.triangles.e2)
    p = len(slot_type)
    slot_center = np.zeros((p, 3), np.float32)
    slot_radius = np.zeros((p,), np.float32)
    slot_v0 = np.zeros((p, 3), np.float32)
    slot_e1 = np.zeros((p, 3), np.float32)
    slot_e2 = np.zeros((p, 3), np.float32)
    slot_minv = np.zeros((p, 9), np.float32)
    slot_trans = np.full((p, 3), 1e6, np.float32)  # non-box slots never hit
    is_sph = slot_type == PRIM_SPHERE
    is_tri = slot_type == PRIM_TRIANGLE
    is_box = slot_type == PRIM_BOX
    slot_center[is_sph] = sph_c[slot_row[is_sph]]
    slot_radius[is_sph] = sph_r[slot_row[is_sph]]
    slot_v0[is_tri] = tri_v0[slot_row[is_tri]]
    slot_e1[is_tri] = tri_e1[slot_row[is_tri]]
    slot_e2[is_tri] = tri_e2[slot_row[is_tri]]
    if is_box.any():
        box_minv = np.asarray(scene.boxes.minv)
        box_trans = np.asarray(scene.boxes.trans)
        slot_minv[is_box] = box_minv[slot_row[is_box]]
        slot_trans[is_box] = box_trans[slot_row[is_box]]

    if native_result is not None:
        node_min = native_result["node_min"]
        node_max = native_result["node_max"]
        escape = native_result["escape"]
        first = native_result["first"]
        count = native_result["count"]
        level = native_result["level"]
    else:
        node_min = np.stack([n["mn"] for n in nodes]).astype(np.float32)
        node_max = np.stack([n["mx"] for n in nodes]).astype(np.float32)
        escape = np.asarray([n["escape"] for n in nodes], np.int32)
        first = np.asarray([n["first"] for n in nodes], np.int32)
        count = np.asarray(counts, np.int32)
        level = np.asarray([n["level"] for n in nodes], np.int32)

    out = FlatBVH(
        node_min=node_min,
        node_max=node_max,
        escape=escape,
        first=first,
        count=count,
        prim_type=np.asarray(slot_type, np.int32),
        prim_row=np.asarray(slot_row, np.int32),
        node_level=level,
        slot_center=slot_center,
        slot_radius=slot_radius,
        slot_v0=slot_v0,
        slot_e1=slot_e1,
        slot_e2=slot_e2,
        slot_minv=slot_minv,
        slot_trans=slot_trans,
        n_levels=n_levels,
        leaf_size=max(1, max(counts)),
    )
    if as_numpy:
        return out
    return jax.tree.map(jnp.asarray, out)
