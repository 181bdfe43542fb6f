"""Stackless BVH traversal in pure JAX (XLA gathers).

The portable traversal backend over the DFS-threaded layout (accel/layout.py):
every ray carries a single node pointer; hit an internal node -> ``node + 1``
(DFS first child), otherwise -> the node's escape link.  No per-ray stack.
Leaf triangle runs are contiguous in sorted order and tested with a
statically-unrolled Moller-Trumbore loop.  One ``while_loop`` steps the whole
wavefront until its slowest lane is done.

This is the CPU path and the reference for the GPU kernel
(ops/bvh_kernel.py), which walks the same layout in the same order.

Replaces ``MPSRayIntersector.encodeIntersection`` (reference:
renderer/Renderer.mm:517-553); ``Hit.tri`` is reported in *original* triangle
indexing so the shading core's light-table comparisons are unchanged.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..accel.layout import BVHLayout
from .intersect import Hit, finalize_hit, moller_trumbore_planes


def safe_inverse(dx, dy, dz):
    """Component inverses, nudging zeros so 0 * inf never makes NaNs."""
    tiny = jnp.float32(1e-30)
    ix = 1.0 / jnp.where(jnp.abs(dx) < tiny, jnp.where(dx < 0, -tiny, tiny), dx)
    iy = 1.0 / jnp.where(jnp.abs(dy) < tiny, jnp.where(dy < 0, -tiny, tiny), dy)
    iz = 1.0 / jnp.where(jnp.abs(dz) < tiny, jnp.where(dz < 0, -tiny, tiny), dz)
    return ix, iy, iz


def intersect_bvh(
    o: jnp.ndarray,
    d: jnp.ndarray,
    lay: BVHLayout,
    t_min: float = 0.0,
    active=None,
    t_max=None,
) -> Hit:
    """Nearest-hit traversal.  o/d: (3, N) rays.  ``active``: (N,) bool lanes
    to trace (inactive lanes return miss without walking the tree).
    ``t_max``: (N,) range caps that seed ``best_t``, so boxes and triangles
    beyond a lane's cap are pruned; a lane with nothing inside its cap
    returns a miss."""
    n = o.shape[1]
    ox, oy, oz = o[0], o[1], o[2]
    dx, dy, dz = d[0], d[1], d[2]
    ix, iy, iz = safe_inverse(dx, dy, dz)

    sentinel = jnp.int32(lay.num_nodes)
    cur0 = jnp.zeros((n,), jnp.int32)
    if active is not None:
        cur0 = jnp.where(active, cur0, sentinel)

    ov = (ox[:, None], oy[:, None], oz[:, None])
    dv = (dx[:, None], dy[:, None], dz[:, None])
    e1 = lay.p1 - lay.p0
    e2 = lay.p2 - lay.p0

    def cond(carry):
        cur, best_t, best_i = carry
        return jnp.any(cur < sentinel)

    def body(carry):
        cur, best_t, best_i = carry
        running = cur < sentinel
        cs = jnp.where(running, cur, 0)

        t0x = (lay.bmin[0][cs] - ox) * ix
        t1x = (lay.bmax[0][cs] - ox) * ix
        t0y = (lay.bmin[1][cs] - oy) * iy
        t1y = (lay.bmax[1][cs] - oy) * iy
        t0z = (lay.bmin[2][cs] - oz) * iz
        t1z = (lay.bmax[2][cs] - oz) * iz
        enter = jnp.maximum(
            jnp.maximum(jnp.minimum(t0x, t1x), jnp.minimum(t0y, t1y)),
            jnp.minimum(t0z, t1z),
        )
        exit_ = jnp.minimum(
            jnp.minimum(jnp.maximum(t0x, t1x), jnp.maximum(t0y, t1y)),
            jnp.maximum(t0z, t1z),
        )
        hit_box = running & (enter <= exit_) & (exit_ > t_min) & (enter < best_t)

        count = lay.tri_count[cs]
        leaf = hit_box & (count > 0)
        first = lay.first_tri[cs]
        for k in range(lay.max_leaf):
            lane_on = leaf & (k < count)
            tri = jnp.where(lane_on, first + k, 0)
            tp = tuple(
                c[tri][:, None]
                for arr in (lay.p0, e1, e2)
                for c in (arr[0], arr[1], arr[2])
            )
            t, _, _ = moller_trumbore_planes(ov, dv, tp, t_min)
            t = t[:, 0]
            better = lane_on & (t < best_t)
            best_t = jnp.where(better, t, best_t)
            best_i = jnp.where(better, tri, best_i)

        nxt = jnp.where(hit_box & ~leaf, cs + 1, lay.miss[cs])
        cur = jnp.where(running, nxt, cur)
        return cur, best_t, best_i

    if t_max is None:
        best_t0 = jnp.full((n,), jnp.inf, jnp.float32)
    else:
        best_t0 = t_max.astype(jnp.float32)
    best_i0 = jnp.full((n,), -1, jnp.int32)
    _, best_t, best_i = jax.lax.while_loop(cond, body, (cur0, best_t0, best_i0))
    found = best_i >= 0
    best_t = jnp.where(found, best_t, jnp.inf)
    best_i = jnp.maximum(best_i, 0)

    hit_sorted = finalize_hit(o, d, lay.p0, lay.p1, lay.p2, best_t, best_i, t_min)
    # report hits in original triangle indexing
    return Hit(
        t=hit_sorted.t,
        tri=lay.sorted_to_orig[best_i],
        u=hit_sorted.u,
        v=hit_sorted.v,
    )


def make_bvh_intersector(lay: BVHLayout, scene, lay_occl=None,
                         traverse=intersect_bvh):
    """IntersectFn over a BVH: ``traverse`` is :func:`intersect_bvh` (the
    XLA walker) or ops.bvh_kernel.intersect_bvh_kernel (same signature).
    Capped (occlusion) queries walk ``lay_occl`` when given -- small leaves
    suit range-pruned walks.  The payload resolve is XLA's
    (:func:`ops.intersect.shade_from_scene`)."""
    from .intersect import shade_from_scene

    def fn(o, d, active, t_max=None):
        walk = lay if t_max is None or lay_occl is None else lay_occl
        hit = traverse(o, d, walk, active=active, t_max=t_max)
        return shade_from_scene(scene, hit, lay)

    return fn
