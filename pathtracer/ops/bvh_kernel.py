"""Stackless BVH traversal as a Pallas kernel on the Triton route (GPU).

The same algorithm as the XLA walker (ops/traverse.py) over the same
DFS-threaded layout (accel/layout.py), restructured for a GPU: one program
walks one block of rays, every lane keeps its own node pointer, leaf cursor
and best hit in registers, and the block's loop ends as soon as ITS last
lane is done instead of the whole wavefront's.  Each lane gathers only the
node and triangle rows it visits; the bench scene's tables fit in L2.

One loop step advances every running lane by one unit of work: a lane
inside a leaf tests the leaf's next triangle, any other running lane tests
its current node's box (entering a hit internal node at ``node + 1``,
otherwise taking the escape link; a hit leaf starts a triangle run).  The
leaf run is bounded by the leaf's own count, and the per-lane visit order is
exactly the walker's, so both report the same nearest triangle.

``t_max`` seeds ``best_t``: a capped occlusion query prunes every box and
triangle beyond its cap and reports a miss when nothing lies inside it.

Outputs are the raw (t, sorted triangle row) pair; the payload resolve
(u/v, position, normal, material) stays in XLA (ops/intersect.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu_triton

from ..accel.layout import BVHLayout, NODE_COLS, TRI_COLS
from .intersect import Hit, finalize_hit
from .traverse import safe_inverse

# Rays per program.  A power of two (Triton's block shapes must be); small
# blocks let coherent groups of rays finish early, and each lane is one
# thread at num_warps = BLOCK // 32.
BLOCK = 32


def _traverse_kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
                     ix_ref, iy_ref, iz_ref, tmax_ref, active_ref,
                     nodes_ref, tris_ref, t_ref, row_ref, *, num_nodes,
                     t_min):
    ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]
    ix, iy, iz = ix_ref[...], iy_ref[...], iz_ref[...]
    sentinel = jnp.int32(num_nodes)

    def node_col(base, k, mask):
        return plgpu_triton.load(nodes_ref.at[base + k], mask=mask, other=0.0)

    def tri_col(base, k, mask):
        return plgpu_triton.load(tris_ref.at[base + k], mask=mask, other=0.0)

    def cond(carry):
        cur, tri, end, _, _ = carry
        busy = (cur < sentinel) | (tri < end)
        return jnp.max(busy.astype(jnp.int32)) > 0

    def body(carry):
        cur, tri, end, best_t, best_row = carry
        in_leaf = tri < end
        at_node = jnp.logical_not(in_leaf) & (cur < sentinel)

        # ---- node step: slab test against the lane's current box ----
        nb = jnp.where(at_node, cur, 0) * NODE_COLS
        t0x = (node_col(nb, 0, at_node) - ox) * ix
        t0y = (node_col(nb, 1, at_node) - oy) * iy
        t0z = (node_col(nb, 2, at_node) - oz) * iz
        t1x = (node_col(nb, 3, at_node) - ox) * ix
        t1y = (node_col(nb, 4, at_node) - oy) * iy
        t1z = (node_col(nb, 5, at_node) - oz) * iz
        enter = jnp.maximum(
            jnp.maximum(jnp.minimum(t0x, t1x), jnp.minimum(t0y, t1y)),
            jnp.minimum(t0z, t1z),
        )
        exit_ = jnp.minimum(
            jnp.minimum(jnp.maximum(t0x, t1x), jnp.maximum(t0y, t1y)),
            jnp.maximum(t0z, t1z),
        )
        hit_box = (at_node & (enter <= exit_) & (exit_ > t_min)
                   & (enter < best_t))
        miss = jax.lax.bitcast_convert_type(
            node_col(nb, 6, at_node), jnp.int32)
        meta = jax.lax.bitcast_convert_type(
            node_col(nb, 7, at_node), jnp.int32)
        count = meta & 63
        first = meta >> 6
        leaf = count > 0
        descend = hit_box & jnp.logical_not(leaf)
        start_run = hit_box & leaf
        cur = jnp.where(at_node, jnp.where(descend, cur + 1, miss), cur)

        # ---- triangle step: Moller-Trumbore against the leaf's next row ----
        tb = jnp.where(in_leaf, tri, 0) * TRI_COLS
        p0x = tri_col(tb, 0, in_leaf)
        p0y = tri_col(tb, 1, in_leaf)
        p0z = tri_col(tb, 2, in_leaf)
        e1x = tri_col(tb, 3, in_leaf)
        e1y = tri_col(tb, 4, in_leaf)
        e1z = tri_col(tb, 5, in_leaf)
        e2x = tri_col(tb, 6, in_leaf)
        e2y = tri_col(tb, 7, in_leaf)
        e2z = tri_col(tb, 8, in_leaf)
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        inv_det = 1.0 / jnp.where(det != 0.0, det, 1.0)
        tx = ox - p0x
        ty = oy - p0y
        tz = oz - p0z
        u = (tx * px + ty * py + tz * pz) * inv_det
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv_det
        t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        better = (in_leaf & (det != 0.0) & (u >= 0.0) & (v >= 0.0)
                  & (u + v <= 1.0) & (t > t_min) & (t < best_t))
        best_t = jnp.where(better, t, best_t)
        best_row = jnp.where(better, tri, best_row)

        tri = jnp.where(in_leaf, tri + 1, jnp.where(start_run, first, tri))
        end = jnp.where(start_run, first + count, end)
        return cur, tri, end, best_t, best_row

    active = active_ref[...] != 0
    zeros = jnp.zeros(active.shape, jnp.int32)
    carry = (
        jnp.where(active, zeros, sentinel),
        zeros,
        zeros,
        tmax_ref[...],
        zeros - 1,
    )
    _, _, _, best_t, best_row = jax.lax.while_loop(cond, body, carry)
    t_ref[...] = best_t
    row_ref[...] = best_row


@functools.partial(
    jax.jit, static_argnames=("num_nodes", "t_min", "block", "interpret"))
def traverse_raw(o, d, nodes, tris, active, t_max, *, num_nodes: int,
                 t_min: float = 0.0, block: int = BLOCK,
                 interpret: bool = False):
    """(best_t, best_row) per lane: best_row is the nearest hit's SORTED
    triangle row, -1 when nothing lies in (t_min, t_max).  N is padded to a
    multiple of ``block`` with inactive lanes."""
    n = o.shape[1]
    n_pad = -(-n // block) * block
    inv = safe_inverse(d[0], d[1], d[2])

    def pad(x, value=0):
        return jnp.pad(x, (0, n_pad - n), constant_values=value)

    lanes = [pad(c) for c in (*o, *d, *inv)]
    lanes.append(pad(t_max.astype(jnp.float32)))
    lanes.append(pad(active.astype(jnp.int32)))
    lane_spec = pl.BlockSpec((block,), lambda i: (i,))
    table_spec = pl.BlockSpec(memory_space=pl.ANY)
    kernel = functools.partial(
        _traverse_kernel, num_nodes=num_nodes, t_min=t_min)
    best_t, best_row = pl.pallas_call(
        kernel,
        grid=(n_pad // block,),
        in_specs=[lane_spec] * len(lanes) + [table_spec, table_spec],
        out_specs=[lane_spec, lane_spec],
        out_shape=[
            jax.ShapeDtypeStruct((n_pad,), jnp.float32),
            jax.ShapeDtypeStruct((n_pad,), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu_triton.CompilerParams(
            num_warps=max(1, block // 32), num_stages=1),
        interpret=interpret,
        name="bvh_traverse",
    )(*lanes, nodes.reshape(-1), tris.reshape(-1))
    return best_t[:n], best_row[:n]


def intersect_bvh_kernel(
    o: jnp.ndarray,
    d: jnp.ndarray,
    lay: BVHLayout,
    t_min: float = 0.0,
    active=None,
    t_max=None,
    block: int = BLOCK,
    interpret: bool = False,
) -> Hit:
    """Nearest hit within (t_min, t_max) for (3, N) rays -- the kernel twin
    of :func:`ops.traverse.intersect_bvh` (same arguments, same Hit)."""
    n = o.shape[1]
    if active is None:
        active = jnp.ones((n,), bool)
    if t_max is None:
        t_max = jnp.full((n,), jnp.inf, jnp.float32)
    best_t, best_row = traverse_raw(
        o, d, lay.nodes, lay.tris, active, t_max, num_nodes=lay.num_nodes,
        t_min=t_min, block=block, interpret=interpret,
    )
    found = best_row >= 0
    row = jnp.maximum(best_row, 0)
    best_t = jnp.where(found, best_t, jnp.inf)
    hit = finalize_hit(o, d, lay.p0, lay.p1, lay.p2, best_t, row, t_min)
    return hit._replace(tri=lay.sorted_to_orig[row])
