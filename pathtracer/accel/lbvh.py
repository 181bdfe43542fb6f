"""LBVH construction: Morton sort + Karras-style hierarchy, fully in JAX.

This replaces the reference's closed-source vendor acceleration structure
(``MPSTriangleAccelerationStructure.rebuild``, reference:
renderer/Renderer.mm:456-462) -- JAX has no intersection library, so the
framework builds its own BVH from scratch:

  1. 30-bit Morton codes of triangle centroids in the scene AABB;
  2. radix order via ``jnp.argsort``;
  3. binary radix tree topology per Karras, "Maximally Parallel Construction of
     Linear BVHs" (HPG 2012): every internal node's range/split found with
     vectorized prefix-length binary searches (``lax.clz`` on (code, index)
     pairs, so duplicate codes are handled);
  4. bottom-up AABB fitting by fixed-point iteration over tree levels;
  5. subtree-size-based leaf collapse to ``leaf_size`` triangles (Karras ranges
     are contiguous in sorted order, so every leaf is a contiguous triangle
     run);
  6. top-down threading: ``miss`` links (escape pointers) turning traversal
     stackless (no per-ray stacks).

Node ids: internal nodes are 0..N-2, leaf slots N-1..2N-2 hold sorted-order
singleton leaves.  The *effective* tree treats the topmost nodes with
subtree size <= leaf_size as leaves; nodes below them are never visited.

The build is jittable end-to-end (one-shot at scene load, like the reference's
startup ``rebuild``); rebuilding per frame for dynamic scenes is therefore
also possible.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

_I32 = jnp.int32


class BVH(NamedTuple):
    # geometry, in morton-sorted triangle order, component-major (3, T)
    p0: jnp.ndarray
    p1: jnp.ndarray
    p2: jnp.ndarray
    sorted_to_orig: jnp.ndarray  # (T,) int32: sorted slot -> original tri index
    # nodes (M = 2T - 1)
    bmin: jnp.ndarray        # (3, M)
    bmax: jnp.ndarray        # (3, M)
    left: jnp.ndarray        # (M,) int32 left child (internal nodes)
    right: jnp.ndarray       # (M,) int32 right child (internal nodes)
    miss: jnp.ndarray        # (M,) int32 escape link; M == done sentinel
    is_leaf: jnp.ndarray     # (M,) bool (effective leaves after collapse)
    first_tri: jnp.ndarray   # (M,) int32 first sorted-triangle of the subtree
    tri_count: jnp.ndarray   # (M,) int32 subtree triangle count
    root: int = 0

    @property
    def num_nodes(self) -> int:
        return self.left.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.p0.shape[1]


def morton_codes(cx, cy, cz) -> jnp.ndarray:
    """(N,) centroid components in [0,1] -> 30-bit interleaved Morton codes."""

    def expand_bits(v):
        # 10 input bits spread to every 3rd position (Karras 2012 fig. 4)
        v = (v * jnp.uint32(0x00010001)) & jnp.uint32(0xFF0000FF)
        v = (v * jnp.uint32(0x00000101)) & jnp.uint32(0x0F00F00F)
        v = (v * jnp.uint32(0x00000011)) & jnp.uint32(0xC30C30C3)
        v = (v * jnp.uint32(0x00000005)) & jnp.uint32(0x49249249)
        return v

    def quantize(c):
        return jnp.clip(c * 1024.0, 0.0, 1023.0).astype(jnp.uint32)

    return (
        (expand_bits(quantize(cx)) << 2)
        | (expand_bits(quantize(cy)) << 1)
        | expand_bits(quantize(cz))
    ).astype(jnp.uint32)


def _delta(codes: jnp.ndarray, i: jnp.ndarray, j: jnp.ndarray) -> jnp.ndarray:
    """Common-prefix length of keys i and j; -1 outside [0, N-1].

    Keys are (morton, index) pairs: when codes collide, the index breaks the
    tie (adds 32 to the prefix), exactly Karras's augmented-key trick.
    """
    n = codes.shape[0]
    valid = (j >= 0) & (j <= n - 1)
    j_safe = jnp.clip(j, 0, n - 1)
    ci = codes[i]
    cj = codes[j_safe]
    same = ci == cj
    prefix = jnp.where(
        same,
        32 + jax.lax.clz((i.astype(jnp.uint32) ^ j_safe.astype(jnp.uint32)) | jnp.uint32(0)),
        jax.lax.clz(ci ^ cj),
    )
    # clz of 0 (i == j) never happens for valid internal-node queries
    return jnp.where(valid, prefix.astype(_I32), _I32(-1))


@partial(jax.jit, static_argnames=("leaf_size",))
def build(p0, p1, p2, leaf_size: int = 4) -> BVH:
    """Construct the LBVH over (3, T) triangle vertex arrays."""
    num_tris = p0.shape[1]
    if num_tris < 2:
        # degenerate single-triangle scene: one leaf node
        bmin = jnp.minimum(jnp.minimum(p0, p1), p2)
        bmax = jnp.maximum(jnp.maximum(p0, p1), p2)
        return BVH(
            p0=p0, p1=p1, p2=p2,
            sorted_to_orig=jnp.arange(num_tris, dtype=_I32),
            bmin=bmin, bmax=bmax,
            left=jnp.zeros((1,), _I32),
            right=jnp.zeros((1,), _I32),
            miss=jnp.ones((1,), _I32),
            is_leaf=jnp.ones((1,), bool),
            first_tri=jnp.zeros((1,), _I32),
            tri_count=jnp.full((1,), num_tris, _I32),
        )

    # --- 1-2: morton codes of centroids, sort ---
    centroid = (p0 + p1 + p2) / 3.0                     # (3, T)
    lo = jnp.min(centroid, axis=1, keepdims=True)
    hi = jnp.max(centroid, axis=1, keepdims=True)
    unit = (centroid - lo) / jnp.maximum(hi - lo, 1e-12)
    codes = morton_codes(unit[0], unit[1], unit[2])
    order = jnp.argsort(codes).astype(_I32)
    codes = codes[order]
    p0s, p1s, p2s = p0[:, order], p1[:, order], p2[:, order]

    n = num_tris
    num_internal = n - 1
    num_nodes = 2 * n - 1
    leaf_base = num_internal  # leaf slot for sorted tri k: leaf_base + k

    # --- 3: Karras topology for internal nodes ---
    i = jnp.arange(num_internal, dtype=_I32)
    d = jnp.sign(_delta(codes, i, i + 1) - _delta(codes, i, i - 1)).astype(_I32)
    delta_min = _delta(codes, i, i - d)

    # find upper bound for range length
    def lmax_body(_, lmax):
        cont = _delta(codes, i, i + lmax * d) > delta_min
        return jnp.where(cont, lmax * 2, lmax)

    lmax = jax.lax.fori_loop(0, 32, lmax_body, jnp.full_like(i, 2))

    # binary search the exact other end j = i + l*d
    def l_body(step, l):
        t = lmax >> (step + 1)
        cond = (t >= 1) & (_delta(codes, i, i + (l + t) * d) > delta_min)
        return jnp.where(cond, l + t, l)

    l = jax.lax.fori_loop(0, 32, l_body, jnp.zeros_like(i))
    j = i + l * d
    delta_node = _delta(codes, i, j)

    # binary search the split position
    def s_body(step, carry):
        s, div = carry
        t = (l + div - 1) // div  # ceil(l / div)
        cond = (t >= 1) & (_delta(codes, i, i + (s + t) * d) > delta_node)
        return jnp.where(cond, s + t, s), jnp.minimum(div * 2, _I32(1 << 30))

    s, _ = jax.lax.fori_loop(0, 32, s_body, (jnp.zeros_like(i), jnp.full_like(i, 2)))
    gamma = i + s * d + jnp.minimum(d, 0)

    range_lo = jnp.minimum(i, j)
    range_hi = jnp.maximum(i, j)
    left_child = jnp.where(range_lo == gamma, leaf_base + gamma, gamma)
    right_child = jnp.where(range_hi == gamma + 1, leaf_base + gamma + 1, gamma + 1)

    # full-tree arrays
    left = jnp.concatenate([left_child, jnp.zeros((n,), _I32)])
    right = jnp.concatenate([right_child, jnp.zeros((n,), _I32)])

    first_tri = jnp.concatenate([range_lo, jnp.arange(n, dtype=_I32)])
    tri_count = jnp.concatenate(
        [range_hi - range_lo + 1, jnp.ones((n,), _I32)]
    )

    idx_internal = jnp.arange(num_internal, dtype=_I32)
    parent = jnp.zeros((num_nodes,), _I32)
    parent = parent.at[left_child].set(idx_internal)
    parent = parent.at[right_child].set(idx_internal)

    # --- 4: AABB fit, bottom-up fixed point ---
    leaf_bmin = jnp.minimum(jnp.minimum(p0s, p1s), p2s)   # (3, T)
    leaf_bmax = jnp.maximum(jnp.maximum(p0s, p1s), p2s)
    big = jnp.float32(3.4e38)
    bmin = jnp.concatenate([jnp.full((3, num_internal), big), leaf_bmin], axis=1)
    bmax = jnp.concatenate([jnp.full((3, num_internal), -big), leaf_bmax], axis=1)

    def fit_cond(carry):
        bmin, bmax, changed, it = carry
        return changed & (it < num_internal + 1)

    def fit_body(carry):
        bmin, bmax, _, it = carry
        new_min = jnp.minimum(bmin[:, left_child], bmin[:, right_child])
        new_max = jnp.maximum(bmax[:, left_child], bmax[:, right_child])
        changed = jnp.any(new_min != bmin[:, :num_internal]) | jnp.any(
            new_max != bmax[:, :num_internal]
        )
        bmin = bmin.at[:, :num_internal].set(new_min)
        bmax = bmax.at[:, :num_internal].set(new_max)
        return bmin, bmax, changed, it + 1

    bmin, bmax, _, _ = jax.lax.while_loop(
        fit_cond, fit_body, (bmin, bmax, jnp.bool_(True), jnp.int32(0))
    )

    # --- 5: leaf collapse: topmost nodes with subtree size <= leaf_size ---
    small = tri_count <= leaf_size
    parent_small = small[parent]
    root_is_small = jnp.zeros((num_nodes,), bool).at[0].set(small[0])
    is_leaf = (small & ~parent_small) | root_is_small

    # --- 6: miss links (escape pointers), top-down fixed point ---
    sentinel = _I32(num_nodes)
    miss = jnp.full((num_nodes,), sentinel)
    miss = _thread_miss(left_child, right_child, miss, idx_internal, num_internal)

    return BVH(
        p0=p0s, p1=p1s, p2=p2s,
        sorted_to_orig=order,
        bmin=bmin, bmax=bmax,
        left=left,
        right=right,
        miss=miss,
        is_leaf=is_leaf,
        first_tri=first_tri,
        tri_count=tri_count,
    )


def _thread_miss(left_child, right_child, miss, idx_internal, num_internal):
    """Propagate escape links top-down until fixed point."""

    def cond(carry):
        miss, changed, it = carry
        return changed & (it < num_internal + 1)

    def body(carry):
        miss, _, it = carry
        new_miss = miss.at[left_child].set(right_child)
        new_miss = new_miss.at[right_child].set(new_miss[idx_internal])
        changed = jnp.any(new_miss != miss)
        return new_miss, changed, it + 1

    miss, _, _ = jax.lax.while_loop(cond, body, (miss, jnp.bool_(True), jnp.int32(0)))
    return miss
