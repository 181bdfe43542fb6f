"""DFS-threaded BVH layout for stackless traversal.

The BVH builders (lbvh.py, native.py) number nodes by build order, not by
traversal order.  This pass (host-side numpy, one-shot at scene load -- the
analog of the reference's startup ``rebuild``, renderer/Renderer.mm:456-462)
re-numbers the *effective* tree (leaf-collapsed) in DFS preorder and packs it
for the traversal backends (ops/traverse.py, ops/bvh_kernel.py):

  * DFS preorder makes ``first_child == node + 1``, and ``miss`` (escape)
    links always point forward; the sentinel M means done.  A ray walks the
    tree with one node pointer and no stack.
  * Node rows: (M, 8) f32 [bmin.xyz, bmax.xyz, miss, meta], where the two
    int32 fields are stored bit-for-bit (meta = first_tri * 64 + tri_count;
    tri_count == 0 marks an internal node), so one 32-byte row is all a
    node visit reads.
  * Triangle rows: (T, 16) f32 [p0.xyz, e1.xyz, e2.xyz, pad] in sorted
    order, so every leaf is one contiguous run of 64-byte rows.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from .lbvh import BVH

MAX_LEAF = 63  # tri_count field width (6 bits)
NODE_COLS = 8   # node row: bmin.xyz, bmax.xyz, miss, meta
TRI_COLS = 16   # triangle row: p0.xyz, e1.xyz, e2.xyz, pad


class BVHLayout(NamedTuple):
    nodes: jnp.ndarray           # (M, NODE_COLS) float32 (module docstring)
    tris: jnp.ndarray            # (T, TRI_COLS) float32 (module docstring)
    sorted_to_orig: jnp.ndarray  # (T,) int32 sorted slot -> original tri index
    num_nodes: int               # M (sentinel id == M)
    num_tris: int
    max_leaf: int                # max tri_count over leaves (static unroll bound)

    # component-major copies for the XLA walker
    bmin: jnp.ndarray            # (3, M)
    bmax: jnp.ndarray            # (3, M)
    miss: jnp.ndarray            # (M,) int32
    first_tri: jnp.ndarray       # (M,) int32
    tri_count: jnp.ndarray       # (M,) int32 (0 = internal)
    p0: jnp.ndarray              # (3, T) sorted triangle vertices
    p1: jnp.ndarray
    p2: jnp.ndarray

    # Optional material-baked resolve rows (cfg.bake_materials), in ORIGINAL
    # triangle order: [diffuse S, emissive S, ior, mtype, (rough)] per
    # triangle, so the payload resolve reads a hit's material constants with
    # one row gather instead of the per-material select chains.
    # ``matmeta`` = (S, has_rough) records the column split.
    matrows: jnp.ndarray | None = None    # (T, 2S + 2 (+1)) float32
    matmeta: tuple | None = None          # (spectrum_samples, has_rough)
    builder: str = ""                     # which builder made the tree


def dfs_layout(
    bvh: BVH,
    mat_tables=None,     # optional dict: material_id (T,) in original order,
                         # diffuse/emissive (S, M), ior (M,), mtype (M,),
                         # rough (M,) or None -> builds matrows
    builder: str = "",
) -> BVHLayout:
    """Flatten the effective (leaf-collapsed) tree into DFS preorder."""
    left = np.asarray(bvh.left)
    right = np.asarray(bvh.right)
    is_leaf = np.asarray(bvh.is_leaf)
    first_tri = np.asarray(bvh.first_tri)
    tri_count = np.asarray(bvh.tri_count)
    bmin = np.asarray(bvh.bmin)
    bmax = np.asarray(bvh.bmax)

    # Iterative DFS preorder over the effective tree; post-order accumulation
    # of subtree sizes gives the escape links: miss[pos] = pos + subtree_size.
    order: list[int] = []
    sizes: list[int] = []
    stack: list[tuple[int, int, bool]] = [(int(bvh.root), -1, False)]
    open_pos: list[int] = []  # positions awaiting their post-visit size fix-up
    while stack:
        node, _, post = stack.pop()
        if post:
            p = open_pos.pop()
            sizes[p] = (len(order) - p)
            continue
        order.append(node)
        sizes.append(1)
        if not is_leaf[node]:
            open_pos.append(len(order) - 1)
            stack.append((node, -1, True))  # post-visit marker
            stack.append((int(right[node]), -1, False))
            stack.append((int(left[node]), -1, False))

    m = len(order)
    order_arr = np.asarray(order, np.int64)
    new_miss = (np.arange(m) + np.asarray(sizes)).astype(np.int32)

    out_bmin = bmin[:, order_arr]
    out_bmax = bmax[:, order_arr]
    out_first = first_tri[order_arr].astype(np.int32)
    counts = np.where(is_leaf[order_arr], tri_count[order_arr], 0).astype(np.int32)
    max_leaf = int(counts.max()) if m else 1
    if max_leaf > MAX_LEAF:
        raise ValueError(f"leaf size {max_leaf} exceeds packable {MAX_LEAF}")

    # Lay leaf triangle runs out in DFS leaf order, so a walk's triangle
    # reads advance through memory with its node reads.  Builders partition
    # the sorted-triangle array left/right, which *should* already give DFS
    # order, but enforce it by remapping when needed.
    p0 = np.asarray(bvh.p0)
    p1 = np.asarray(bvh.p1)
    p2 = np.asarray(bvh.p2)
    num_tris = p0.shape[1]
    s2o = np.asarray(bvh.sorted_to_orig, np.int64)
    leaf_pos = np.flatnonzero(counts > 0)
    firsts = out_first[leaf_pos]
    cnts = counts[leaf_pos]
    contiguous = (
        len(leaf_pos) > 0
        and firsts[0] == 0
        and np.all(firsts[1:] == firsts[:-1] + cnts[:-1])
        and firsts[-1] + cnts[-1] == num_tris
    )
    if not contiguous:
        # remap sorted-tri order to DFS leaf order
        perm = np.concatenate(
            [np.arange(f, f + c) for f, c in zip(firsts, cnts)]
        ) if len(leaf_pos) else np.arange(0)
        assert perm.size == num_tris, "leaves must partition the triangles"
        p0 = p0[:, perm]
        p1 = p1[:, perm]
        p2 = p2[:, perm]
        s2o = s2o[perm]
        out_first[leaf_pos] = np.cumsum(np.concatenate([[0], cnts[:-1]]))

    meta = ((out_first.astype(np.uint32) << 6) | counts.astype(np.uint32)).astype(np.int32)
    nodes = np.zeros((m, NODE_COLS), np.float32)
    nodes[:, 0:3] = out_bmin.T
    nodes[:, 3:6] = out_bmax.T
    nodes[:, 6] = new_miss.view(np.float32)
    nodes[:, 7] = meta.view(np.float32)
    tris = np.zeros((num_tris, TRI_COLS), np.float32)
    tris[:, 0:3] = p0.T
    tris[:, 3:6] = (p1 - p0).T
    tris[:, 6:9] = (p2 - p0).T

    matrows = None
    matmeta = None
    if mat_tables is not None:
        mid = np.asarray(mat_tables["material_id"]).astype(np.int64)
        diffuse = np.asarray(mat_tables["diffuse"], np.float32)   # (S, M)
        emissive = np.asarray(mat_tables["emissive"], np.float32)
        rough = mat_tables.get("rough")
        cols = [diffuse[:, mid].T, emissive[:, mid].T,
                np.asarray(mat_tables["ior"], np.float32)[mid][:, None],
                np.asarray(mat_tables["mtype"], np.float32)[mid][:, None]]
        if rough is not None:
            cols.append(np.asarray(rough, np.float32)[mid][:, None])
        matrows = jnp.asarray(np.concatenate(cols, axis=1))
        matmeta = (diffuse.shape[0], rough is not None)

    return BVHLayout(
        nodes=jnp.asarray(nodes),
        tris=jnp.asarray(tris),
        sorted_to_orig=jnp.asarray(s2o, jnp.int32),
        num_nodes=m,
        num_tris=num_tris,
        max_leaf=max_leaf,
        bmin=jnp.asarray(out_bmin),
        bmax=jnp.asarray(out_bmax),
        miss=jnp.asarray(new_miss),
        first_tri=jnp.asarray(out_first),
        tri_count=jnp.asarray(counts),
        p0=jnp.asarray(p0),
        p1=jnp.asarray(p1),
        p2=jnp.asarray(p2),
        matrows=matrows,
        matmeta=matmeta,
        builder=builder,
    )
