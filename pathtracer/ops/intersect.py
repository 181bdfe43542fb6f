"""Ray-triangle intersection backends.

The reference delegates nearest-hit queries to Apple's closed
MPSRayIntersector/MPSTriangleAccelerationStructure
(reference: renderer/Renderer.mm:456-469, 517-553).  JAX has no
intersection library, so this framework implements its own:

  * :func:`intersect_brute` — dense Moller-Trumbore over every triangle,
    chunk-scanned to bound live memory.  O(N*T) but branch-free and perfectly
    vectorized; the right tool for tiny scenes and the ground truth oracle for
    BVH tests.
  * ``ops.traverse`` / ``ops.bvh_kernel`` — stackless BVH traversal over
    the layout in accel/, the production path.

Layout note: all hot arithmetic runs on (N, C) component planes -- x, y, z
as separate arrays -- never on (..., 3)-trailing vectors.

Hit convention: barycentric (u, v) weight vertices 1 and 2; position =
(1-u-v)*p0 + u*p1 + v*p2.  Misses have t = +inf and tri = 0.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Hit(NamedTuple):
    t: jnp.ndarray     # (N,) float32, +inf on miss
    tri: jnp.ndarray   # (N,) int32, 0 on miss
    u: jnp.ndarray     # (N,) float32 weight on p1
    v: jnp.ndarray     # (N,) float32 weight on p2

    @property
    def uvw(self) -> jnp.ndarray:
        """(3, N) interpolation weights on (p0, p1, p2), component-major."""
        return jnp.stack([1.0 - self.u - self.v, self.u, self.v], axis=0)

    @property
    def valid(self) -> jnp.ndarray:
        return jnp.isfinite(self.t)


class HitShade(NamedTuple):
    """A hit plus everything the shading core needs (the intersector's
    payload resolve).

    The reference equivalent is ``Intersection`` + the per-thread
    TriangleReference/vertex/material fetches at the top of
    ``intersectionHandler`` (reference: renderer/Shaders.metal:121-140).
    """

    t: jnp.ndarray       # (N,) float32, +inf on miss
    u: jnp.ndarray       # (N,)
    v: jnp.ndarray       # (N,)
    tri: jnp.ndarray     # (N,) int32 ORIGINAL triangle index, 0 on miss
    mat: jnp.ndarray     # (N,) int32 material id, 0 on miss
    light: jnp.ndarray   # (N,) int32 light-table index, -1 if none/miss
    pos: jnp.ndarray     # (3, N) interpolated hit position
    normal: jnp.ndarray  # (3, N) interpolated unit shading normal
    # Optional baked material payload (cfg.bake_materials): dict with
    # "diffuse"/"emissive" (S, N), "ior"/"mtype" (N,), "rough" (N,) or
    # absent -- one row gather from accel/layout.py's matrows, replacing
    # the select_cols chains.
    mataux: dict | None = None

    @property
    def valid(self) -> jnp.ndarray:
        return jnp.isfinite(self.t)


def shade_from_scene(scene, hit: Hit, lay=None) -> HitShade:
    """Expand a bare Hit into a HitShade with XLA gathers from the scene SoA.

    When ``lay`` carries baked material rows (cfg.bake_materials) the hit's
    material constants come with one more row gather (``mataux``).
    """
    from ..core.geometry import interpolate  # local import to avoid a cycle

    tri = jnp.where(hit.valid, hit.tri, 0)
    pos, nrm = interpolate(
        scene.p0[:, tri], scene.p1[:, tri], scene.p2[:, tri],
        scene.n0[:, tri], scene.n1[:, tri], scene.n2[:, tri],
        hit.uvw,
    )
    mataux = None
    if lay is not None and lay.matrows is not None:
        s, has_rough = lay.matmeta
        rows = jnp.take(lay.matrows, tri, axis=0).T        # (K, N)
        mataux = {
            "diffuse": rows[0:s],
            "emissive": rows[s:2 * s],
            "ior": rows[2 * s],
            "mtype": rows[2 * s + 1].astype(jnp.int32),
        }
        if has_rough:
            mataux["rough"] = rows[2 * s + 2]
    return HitShade(
        t=hit.t,
        u=hit.u,
        v=hit.v,
        tri=tri,
        mat=scene.material_id[tri],
        light=jnp.where(hit.valid, scene.light_index[tri], -1),
        pos=pos,
        normal=nrm,
        mataux=mataux,
    )


def _components(a: jnp.ndarray):
    """Split a (3, N) component-major vector array."""
    return a[0], a[1], a[2]


def moller_trumbore_planes(o, d, tri_planes, t_min: float = 0.0):
    """All-pairs Moller-Trumbore on component planes.

    Args:
      o, d: tuples of three (N, 1) ray component arrays.
      tri_planes: tuple of nine (1, C) triangle component arrays
        (p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z).
      t_min: minimum accepted hit distance (exclusive).

    Returns (t, u, v): (N, C) arrays, t = +inf where no hit.  Double-sided
    (the reference configures MPS with no culling, renderer/Renderer.mm:465).
    """
    ox, oy, oz = o
    dx, dy, dz = d
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = tri_planes

    # pvec = cross(d, e2)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = jnp.where(det != 0.0, 1.0 / det, 0.0)
    tx = ox - p0x
    ty = oy - p0y
    tz = oz - p0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    # qvec = cross(tvec, e1)
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = (
        (det != 0.0)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
    )
    return jnp.where(ok, t, jnp.inf), u, v


def moller_trumbore(o, d, p0, e1, e2, t_min: float = 0.0):
    """(3,N) rays x (3,C) triangles -> (N,C) t/u/v.  Thin wrapper over the
    component-plane kernel."""
    ov = tuple(c[:, None] for c in _components(o))
    dv = tuple(c[:, None] for c in _components(d))
    tp = tuple(
        c[None, :] for arr in (p0, e1, e2) for c in _components(arr)
    )
    return moller_trumbore_planes(ov, dv, tp, t_min)


def triangle_planes(p0, p1, p2, chunk: int):
    """Pre-chunked (num_chunks, chunk) component planes for the brute scan.
    Padding triangles are degenerate (det == 0 -> never hit)."""
    num_tris = p0.shape[1]
    e1 = p1 - p0
    e2 = p2 - p0
    pad = (-num_tris) % chunk
    planes = []
    for arr in (p0, e1, e2):
        for c in _components(arr):
            c = jnp.concatenate([c, jnp.zeros((pad,), c.dtype)]) if pad else c
            planes.append(c.reshape(-1, chunk))
    return tuple(planes), (num_tris + pad) // chunk


def intersect_brute(
    o: jnp.ndarray,
    d: jnp.ndarray,
    p0: jnp.ndarray,
    p1: jnp.ndarray,
    p2: jnp.ndarray,
    t_min: float = 0.0,
    chunk: int = 256,
) -> Hit:
    """Nearest-hit over all triangles, scanning triangle chunks to keep the
    (N, chunk) intermediates bounded.

    ``o``/``d``: (3, N) rays; ``p0``/``p1``/``p2``: (3, T) triangle vertices.
    """
    num_tris = p0.shape[1]
    # lane-align: one chunk of the next multiple of 128 when the scene is small
    chunk = min(chunk, -(-num_tris // 128) * 128)
    planes, num_chunks = triangle_planes(p0, p1, p2, chunk)
    base = jnp.arange(num_chunks, dtype=jnp.int32) * chunk

    n = o.shape[1]
    ov = tuple(c[:, None] for c in _components(o))
    dv = tuple(c[:, None] for c in _components(d))
    init = (
        jnp.full((n,), jnp.inf, jnp.float32),
        jnp.zeros((n,), jnp.int32),
    )

    def body(carry, chunk_data):
        best_t, best_i = carry
        cbase = chunk_data[-1]
        tp = tuple(p[None, :] for p in chunk_data[:-1])
        t, _, _ = moller_trumbore_planes(ov, dv, tp, t_min)
        local = jnp.argmin(t, axis=1).astype(jnp.int32)
        ct = jnp.min(t, axis=1)
        better = ct < best_t
        return (
            jnp.where(better, ct, best_t),
            jnp.where(better, cbase + local, best_i),
        ), None

    if num_chunks == 1:
        (best_t, best_i), _ = body(
            init, tuple(p[0] for p in planes) + (jnp.int32(0),)
        )
    else:
        (best_t, best_i), _ = jax.lax.scan(body, init, (*planes, base))
    return finalize_hit(o, d, p0, p1, p2, best_t, best_i, t_min)


def finalize_hit(o, d, p0, p1, p2, best_t, best_i, t_min: float = 0.0) -> Hit:
    """Recompute (u, v) for each ray's single best triangle.

    Cheaper than carrying u/v through the chunk scan: one 9-component gather
    plus one elementwise Moller-Trumbore per ray, instead of a cross-lane
    gather per chunk iteration.
    """
    ov = tuple(c[:, None] for c in _components(o))
    dv = tuple(c[:, None] for c in _components(d))
    e1 = p1 - p0
    e2 = p2 - p0
    tp = tuple(
        c[best_i][:, None] for arr in (p0, e1, e2) for c in _components(arr)
    )  # nine (N, 1) planes: each ray against its own best triangle
    _, u, v = moller_trumbore_planes(ov, dv, tp, t_min)
    return Hit(t=best_t, tri=best_i, u=u[:, 0], v=v[:, 0])
