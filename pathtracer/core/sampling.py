"""Sampling warps and low-discrepancy sequences.

JAX re-implementations of the sampling/color math block in the reference
header (reference: renderer/Raytracing.h:125-228).  All functions are pure,
branchless (``jnp.where`` instead of data-dependent branches) and vectorized over
leading batch dimensions, so they trace into a single fused XLA computation.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import PI
from .math3d import dot, normalize, reflect  # noqa: F401  (reflect re-exported)

_MAX_RADICAL_ITERS = 32  # enough for any uint32 index in base >= 2


def halton(index: jnp.ndarray, base: int) -> jnp.ndarray:
    """Halton radical inverse (reference: renderer/Raytracing.h:137-151).

    The reference's data-dependent ``while`` loop becomes a fixed-trip masked
    loop so it stays jit/vmap friendly.
    """
    index = jnp.asarray(index, jnp.uint32)
    f = jnp.ones(index.shape, jnp.float32)
    r = jnp.zeros(index.shape, jnp.float32)
    fbase = jnp.float32(base)
    for _ in range(_MAX_RADICAL_ITERS):
        active = index > 0
        # NB: the reference accumulates with f *before* dividing it, so the most
        # significant digit is weighted 1.0 — quirk preserved.
        r = jnp.where(active, r + f * (index % base).astype(jnp.float32), r)
        f = jnp.where(active, f / fbase, f)
        index = index // base
    return r


def van_der_corput(index: jnp.ndarray, base: int) -> jnp.ndarray:
    """Van der Corput sequence (reference: renderer/Raytracing.h:153-166).

    Note the reference squares ``baseInv`` each iteration (``baseInv *= baseInv``)
    — a quirk faithfully reproduced here.
    """
    index = jnp.asarray(index, jnp.uint32)
    result = jnp.zeros(index.shape, jnp.float32)
    base_inv = jnp.full(index.shape, 1.0 / base, jnp.float32)
    for _ in range(_MAX_RADICAL_ITERS):
        active = index > 0
        result = jnp.where(
            active, result + (index % base).astype(jnp.float32) * base_inv, result
        )
        base_inv = jnp.where(active, base_inv * base_inv, base_inv)
        index = index // base
    return result


def triangle_sample_pdf(
    area: jnp.ndarray, cos_theta: jnp.ndarray, distance_to_sample: jnp.ndarray
) -> jnp.ndarray:
    """Area-to-solid-angle pdf conversion (reference: renderer/Raytracing.h:168-171)."""
    return (distance_to_sample * distance_to_sample) / (area * cos_theta)


def balance_heuristic(f_pdf: jnp.ndarray, g_pdf: jnp.ndarray) -> jnp.ndarray:
    """MIS weight. Despite its reference name, this is the power heuristic
    (beta=2): f^2 / (f^2 + g^2) (reference: renderer/Raytracing.h:173-178)."""
    f2 = f_pdf * f_pdf
    g2 = g_pdf * g_pdf
    d = f2 + g2
    # d == 0 is reachable on extension lanes (a grazing GGX bounce whose
    # VNDF pdf underflows to 0 competing with a zero light pdf): 0/0 would
    # poison the accumulator; weight 0 is correct (contribution is gated on
    # the pdfs elsewhere).  Unreachable for the reference's own materials
    # (its only finite pdf, diffuse cos/pi, is strictly positive).
    return jnp.where(d > 0.0, f2 / jnp.where(d > 0.0, d, 1.0), 0.0)


def barycentric(smp: jnp.ndarray) -> jnp.ndarray:
    """Uniform triangle warp: (2, N) samples -> (3, N) barycentric weights
    (reference: renderer/Raytracing.h:182-187)."""
    r1 = jnp.sqrt(smp[0])
    r2 = smp[1]
    return jnp.stack([1.0 - r1, r1 * (1.0 - r2), r1 * r2], axis=0)


def build_orthonormal_basis(n: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Branchless pixar-style ONB on (3, N) normals, matching the reference's
    two-branch variant exactly (reference: renderer/Raytracing.h:189-205)."""
    nx, ny, nz = n[0], n[1], n[2]
    neg = nz < 0.0
    a = 1.0 / jnp.where(neg, 1.0 - nz, 1.0 + nz)
    b = nx * ny * a
    # u: only the z component differs between branches
    u = jnp.stack([1.0 - nx * nx * a, -b, jnp.where(neg, nx, -nx)], axis=0)
    v = jnp.stack(
        [
            jnp.where(neg, b, -b),
            jnp.where(neg, ny * ny * a - 1.0, 1.0 - ny * ny * a),
            -ny,
        ],
        axis=0,
    )
    return u, v


def align_with_normal(
    n: jnp.ndarray, cos_theta: jnp.ndarray, phi: jnp.ndarray
) -> jnp.ndarray:
    """Spherical-to-world around (3, N) normals
    (reference: renderer/Raytracing.h:207-216)."""
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
    u, v = build_orthonormal_basis(n)
    return (u * jnp.cos(phi)[None] + v * jnp.sin(phi)[None]) * sin_theta[None] + (
        n * cos_theta[None]
    )


def generate_diffuse_bounce(smp: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Cosine-hemisphere bounce (reference: renderer/Raytracing.h:218-223).

    ``smp`` is (2, N): smp[1] -> cos(theta), smp[0] -> phi; ``n`` is (3, N).
    """
    cos_theta = jnp.sqrt(smp[1])
    phi = smp[0] * (PI * 2.0)
    return align_with_normal(n, cos_theta, phi)


def generate_mirror_bounce(w_in: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Perfect mirror bounce (reference: renderer/Raytracing.h:225-228)."""
    return reflect(w_in, n)


def select_light_index(xi: jnp.ndarray, cdf: jnp.ndarray) -> jnp.ndarray:
    """CDF inversion for light-triangle selection.

    The reference walks the table linearly, stopping at the first entry whose
    *next* (exclusive-prefix) cdf exceeds xi (reference:
    renderer/KernelHelpers.h:49-54).  With an exclusive-prefix table of length
    L+1 (sentinel cdf = 1.0 appended by the light-table builder, reference:
    renderer/Renderer.mm:444-448), that is exactly
    ``searchsorted(cdf[1:], xi, side='right')``.

    For small light tables the count-of-passed-entries form compiles to L
    full-width compares (no gather/sort machinery).
    """
    tail = cdf[1:]
    if tail.shape[0] <= 64:
        hits = tail[:, None] <= xi[None, :]            # (L, N)
        return jnp.sum(hits, axis=0, dtype=jnp.uint32)
    return jnp.searchsorted(tail, xi, side="right").astype(jnp.uint32)
