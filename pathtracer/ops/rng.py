"""Counter-based per-pixel RNG (PCG hash family).

The reference seeds mt19937_64 from the wall clock and tiles a 64x64 noise
buffer across the screen (reference: renderer/Renderer.mm:109-129,485-497) —
non-reproducible and correlated.  The north-star design moves RNG to
counter-based hashing so every sample is a pure function of
(pixel, frame, bounce, purpose, seed): frames are bit-identical regardless of
device count, sharding, or evaluation order, which is what makes the
multi-chip tile/sample sharding in parallel/ exactly equivalent to the
single-chip render.

Hashes are the PCG3D/PCG4D mixers from Jarzynski & Olano, "Hash Functions for
GPU Rendering" (JCGT 2020) -- pure uint32 arithmetic, no threefry key
schedule per pixel.
"""

from __future__ import annotations

import jax.numpy as jnp

_U32 = jnp.uint32


def pcg4d(a, b, c, d):
    """PCG4D mix of four uint32 streams -> four decorrelated uint32 streams."""
    v0 = a.astype(_U32)
    v1 = jnp.asarray(b, _U32)
    v2 = jnp.asarray(c, _U32)
    v3 = jnp.asarray(d, _U32)
    mul = _U32(1664525)
    inc = _U32(1013904223)
    v0 = v0 * mul + inc
    v1 = v1 * mul + inc
    v2 = v2 * mul + inc
    v3 = v3 * mul + inc
    v0 = v0 + v1 * v3
    v1 = v1 + v2 * v0
    v2 = v2 + v0 * v1
    v3 = v3 + v1 * v2
    v0 = v0 ^ (v0 >> 16)
    v1 = v1 ^ (v1 >> 16)
    v2 = v2 ^ (v2 >> 16)
    v3 = v3 ^ (v3 >> 16)
    v0 = v0 + v1 * v3
    v1 = v1 + v2 * v0
    v2 = v2 + v0 * v1
    v3 = v3 + v1 * v2
    return v0, v1, v2, v3


def _to_unit_float(bits: jnp.ndarray) -> jnp.ndarray:
    """uint32 -> float32 in [0, 1) using the top 24 bits."""
    return (bits >> 8).astype(jnp.float32) * jnp.float32(1.0 / 16777216.0)


def uniforms(pixel_id: jnp.ndarray, frame, bounce, salt, count: int) -> jnp.ndarray:
    """(N,) pixel ids -> (count, N) independent uniforms in [0, 1).

    ``salt`` folds the user seed in; ``frame``/``bounce`` are scalar counters.
    Each group of 4 lanes comes from one PCG4D evaluation re-keyed by lane
    group, so any ``count`` is cheap.
    """
    pid = pixel_id.astype(_U32)
    frame = jnp.asarray(frame, _U32)
    bounce = jnp.asarray(bounce, _U32)
    salt = jnp.asarray(salt, _U32)
    outs = []
    for group in range((count + 3) // 4):
        v = pcg4d(
            pid,
            frame + _U32(0x9E3779B9) * _U32(group),
            bounce ^ (salt << _U32(1)),
            salt + _U32(group) * _U32(0x85EBCA6B),
        )
        outs.extend(_to_unit_float(x) for x in v)
    return jnp.stack(outs[:count], axis=0)


def _rd_alphas_u32(count: int) -> list[int]:
    """Rd rank-1 lattice generators as uint32 fixed point.

    alpha_i = phi_d^-(i+1) with phi_d the unique positive root of
    x^(d+1) = x + 1 (Roberts, "The Unreasonable Effectiveness of
    Quasirandom Sequences", 2018), scaled to 2^32.  Computed host-side
    once per (static) dimension count.
    """
    d = count
    # Newton solve for phi_d
    x = 2.0
    for _ in range(64):
        x = x - (x ** (d + 1) - x - 1.0) / ((d + 1) * x ** d - 1.0)
    out = []
    for i in range(1, d + 1):
        a = (1.0 / x) ** i % 1.0
        out.append(int(a * 4294967296.0) | 1)  # odd -> full period mod 2^32
    return out


def uniforms_r2(pixel_id: jnp.ndarray, frame, bounce, salt,
                count: int) -> jnp.ndarray:
    """(N,) pixel ids -> (count, N) LOW-DISCREPANCY uniforms over frames.

    Padded Cranley-Patterson-rotated rank-1 Rd lattices in exact uint32
    arithmetic.  Dimensions are split into blocks of <= 2; each block b
    gets its own Rd generator set, its own per-(pixel, bounce, block)
    random rotation rot_i, AND its own per-(pixel, bounce, block) XOR
    index scramble c_b:

        u_i = ((rot_i + (frame ^ c_b) * alpha_i) mod 2^32) / 2^32

    Within a block the designed 2D R2 projection is preserved (the XOR
    shuffles power-of-2-aligned prefixes onto contiguous lattice runs, so
    per-dim stratification over N accumulated frames survives); ACROSS
    blocks the independently-scrambled indices pair lattice points
    pseudo-randomly, killing the systematic projection coupling that makes
    one global high-dimensional lattice PLATEAU instead of converge
    (measured: a single R6/R10 lattice stalled at 4x the i.i.d. MSE by 256
    frames; the padded form converges unbiased and faster than i.i.d.).
    Exact integer wrap means no float-precision decay at high frame
    counts.
    """
    pid = pixel_id.astype(_U32)
    bounce = jnp.asarray(bounce, _U32)
    salt = jnp.asarray(salt, _U32)
    findex = jnp.asarray(frame, _U32)
    n_blocks = (count + 1) // 2
    alphas2 = _rd_alphas_u32(2)
    outs = []
    for pair in range((n_blocks + 1) // 2):
        # one pcg4d call serves TWO 2-dim blocks: lanes 0,1 = rotations of
        # block 2*pair, lane 2 is split... cheaper: two calls per 4 dims
        rot = pcg4d(
            pid,
            _U32(0x52D00000) + _U32(0x9E3779B9) * _U32(pair),
            bounce ^ (salt << _U32(1)),
            salt + _U32(pair) * _U32(0x85EBCA6B),
        )
        scr = pcg4d(
            pid,
            _U32(0x5C4AB1E5) + _U32(0x9E3779B9) * _U32(pair),
            bounce ^ (salt << _U32(1)),
            salt + _U32(pair) * _U32(0xC2B2AE35),
        )
        for half in range(2):
            b = pair * 2 + half
            if b >= n_blocks:
                break
            idx = findex ^ scr[half]
            for lane in range(2):
                i = b * 2 + lane
                if i >= count:
                    break
                bits = rot[half * 2 + lane] + idx * _U32(alphas2[lane])
                outs.append(_to_unit_float(bits))
    return jnp.stack(outs[:count], axis=0)
