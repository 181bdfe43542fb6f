"""Component-major 3-vector helpers.

Layout rule for this whole framework: vectors are ``(3, N)`` arrays and
spectra are ``(S, N)`` arrays -- components in the *leading* axis, the batch
in the trailing (lane) axis, so every op is a dense, contiguous vector op over
rays.  Reductions over components are 3 full-width ops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def vec3(x, y, z) -> jnp.ndarray:
    """Stack three (N,)-shaped components into a (3, N) vector array."""
    return jnp.stack([x, y, z], axis=0)


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(3, N) . (3, N) -> (N,)."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.stack(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ],
        axis=0,
    )


def length(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(dot(a, a))


def normalize(a: jnp.ndarray, eps: float = 0.0) -> jnp.ndarray:
    n2 = dot(a, a)
    if eps:
        n2 = jnp.maximum(n2, eps)
    return a * jax.lax.rsqrt(n2)[None]


def reflect(i: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Metal-style reflect: i - 2*dot(n, i)*n (i points toward the surface)."""
    return i - (2.0 * dot(n, i))[None] * n


def where3(mask: jnp.ndarray, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Select on a (N,) mask between (3, N) (or (S, N)) vector arrays."""
    return jnp.where(mask[None], a, b)
