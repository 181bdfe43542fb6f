"""Small-table lookups without gathers.

Material and light tables are tiny (a handful of rows), so lookups compile to
a compare/select chain: R full-width vector selects instead of a gather.
Falls back to a real gather past ``MAX_SELECT`` rows.  Whether a GPU gather
beats the chain is unmeasured (ROADMAP S4).
"""

from __future__ import annotations

import jax.numpy as jnp

MAX_SELECT = 64


def select_cols(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """``table[..., idx]`` for a small trailing axis.

    table: (..., R) with static small R; idx: (N,) int -> (..., N).
    """
    r = table.shape[-1]
    if r > MAX_SELECT:
        return jnp.take(table, idx, axis=-1)
    expand = (slice(None),) * (table.ndim - 1) + (jnp.newaxis,)
    out = jnp.broadcast_to(
        table[..., 0][expand], table.shape[:-1] + idx.shape
    )
    for k in range(1, r):
        out = jnp.where(idx == k, table[..., k][expand], out)
    return out
