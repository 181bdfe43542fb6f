"""Pixel traversal order: 2D block tiling for ray coherence.

The traversal kernel runs a block of neighbouring lanes until its slowest
lane is done.  Row-major pixel order puts a strip of one screen row in each
block; (bh x bw) pixel blocks make a block a compact screen patch whose camera
rays walk similar parts of the tree.  The order is a pure static permutation:
ray generation enumerates pixels block-by-block and the frame buffer is
rebuilt with one reshape/transpose at frame end -- no gathers.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class PixelOrder(NamedTuple):
    rows: jnp.ndarray   # (N,) int32 absolute image row per lane
    cols: jnp.ndarray   # (N,) int32 absolute image column per lane
    height: int
    width: int
    row0: int
    block: tuple        # (bh, bw); (1, width) == row-major


def choose_block(height: int, width: int, target: int) -> tuple:
    """Pick (bh, bw) dividing (height, width) with bh*bw <= target, preferring
    large, square-ish blocks (pixels are square in angle)."""
    best = (1, width if width <= target else 1)
    best_score = -1.0
    for bh in range(1, height + 1):
        if height % bh:
            continue
        if bh > target:
            break
        for bw in range(1, width + 1):
            if width % bw or bh * bw > target:
                continue
            area = bh * bw
            aspect = min(bh, bw) / max(bh, bw)
            score = area * (0.5 + 0.5 * aspect)
            if score > best_score:
                best_score = score
                best = (bh, bw)
    return best


def make_order(
    height: int, width: int, row0: int = 0, tile: int | None = None
) -> PixelOrder:
    """Build the lane -> pixel mapping.  ``tile=None`` keeps row-major order."""
    if tile is None:
        block = (1, width)
    else:
        block = choose_block(height, width, tile)
    bh, bw = block
    nbh, nbw = height // bh, width // bw
    r = jnp.arange(height, dtype=jnp.int32)
    c = jnp.arange(width, dtype=jnp.int32)
    rows2d = jnp.broadcast_to(r[:, None], (height, width))
    cols2d = jnp.broadcast_to(c[None, :], (height, width))

    def blockify(a):
        return (
            a.reshape(nbh, bh, nbw, bw).transpose(0, 2, 1, 3).reshape(-1)
        )

    return PixelOrder(
        rows=row0 + blockify(rows2d),
        cols=blockify(cols2d),
        height=height,
        width=width,
        row0=row0,
        block=block,
    )


def image_from_flat(flat: jnp.ndarray, order: PixelOrder) -> jnp.ndarray:
    """(S, N) lane-ordered radiance -> (H, W, S) image."""
    samples = flat.shape[0]
    bh, bw = order.block
    nbh, nbw = order.height // bh, order.width // bw
    img = flat.reshape(samples, nbh, nbw, bh, bw).transpose(0, 1, 3, 2, 4)
    return img.reshape(samples, order.height, order.width).transpose(1, 2, 0)
