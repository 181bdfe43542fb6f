"""Progressive render state and frame stepping.

The reference's progressive state is a mutable RGBA32F texture plus a host
``_frameIndex`` counter, silently reset on resize and impossible to checkpoint
(reference: renderer/Renderer.mm:640-657, renderer/Shaders.metal:233-249).  Here
it is an explicit, checkpointable pytree — (accum, frame_index, key) — threaded
functionally through ``render_frame``; buffer donation gives the in-place
update the texture had.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import NoiseMode, RenderConfig
from ..models.camera import Camera
from ..scene.scene import Scene
from .wavefront import IntersectFn, render_sample


class RenderState(NamedTuple):
    accum: jnp.ndarray        # (H, W, S) running-mean radiance
    frame_index: jnp.ndarray  # () int32
    key: jnp.ndarray          # base PRNG key (folded per frame)

    @property
    def height(self) -> int:
        return self.accum.shape[0]

    @property
    def width(self) -> int:
        return self.accum.shape[1]


def init_state(
    height: int, width: int, seed: int = 0, samples: int = 3
) -> RenderState:
    """Fresh progressive state (the reference's drawableSizeWillChange reset,
    renderer/Renderer.mm:640-657)."""
    return RenderState(
        accum=jnp.zeros((height, width, samples), jnp.float32),
        frame_index=jnp.int32(0),
        key=jax.random.PRNGKey(seed),
    )


def accumulate(accum, frame_index, color, accumulate_image: bool):
    """Running mean: mix(color, stored, frame/(frame+1))
    (reference: renderer/Shaders.metal:233-249)."""
    if not accumulate_image:
        return color
    factor = frame_index.astype(jnp.float32) / (frame_index.astype(jnp.float32) + 1.0)
    return color + (accum - color) * jnp.where(frame_index > 0, factor, 0.0)


def frame_rng_key(cfg: RenderConfig, key: jnp.ndarray, frame_index) -> jnp.ndarray:
    """The per-frame RNG key schedule (single source of truth: sample_sum and
    the exact ray counter in render/stats.py must derive identical keys).

    With static TILED noise (reference ANIMATE_NOISE=0, Renderer.mm:485-497)
    the tile data never re-rolls across frames — only the frame-offset tile
    *lookup* (render/noise.py:_tile_lookup) varies — so the key is not folded.
    """
    if cfg.noise_mode == NoiseMode.TILED and not cfg.animate_noise:
        return key
    return jax.random.fold_in(key, frame_index)


def fuse_schedule(cfg: RenderConfig, sample_count: int):
    """(fuse, n_chunks, rem): the fused-wavefront chunk walk.  Single source
    of truth shared by sample_sum and render/stats.count_traced_rays_exact —
    chunk i traces ``fuse`` samples starting at sample0 = i*fuse, plus one
    ``rem``-sample tail; diverging copies would silently desynchronize the
    'exact' benchmark ray counts from the production RNG streams."""
    fuse = max(1, min(cfg.fuse_samples or 1, sample_count))
    n_chunks, rem = divmod(sample_count, fuse)
    return fuse, n_chunks, rem


def fused_wavefront_key(frame_key: jnp.ndarray) -> jnp.ndarray:
    """One key for every fused wavefront; fold_in(.., 0) keeps sample 0's
    streams byte-identical to the pre-fusion per-sample-fold schedule, so
    1-spp renders (goldens, self-goldens, checkpoints) are unchanged."""
    return jax.random.fold_in(frame_key, 0)


def sample_sum(
    scene: Scene,
    cfg: RenderConfig,
    camera: Camera,
    height: int,
    width: int,
    key: jnp.ndarray,
    frame_index: jnp.ndarray,
    intersect: IntersectFn | None = None,
    row0=0,
    full_height: int | None = None,
    full_width: int | None = None,
    sample0=0,
    sample_count: int | None = None,
) -> jnp.ndarray:
    """Unnormalized radiance sum over a shard of the frame's samples for a
    row-tile -> (H, W, S).

    The single-chip path sums all cfg.samples_per_frame samples of the full
    image; parallel/ gives each device a (row-tile, sample-shard) pair and
    psum-reduces over the sample axis.  Sample RNG keys on the absolute sample
    index (PRNG mode: a virtual pixel id ``pixel + abs_sample * npix``), so
    every partition traces identical paths however samples are grouped.

    PRNG mode fuses up to ``cfg.fuse_samples`` samples into one wide
    wavefront per render_sample call (see its docstring for why density
    itself buys traversal throughput); TILED parity mode keeps the
    reference-shaped one-sample-per-pass loop with per-sample key folds.
    """
    frame_key = frame_rng_key(cfg, key, frame_index)
    sample_count = cfg.samples_per_frame if sample_count is None else sample_count
    zeros = jnp.zeros((height, width, cfg.spectrum_samples), jnp.float32)

    if cfg.noise_mode == NoiseMode.PRNG:
        npix = (full_height or height) * (full_width or width)
        if cfg.samples_per_frame * npix > 2**32:
            raise ValueError(
                "samples_per_frame * pixels must fit in uint32 for the "
                "virtual-pixel-id RNG schedule"
            )
        fuse, n_chunks, rem = fuse_schedule(cfg, sample_count)
        wkey = fused_wavefront_key(frame_key)

        def run(n, s0):
            return render_sample(
                scene, cfg, camera, height, width, wkey, frame_index,
                intersect, row0, full_height, full_width,
                samples=n, sample0=s0,
            )

        total = jax.lax.fori_loop(
            0, n_chunks, lambda i, acc: acc + run(fuse, sample0 + i * fuse),
            zeros,
        ) if n_chunks else zeros
        if rem:
            total = total + run(rem, sample0 + n_chunks * fuse)
        return total

    def one_sample(i, acc):
        k = jax.random.fold_in(frame_key, sample0 + i)
        return acc + render_sample(
            scene, cfg, camera, height, width, k, frame_index, intersect,
            row0, full_height, full_width,
        )

    return jax.lax.fori_loop(0, sample_count, one_sample, zeros)


def render_frame(
    state: RenderState,
    scene: Scene,
    cfg: RenderConfig,
    camera: Camera | None = None,
    intersect: IntersectFn | None = None,
) -> RenderState:
    """One progressive frame: trace cfg.samples_per_frame spp and fold the
    mean into the accumulator.  Pure; jit with static cfg and donated state."""
    camera = camera if camera is not None else Camera.reference_default()
    height, width = state.height, state.width
    tiles = max(1, cfg.row_tiles)
    if tiles > 1 and height % tiles:
        raise ValueError(f"row_tiles {tiles} must divide height {height}")
    if tiles == 1:
        total = sample_sum(
            scene, cfg, camera, height, width, state.key, state.frame_index,
            intersect,
        )
    else:
        # sequential row tiles: each tile's wavefront is 1/tiles the lanes,
        # bounding peak device memory (high fuse_samples or 4K frames).  The
        # RNG keys on absolute pixel ids, so the image matches the untiled
        # render up to float summation order (the same bound as the
        # multi-device tile path).
        tile_h = height // tiles
        total = jnp.concatenate([
            sample_sum(
                scene, cfg, camera, tile_h, width, state.key,
                state.frame_index, intersect,
                row0=r * tile_h, full_height=height, full_width=width,
            )
            for r in range(tiles)
        ], axis=0)
    color = total / cfg.samples_per_frame
    new_accum = accumulate(state.accum, state.frame_index, color, cfg.accumulate_image)
    return RenderState(
        accum=new_accum, frame_index=state.frame_index + 1, key=state.key
    )


@partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0,))
def render_frame_jit(state: RenderState, scene: Scene, cfg: RenderConfig) -> RenderState:
    """Jitted progressive step with donated state (the equivalent of the
    reference's in-place texture update + triple-buffered async submit;
    JAX's async dispatch provides the CPU/GPU overlap the semaphore managed,
    reference: renderer/Renderer.mm:16,593-600)."""
    return render_frame(state, scene, cfg)
