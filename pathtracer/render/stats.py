"""Render statistics: honest traced-ray accounting.

The reference HUD divides dispatch size by frame time
(reference: renderer/Renderer.mm:631-637), which under-reports work by the
bounce count and over-reports it by the dead-ray fraction.  This module counts
rays the traversal actually processes (path rays alive at each bounce + active
shadow rays), probed at reduced resolution and scaled.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..models.camera import Camera, generate_rays_flat
from ..render.noise import bounce_uniforms, camera_jitter, pids_from_order
from ..render.order import make_order
from ..render.wavefront import (
    initial_path_state,
    make_brute_intersector,
    trace_bounce,
)
from ..scene.scene import Scene


@partial(jax.jit, static_argnames=("cfg", "height", "width"))
def _probe(scene: Scene, cfg: RenderConfig, height: int, width: int, key):
    frame = jnp.int32(0)
    order = make_order(height, width)
    pids = pids_from_order(order, width)
    jitter = camera_jitter(cfg, key, frame, pids, height, width)
    origins, directions = generate_rays_flat(
        Camera.reference_default(), order.rows, order.cols, jitter, height, width
    )
    state = initial_path_state(origins, directions, cfg.spectrum_samples, pids)
    intersect = make_brute_intersector(scene)
    total = jnp.zeros((), jnp.float32)
    for b in range(cfg.max_path_length):  # unrolled: python loop, static depth
        uniforms = bounce_uniforms(
            cfg, key, frame, b, pids, height, width,
            with_env=scene.env is not None,
        )
        state, stats = trace_bounce(
            scene, cfg, intersect, jnp.int32(b), state, uniforms, with_stats=True
        )
        total = total + stats["path"].astype(jnp.float32) + stats["shadow"].astype(jnp.float32)
    return total


def count_traced_rays(
    scene: Scene, cfg: RenderConfig, height: int, width: int, probe_scale: int = 4
) -> float:
    """Estimated rays traced per frame at (height, width), 1 spp: probes at
    1/probe_scale resolution with the brute intersector and scales by area.
    Prefer :func:`count_traced_rays_exact` for benchmark numerators."""
    ph = max(height // probe_scale, 8)
    pw = max(width // probe_scale, 8)
    probe = float(_probe(scene, cfg, ph, pw, jax.random.PRNGKey(0)))
    scale = (height * width) / (ph * pw)
    return probe * scale * cfg.samples_per_frame


def count_traced_rays_exact(
    scene: Scene,
    cfg: RenderConfig,
    height: int,
    width: int,
    frame_indices=(0,),
    intersect=None,
    camera: Camera | None = None,
    seed: int = 0,
) -> float:
    """EXACT rays traced for the given frame indices, averaged per frame.

    Runs the production pipeline (same RNG key schedule as
    render/state.py:sample_sum) with in-pipeline alive/shadow counters —
    no resolution scaling, no estimator.
    """
    from ..render.state import frame_rng_key, fuse_schedule, fused_wavefront_key
    from ..render.wavefront import render_sample

    camera = camera or Camera.reference_default()

    from ..config import NoiseMode

    # Mirror render_frame's sequential row tiling (render/state.py): the
    # per-lane ray counts are invariant to how lanes are grouped into
    # wavefronts (alive progression is a pure function of the lane's
    # absolute-pixel RNG stream), but the PEAK memory is not -- counting a
    # memory-bounded config through one untiled wavefront would OOM the very
    # config row_tiles exists to make fit.
    tiles = max(1, cfg.row_tiles)
    if tiles > 1 and height % tiles:
        tiles = 1
    tile_h = height // tiles

    @partial(jax.jit, static_argnames=())
    def one_frame(key, fi):
        frame_key = frame_rng_key(cfg, key, fi)
        total = jnp.float32(0)
        tile_kw = [
            dict(row0=r * tile_h, full_height=height, full_width=width)
            for r in range(tiles)
        ]
        if cfg.noise_mode == NoiseMode.PRNG:
            # the SAME schedule helpers sample_sum uses (render/state.py)
            fuse, n_chunks, rem = fuse_schedule(cfg, cfg.samples_per_frame)
            wkey = fused_wavefront_key(frame_key)
            chunks = [(fuse, i * fuse) for i in range(n_chunks)]
            if rem:
                chunks.append((rem, n_chunks * fuse))
            for kw in tile_kw:
                for m, s0 in chunks:
                    _, c = render_sample(
                        scene, cfg, camera, tile_h, width, wkey, fi,
                        intersect, with_ray_count=True, samples=m,
                        sample0=s0, **kw,
                    )
                    total = total + c
            return total
        for kw in tile_kw:
            for s in range(cfg.samples_per_frame):
                k = jax.random.fold_in(frame_key, s)
                _, c = render_sample(
                    scene, cfg, camera, tile_h, width, k, fi, intersect,
                    with_ray_count=True, **kw,
                )
                total = total + c
        return total

    key = jax.random.PRNGKey(seed)
    counts = [float(one_frame(key, jnp.int32(f))) for f in frame_indices]
    return sum(counts) / len(counts)


def first_secondary_wavefront(
    scene: Scene,
    cfg: RenderConfig,
    height: int,
    width: int,
    intersect=None,
    camera: Camera | None = None,
    seed: int = 0,
    frame_index: int = 0,
):
    """Reconstruct the frame's FIRST secondary wavefront — the bounce-1 path
    rays plus their deferred NEE shadow pack, sorted exactly as the
    production loop sorts them (render/wavefront.py:render_sample).  This is
    the canonical incoherent workload the traversal tuning targets.

    The sort runs under the "gather" lowering -- bit-identical lane order to
    the production variadic sort (lax.sort is stable).
    """
    from ..render.state import frame_rng_key, fused_wavefront_key
    from ..render.wavefront import (
        initial_path_state,
        make_brute_intersector,
        scene_sort_bounds,
        sort_wavefront,
        trace_bounce,
    )

    camera = camera or Camera.reference_default()
    if intersect is None:
        intersect = make_brute_intersector(scene)
    fi = jnp.int32(frame_index)
    wkey = fused_wavefront_key(frame_rng_key(cfg, jax.random.PRNGKey(seed), fi))

    tile = cfg.traversal_tile if cfg.intersector == "bvh" else None
    order = make_order(height, width, 0, tile)
    pids = pids_from_order(order, width)
    cam_key = jax.random.fold_in(wkey, 0xC0FFEE)
    jitter = camera_jitter(cfg, cam_key, fi, pids, height, width)
    origins, directions = generate_rays_flat(
        camera, order.rows, order.cols, jitter[0:2], height, width,
        lens_u=jitter[2:4],
    )
    state = initial_path_state(origins, directions, cfg.spectrum_samples, pids)
    uniforms = bounce_uniforms(
        cfg, wkey, fi, jnp.int32(0), pids, height, width,
        with_env=scene.env is not None,
    )
    state, pack = trace_bounce(
        scene, cfg, intersect, jnp.int32(0), state, uniforms,
        defer_shadow=True,
    )
    wmin, winv = scene_sort_bounds(scene)
    return sort_wavefront(state, wmin, winv, pack, lowering="gather")
