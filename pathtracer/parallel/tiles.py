"""Multi-device rendering: pixel-tile x sample-shard SPMD over a device mesh.

The reference is single-GPU; its only parallelism is the SIMT pixel grid
(reference: renderer/Renderer.mm:512,541,567,581).  The scaling story here
(SURVEY.md §2 "Parallelism & communication"):

  * ``tiles`` mesh axis -- data parallelism over pixel rows.  Rendering is
    embarrassingly parallel; each card owns a contiguous row-tile of the
    accumulator and no communication happens in the hot loop.
  * ``spp`` mesh axis -- sample parallelism: cards trace disjoint sample
    shards of the same tile and ``psum`` the radiance over NVLink before
    accumulation -- the only collective in the pipeline.
  * Scene/BVH buffers are replicated in device memory (<= 7k triangles:
    replication is free bandwidth-wise).

Because the RNG is counter-based on (absolute pixel, absolute sample, frame,
bounce), the distributed render matches the single-device render for any
mesh shape, up to float summation order.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import RenderConfig
from ..models.camera import Camera
from ..render.state import RenderState, accumulate, sample_sum
from ..render.wavefront import IntersectFn
from ..scene.scene import Scene


def make_mesh(n_tiles: int | None = None, n_spp: int = 1, devices=None) -> Mesh:
    """Build a ('tiles', 'spp') mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    if n_tiles is None:
        n_tiles = len(devices) // n_spp
        dropped = len(devices) - n_tiles * n_spp
        if dropped:
            import logging

            logging.getLogger(__name__).warning(
                "mesh uses %d of %d devices (%d idle: n_spp=%d does not "
                "divide the device count)",
                n_tiles * n_spp, len(devices), dropped, n_spp)
    if n_tiles < 1 or n_spp < 1:
        raise ValueError(f"mesh axes must be >= 1, got tiles={n_tiles} spp={n_spp}")
    use = n_tiles * n_spp
    if len(devices) < use:
        raise ValueError(
            f"({n_tiles} tiles x {n_spp} spp) mesh needs {use} devices, but "
            f"only {len(devices)} are available "
            f"({[d.platform for d in devices]}); for a virtual mesh set "
            "XLA_FLAGS=--xla_force_host_platform_device_count=<n> and "
            "jax.config.update('jax_platforms', 'cpu') before any device query"
        )
    dev = np.asarray(devices[:use]).reshape(n_tiles, n_spp)
    return Mesh(dev, axis_names=("tiles", "spp"))


def shard_state(state: RenderState, mesh: Mesh) -> RenderState:
    """Place the accumulator row-sharded over 'tiles', counters replicated."""
    acc = jax.device_put(
        state.accum, NamedSharding(mesh, P("tiles", None, None))
    )
    rep = NamedSharding(mesh, P())
    return RenderState(
        accum=acc,
        frame_index=jax.device_put(state.frame_index, rep),
        key=jax.device_put(state.key, rep),
    )


def render_frame_distributed(
    state: RenderState,
    scene: Scene,
    cfg: RenderConfig,
    mesh: Mesh,
    camera: Camera | None = None,
    intersect_factory=None,
) -> RenderState:
    """One progressive frame, SPMD over the mesh.  Jit with static cfg/mesh.

    ``intersect_factory``: optional ``scene -> IntersectFn`` built *inside* the
    shard (so per-shard closures see replicated scene arrays).
    """
    camera = camera if camera is not None else Camera.reference_default()
    n_tiles = mesh.shape["tiles"]
    n_spp = mesh.shape["spp"]
    full_height, full_width = state.height, state.width
    if full_height % n_tiles:
        raise ValueError(f"height {full_height} not divisible by {n_tiles} tiles")
    if cfg.samples_per_frame % n_spp:
        raise ValueError(
            f"samples_per_frame {cfg.samples_per_frame} not divisible by "
            f"{n_spp} sample shards"
        )
    tile_h = full_height // n_tiles
    shard_spp = cfg.samples_per_frame // n_spp
    # sequential row tiles WITHIN each card's row shard: same memory-bounding
    # semantics as the single-device path (render/state.render_frame),
    # applied to the per-card tile.
    row_tiles = max(1, cfg.row_tiles)
    if tile_h % row_tiles:
        raise ValueError(
            f"row_tiles {row_tiles} must divide the per-chip tile height "
            f"{tile_h} (= height {full_height} / {n_tiles} tiles)")
    sub_h = tile_h // row_tiles

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("tiles", None, None), P(), P(), P()),
        out_specs=P("tiles", None, None),
        # loop carries are initialized from shape-only constants (unvarying)
        # and become device-varying after the first bounce; skip the static
        # varying-axes check rather than pvary every carry leaf.
        check_vma=False,
    )
    def step(accum_tile, scene_rep, frame_index, key):
        tile_idx = jax.lax.axis_index("tiles")
        spp_idx = jax.lax.axis_index("spp")
        intersect: IntersectFn | None = (
            intersect_factory(scene_rep) if intersect_factory else None
        )
        total = jnp.concatenate([
            sample_sum(
                scene_rep, cfg, camera, sub_h, full_width, key, frame_index,
                intersect,
                row0=tile_idx * tile_h + r * sub_h,
                full_height=full_height,
                full_width=full_width,
                sample0=spp_idx * shard_spp,
                sample_count=shard_spp,
            )
            for r in range(row_tiles)
        ], axis=0) if row_tiles > 1 else sample_sum(
            scene_rep, cfg, camera, tile_h, full_width, key, frame_index,
            intersect,
            row0=tile_idx * tile_h,
            full_height=full_height,
            full_width=full_width,
            sample0=spp_idx * shard_spp,
            sample_count=shard_spp,
        )
        total = jax.lax.psum(total, "spp")   # the one collective (NVLink)
        color = total / cfg.samples_per_frame
        return accumulate(accum_tile, frame_index, color, cfg.accumulate_image)

    new_accum = step(state.accum, scene, state.frame_index, state.key)
    return RenderState(
        accum=new_accum, frame_index=state.frame_index + 1, key=state.key
    )


def render_frame_distributed_jit(mesh: Mesh, cfg: RenderConfig,
                                 camera: Camera | None = None,
                                 intersect_factory=None):
    """Build the jitted distributed step (donating the accumulator)."""

    @partial(jax.jit, donate_argnums=(0,))
    def step(state: RenderState, scene: Scene) -> RenderState:
        return render_frame_distributed(
            state, scene, cfg, mesh, camera=camera,
            intersect_factory=intersect_factory,
        )

    return step
