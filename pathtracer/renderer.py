"""Host orchestrator: progressive renderer with HUD, save, and checkpointing.

The JAX counterpart of the reference's ``Renderer`` Objective-C++ class
(reference: renderer/Renderer.mm): owns scene buffers + acceleration structure,
drives the jitted frame step, tracks the EMA performance HUD
(reference: renderer/Renderer.mm:631-637), and implements the image-save the
reference left as an empty stub (reference: renderer/Renderer.mm:626-629).
"""

from __future__ import annotations

import time
from functools import partial

import jax
import numpy as np

from .accel import build_layout
from .config import RenderConfig
from .models.camera import Camera
from .render.state import RenderState, init_state, render_frame
from .render.wavefront import make_intersector
from .scene import Scene, load_scene, scene_path
from .scene.assets import DEFAULT_SCENE


class Renderer:
    def __init__(
        self,
        scene: Scene | str = DEFAULT_SCENE,
        width: int = 960,
        height: int = 540,
        cfg: RenderConfig | None = None,
        seed: int = 0,
        camera: Camera | None = None,
        leaf_size: int | None = None,
        builder: str = "auto",
        mesh=None,
        traverse=None,
    ):
        """``mesh``: a ('tiles','spp') jax.sharding.Mesh (parallel/tiles.py
        make_mesh) -- the frame step shards pixel rows over 'tiles' and
        sample shards over 'spp' (psum across devices), bit-identical to the
        single-device render.  None = single device.

        ``traverse`` replaces the platform's BVH traversal (a test seam of
        render/wavefront.py make_intersector); None keeps the platform's."""
        self.cfg = cfg or RenderConfig()
        self.scene = (
            scene if isinstance(scene, Scene)
            else load_scene(scene_path(scene), samples=self.cfg.spectrum_samples)
        )
        self.camera = camera or Camera.reference_default()
        leaf = leaf_size if leaf_size is not None else self.cfg.leaf_size
        occl_leaf = self.cfg.occlusion_leaf_size
        self.layout = (
            None if self.cfg.intersector == "brute"
            else build_layout(self.scene, leaf_size=leaf, builder=builder,
                              bake_materials=self.cfg.bake_materials)
        )
        # occlusion queries get their own (small-leaf) layout when configured
        self.layout_occl = (
            build_layout(self.scene, leaf_size=occl_leaf, builder=builder)
            if self.layout is not None and occl_leaf not in (None, leaf)
            else None
        )
        self._intersect = make_intersector(
            self.scene, self.cfg, self.layout, self.layout_occl, traverse
        )
        self._seed = seed

        cfg_ = self.cfg
        camera_ = self.camera
        intersect_ = self._intersect
        self.mesh = mesh

        if mesh is not None:
            from .parallel.tiles import render_frame_distributed_jit

            # each shard gets the SAME intersection pipeline the single-chip
            # path uses (BVH layouts ride in as replicated closure constants;
            # without a factory the distributed step falls back to brute)
            layout_, layout_occl_ = self.layout, self.layout_occl

            def _factory(scene_rep):
                return make_intersector(scene_rep, cfg_, layout_, layout_occl_,
                                        traverse)

            self._step = render_frame_distributed_jit(
                mesh, self.cfg, camera=camera_, intersect_factory=_factory
            )
        else:
            @partial(jax.jit, donate_argnums=(0,))
            def _step(state: RenderState, scene: Scene) -> RenderState:
                return render_frame(state, scene, cfg_, camera_, intersect_)

            self._step = _step
        self.reset(width, height)

    # -- reference: mtkView:drawableSizeWillChange: (Renderer.mm:640-657) --
    def reset(self, width: int | None = None, height: int | None = None) -> None:
        width = width or self.state.width
        height = height or self.state.height
        self.state = init_state(height, width, self._seed, self.cfg.spectrum_samples)
        if self.mesh is not None:
            from .parallel.tiles import shard_state

            self.state = shard_state(self.state, self.mesh)
        self._avg_rays_per_sec = 0.0
        self._avg_frame_time = 0.0
        self._frame_count = 0        # host-side count (device state lags when async)
        self._in_flight = 0
        self._window_t0 = None       # wall-clock start of the in-flight window

    @property
    def frame_index(self) -> int:
        """Frames *completed and visible* (syncs in-flight work first)."""
        self.sync()
        return int(self.state.frame_index)

    def sync(self) -> None:
        """Block until every queued frame step has executed on device, and
        fold the elapsed window into the HUD EMA."""
        if self._in_flight == 0:
            return
        jax.block_until_ready(self.state.frame_index)
        dt = time.perf_counter() - self._window_t0
        frame_time = dt / self._in_flight
        pixels = self.state.height * self.state.width
        # EMA-smoothed HUD, same blend as the reference (Renderer.mm:631-637)
        for _ in range(self._in_flight):
            self._avg_rays_per_sec = 0.5 * (
                self._avg_rays_per_sec + pixels / frame_time
            )
            self._avg_frame_time = 0.5 * (self._avg_frame_time + frame_time)
        self._in_flight = 0
        self._window_t0 = None

    def step(self) -> None:
        """Queue one progressive frame (respects cfg.max_frames like the
        reference's MAX_FRAMES gate, renderer/Renderer.mm:589-591).

        Up to ``cfg.frames_in_flight`` steps run asynchronously before the
        host blocks — the reference's semaphore-throttled triple buffering
        (renderer/Renderer.mm:16,593-600), expressed as JAX async dispatch
        over donated state.
        """
        if self.cfg.max_frames and self._frame_count >= self.cfg.max_frames:
            return
        if self._window_t0 is None:
            self._window_t0 = time.perf_counter()
        self.state = self._step(self.state, self.scene)
        self._frame_count += 1
        self._in_flight += 1
        if self._in_flight >= max(1, self.cfg.frames_in_flight):
            self.sync()

    def run(self, frames: int) -> None:
        for _ in range(frames):
            self.step()
        self.sync()

    def hud(self) -> str:
        """Window-title HUD string (reference: renderer/Renderer.mm:636-637)."""
        return (
            f"Frame: {self.frame_index} "
            f"[{self._avg_rays_per_sec / 1e6:0.2f} Mrays/s, "
            f"{self._avg_frame_time * 1e3:.2f} ms/frame]"
        )

    def image(self, tonemapped: bool = False, rgb: bool = False) -> np.ndarray:
        """(H, W, S) accumulated radiance (optionally display-transformed).

        ``rgb`` collapses spectral accumulators (S > 3) to 3-channel RGB via
        the band-averaged downsample in core/spectrum.py.
        """
        self.sync()
        img = np.asarray(self.state.accum)
        if rgb and img.shape[-1] != 3:
            from .core.spectrum import to_rgb

            img = np.asarray(to_rgb(img))
        if tonemapped:
            from .core.color import to_srgb, tonemap_exposure

            if self.cfg.enable_tone_mapping:
                img = np.asarray(tonemap_exposure(img))
            img = np.asarray(to_srgb(img))
        return img

    # -- the reference's saveCurrentImage is an unimplemented stub; here it works --
    def save_exr(self, path: str) -> None:
        from .io.exr import write_exr

        write_exr(path, self.image(rgb=True), half=True)

    def save_png(self, path: str) -> None:
        from .io.png import write_png

        write_png(path, self.image(tonemapped=True, rgb=True))

    def save_checkpoint(self, path: str) -> None:
        from .io.checkpoint import save_checkpoint

        self.sync()
        save_checkpoint(path, self.state)

    def load_checkpoint(self, path: str) -> None:
        from .io.checkpoint import load_checkpoint

        self.sync()
        self.state = load_checkpoint(path)
        if self.mesh is not None:
            from .parallel.tiles import shard_state

            self.state = shard_state(self.state, self.mesh)
        self._frame_count = int(self.state.frame_index)
        self._in_flight = 0
        self._window_t0 = None

    def profile(self, trace_dir: str, frames: int = 3) -> None:
        """Capture a device profile of the frame step (the counterpart of the
        reference's Xcode GPU-capture debug groups, renderer/Renderer.mm:505);
        view with TensorBoard or xprof."""
        with jax.profiler.trace(trace_dir):
            self.run(frames)
