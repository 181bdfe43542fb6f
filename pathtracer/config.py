"""Runtime render configuration.

The reference renderer configures everything at compile time via a macro block
(reference: renderer/Raytracing.h:11-33) plus a hardcoded scene-name string
(reference: renderer/Renderer.mm:17-21).  This framework lifts every one of those
knobs into a runtime dataclass with identical defaults, so a single build serves
every configuration.

Fields are hashable/static so a ``RenderConfig`` can be passed as a static arg to
``jax.jit``.
"""

from __future__ import annotations

import dataclasses
import enum


class ComparisonMode(enum.IntEnum):
    """Golden-image comparison modes (reference: renderer/Raytracing.h:27-33)."""

    DISABLED = 0
    ABSOLUTE_VALUE = 1   # abs(color - ref)
    REF_TO_COLOR = 2     # max(0, ref - color): visible if output darker than reference
    COLOR_TO_REF = 3     # max(0, color - ref): visible if reference darker than output
    LUMINANCE = 4        # red = output brighter, green = reference brighter


class NoiseMode(enum.IntEnum):
    """Random-number supply for the integrator.

    PRNG: counter-based ``jax.random`` — independent samples per pixel, bounce and
    purpose; bit-reproducible across devices and shardings.  This fixes the
    reference's seeding reproducibility hole (wall-clock-seeded mt19937_64,
    reference: renderer/Renderer.mm:109-129).

    TILED: parity mode reproducing the reference's 64x64 float4 noise buffer and
    its tile-index reuse pattern (reference: renderer/Renderer.mm:102-129,
    renderer/Shaders.metal:91,135-138), including the correlated reuse of one
    float4 for light selection, lobe selection and bounce direction.
    """

    PRNG = 0
    TILED = 1


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # --- feature flags (defaults = reference macro block, Raytracing.h:11-33) ---
    enable_tone_mapping: bool = False      # ENABLE_TONE_MAPPING
    manual_srgb: bool = False              # MANUAL_SRGB: sRGB-encode BEFORE
    #   the comparison diff (in-shader) instead of after (framebuffer);
    #   consulted by utils/compare.blit_display
    accumulate_image: bool = True          # ACCUMULATE_IMAGE
    distance_epsilon: float = 1e-4         # DISTANCE_EPSILON
    angle_epsilon: float = 0.00003807693583  # ANGLE_EPSILON
    noise_dimensions: int = 64             # NOISE_DIMENSIONS
    animate_noise: bool = True             # ANIMATE_NOISE
    max_frames: int = 0                    # MAX_FRAMES (0 = unlimited)
    max_path_length: int = 8               # MAX_PATH_LENGTH
    # CONTENT_SCALE: the reference renders at drawable * 0.5 (Raytracing.h:25,
    # Renderer.mm:642-643).  The runtime surface takes explicit render sizes,
    # so this records the display->render ratio; the CLI's --content-scale
    # applies the reference's drawable semantics (default 1.0: sizes are the
    # render resolution).
    content_scale: float = 1.0
    comparison_mode: ComparisonMode = ComparisonMode.DISABLED
    comparison_scale: float = 10.0         # COMPARISON_SCALE
    spectrum_samples: int = 3              # SPECTRUM_SAMPLES (Spectrum.h:3)
    # Hero-wavelength spectral sampling (spectrum_samples > 3 only): each
    # path traces hero_wavelengths stratified-rotated wavelength bins instead
    # of all S, and scatter-adds them into the S-bin accumulator with weight
    # S/C — unbiased because the scene's BSDFs are non-dispersive (lobe
    # sampling is wavelength-independent).  0 disables (trace all S bins).
    hero_wavelengths: int = 0

    # --- framework extensions (no reference equivalent) ---
    noise_mode: NoiseMode = NoiseMode.PRNG
    # Uniform generation within PRNG mode: "prng" = i.i.d. counter hash;
    # "r2" = Cranley-Patterson-rotated Rd rank-1 lattice over the FRAME
    # index (ops/rng.py:uniforms_r2) - same cost, bit-deterministic, and
    # the progressive accumulator converges markedly faster on smooth
    # integrands (measured table in ARCHITECTURE.md).
    sampler: str = "prng"
    # Replicate reference estimator quirks bit-for-bit (see models/bsdf.py and
    # render/wavefront.py docstrings).  When False, uses the physically
    # conventional balance-heuristic MIS estimator instead.
    reference_quirks: bool = True
    # Snell-bent smooth-dielectric transmission (extension; the reference
    # transmits straight through with no refraction bend,
    # renderer/KernelHelpers.h:151-166).  Two-sided normals, air outside,
    # automatic TIR.  Not combinable with attach_dispersion (whose per-bin
    # reweighting is exact only for straight-through transmission).
    refract_dielectric: bool = False
    # Samples per pixel per frame (the reference always renders 1 spp/frame).
    samples_per_frame: int = 1
    # Max samples fused into ONE wavefront (PRNG noise only; 0/1 disables).
    # Fused samples share every sort/traversal launch, and the extra lane
    # density makes neighbouring sorted lanes more coherent.  Each sample
    # keys its RNG on an absolute virtual pixel id, so the image is
    # invariant to how samples are grouped or sharded.  Device memory
    # scales with the fused count.
    fuse_samples: int = 2
    # Sequential row tiles per frame on a single device (1 = whole frame at
    # once).  Each tile's wavefront is height/row_tiles of the lanes, which
    # bounds peak device memory for high fuse_samples or 4K frames.  Output
    # identical up to float summation order (absolute-pixel RNG); must
    # divide the render height.
    row_tiles: int = 1
    # Intersection backend: "bvh" (default; BVH + stackless traversal) or
    # "brute" (O(N*T) Moller-Trumbore, for testing/small scenes).
    intersector: str = "bvh"
    # Pixels per block of the camera-ray lane order (render/order.py): a
    # traversal kernel block of camera rays then covers a compact screen
    # patch (64 -> 8x8 pixels, two 32-ray kernel blocks) instead of a strip
    # of a row.
    traversal_tile: int = 64
    # BVH leaf sizes per query class: nearest-hit walks (leaf_size) and
    # range-capped occlusion walks (occlusion_leaf_size), which prune most
    # leaves by t_max.  None = share the nearest-hit layout (saves the
    # second table's memory + build).  Must stay <= 63 (leaf count packs in
    # 6 bits).  Not yet re-tuned on a GPU (ROADMAP S2).
    leaf_size: int = 56
    occlusion_leaf_size: int | None = 8
    # Bake per-material shading constants (diffuse/emissive spectra, IoR,
    # type, roughness) into per-triangle rows, so the payload resolve reads
    # them with one row gather and the per-bounce compare/select material
    # chains (ops/tables.select_cols) disappear.  Baking is exact: table
    # values are copied verbatim per triangle.  Dispersion tables
    # (mat_ior_bins) and texture ids keep their own paths.
    bake_materials: bool = False
    # Cull NEE shadow rays whose precomputed contribution is EXACTLY zero in
    # every spectrum bin — delta-lobe lanes (mirror, smooth dielectric) always
    # are, since their BSDF eval returns 0 (reference:
    # renderer/KernelHelpers.h:56-114 — the reference still traces these,
    # renderer/Shaders.metal:149-176).  Bit-exact by construction: a clear
    # shadow ray adds contrib, an occluded one adds 0, and 0 == 0; gated by a
    # full-frame equality test (tests/test_modes.py).  Default OFF; not yet
    # measured on a GPU (ROADMAP D2).
    cull_zero_nee: bool = False
    # Sort the wavefront before each secondary bounce by (alive, direction
    # octant, origin Morton cell): dead rays compact into blocks that exit
    # at once and live rays regain coherence (the BASELINE.json "sort-based
    # ray compaction").  One lax.sort carries the whole ray state as payload.
    # Applies to the BVH backends only.
    sort_rays: bool = True
    # Live-prefix ladder: after each bounce sort (dead lanes last), run the
    # whole per-bounce body (NEE resolve + traversal + shade) on the shortest
    # static power-of-two prefix that still holds every live lane, picked by
    # lax.switch on the live count, so the dense per-lane work (payload
    # gather, shade math, occlusion walk) stops paying full-width cost for
    # dead lanes.  Value = number of halvings compiled (3 -> widths N, N/2, N/4,
    # N/8); 0 disables.  Results are bit-identical: per-lane math is
    # tile-independent and dead lanes are never touched by a bounce.
    live_ladder: int = 3
    # Prefix-width bounce sorts (needs live_ladder > 0): each bounce's sort
    # runs at the rung width the PREVIOUS bounce compacted the live lanes
    # into, instead of full wavefront width — dead suffix lanes can never
    # revive, so sorting them again is pure waste.  The rung rides the
    # fori_loop carry; the stage runs at the sort's width, which trails the
    # eager ladder's rung by at most one bounce on live-count transitions.
    # Costs one compiled sort instance per rung, hence opt-in until an A/B
    # on the card says the runtime win pays for it.
    prefix_sort: bool = False
    # Bounce indices (comma-separated, 1-based loop indices in
    # [1, max_path_length)) whose wavefront sort is SKIPPED: a skipped
    # bounce reuses the previous bounce's lane order and ladder rung -- exact
    # up to fma-fusion differences across compiled rung widths (dead lanes
    # never revive, so every live lane still sits inside the last sorted
    # prefix).  The trade is a staler lane order for that bounce's walks.
    # Empty = sort every bounce (the default pipeline).
    sort_bounce_skip: str = ""
    # Wavefront-sort lowering.  "variadic" = one lax.sort carrying every
    # state plane as payload (the sort network moves the rows in place).
    # "gather" = a 3-operand argsort (key, pixel, iota) followed by one
    # jnp.take per payload plane: bit-identical output (lax.sort is stable,
    # so the iota payload IS the variadic sort's permutation), and pays the
    # permutation as gathers instead of sort-network moves.
    sort_lowering: str = "variadic"
    # Guard against 0/0 -> NaN when a sampled pdf underflows to exactly zero.
    pdf_floor: float = 1e-20
    # Progressive frames kept in flight before the host blocks: the analog of
    # the reference's triple buffering (MaxBuffersInFlight = 3,
    # reference: renderer/Renderer.mm:16,593-600).  JAX async dispatch queues
    # up to this many donated frame steps; the host syncs only when the queue
    # is full or an image/HUD read needs the data.
    frames_in_flight: int = 3

    def __post_init__(self):
        # Enum-like string knobs fail loudly on typos: a silently-ignored
        # "On"/"true" would invalidate the A/B measurement it was set for.
        checks = {
            "sampler": ("prng", "r2"),
            "intersector": ("bvh", "brute"),
            "sort_lowering": ("variadic", "gather"),
        }
        for field, allowed in checks.items():
            v = getattr(self, field)
            if v not in allowed:
                raise ValueError(f"{field}={v!r}: expected one of {allowed}")
        if self.sort_bounce_skip:
            try:
                skip = [int(x) for x in self.sort_bounce_skip.split(",")]
            except ValueError:
                raise ValueError(
                    f"sort_bounce_skip={self.sort_bounce_skip!r}: expected "
                    "comma-separated bounce indices, e.g. '1,6,7'") from None
            bad = [b for b in skip if not 1 <= b < self.max_path_length]
            if bad:
                raise ValueError(
                    f"sort_bounce_skip entries {bad} outside the bounce loop "
                    f"range [1, {self.max_path_length})")
            if self.prefix_sort:
                raise ValueError(
                    "sort_bounce_skip is incompatible with prefix_sort (the "
                    "prefix loop's rung IS its sort width)")
            if not self.sort_rays:
                # The skip set only exists inside the sorted-wavefront loop;
                # without sort_rays an A/B "with --sort-skip" measures nothing.
                raise ValueError(
                    "sort_bounce_skip requires sort_rays=True (there is no "
                    "per-bounce sort to skip otherwise)")

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


PI = 3.1415926  # reference: renderer/Raytracing.h:18 (note: float, not math.pi)
IOR_AIR = 1.00029  # initial ray IoR (reference: renderer/Shaders.metal:99)
