"""Capability coverage: tiled-noise parity mode, comparison modes, spectral
S>3 rendering, tonemap/sRGB display path."""

import numpy as np
import pytest

from pathtracer.config import ComparisonMode, NoiseMode, RenderConfig
from pathtracer.core import spectrum as spec
from pathtracer.core.color import to_linear, to_srgb, tonemap_exposure
from pathtracer.renderer import Renderer
from pathtracer.utils.compare import comparison_image

TINY = dict(width=32, height=24)


def _render(cfg, frames=2):
    r = Renderer("cornellbox", cfg=cfg, **TINY)
    r.run(frames)
    return r.image()


def test_tiled_noise_mode_renders_same_scene():
    base = RenderConfig(samples_per_frame=2, max_path_length=3, intersector="brute")
    prng = _render(base, frames=4)
    tiled = _render(base.replace(noise_mode=NoiseMode.TILED), frames=4)
    assert np.isfinite(tiled).all()
    # statistically the same image: the reference's correlated 64x64 noise
    # changes variance, not the mean
    assert abs(tiled.mean() / prng.mean() - 1.0) < 0.25


def test_spectral_s8_collapses_to_rgb():
    cfg = RenderConfig(
        samples_per_frame=2, max_path_length=3, intersector="brute",
        spectrum_samples=8,
    )
    r = Renderer("cornellbox", cfg=cfg, **TINY)
    r.run(3)
    img8 = np.asarray(spec.to_rgb(r.state.accum))
    rgb = _render(
        RenderConfig(samples_per_frame=2, max_path_length=3, intersector="brute"),
        frames=3,
    )
    assert img8.shape == rgb.shape
    # same scene, different wavelength discretization: energies agree loosely
    assert abs(img8.mean() / rgb.mean() - 1.0) < 0.2


def test_spectrum_roundtrip():
    rgb = np.array([[0.2, 0.5, 0.8], [1.0, 0.0, 0.5]], np.float32)
    for s in (3, 8, 16):
        spec_v = spec.from_rgb(rgb, s)
        back = np.asarray(spec.to_rgb(spec_v))
        np.testing.assert_allclose(back, rgb, atol=1e-6)


def test_comparison_modes_match_blit_shader():
    rng = np.random.default_rng(0)
    color = rng.random((8, 8, 3)).astype(np.float32)
    ref = rng.random((8, 8, 3)).astype(np.float32)
    assert np.allclose(
        comparison_image(color, ref, ComparisonMode.ABSOLUTE_VALUE, 10.0),
        np.abs(color - ref) * 10.0,
    )
    assert np.allclose(
        comparison_image(color, ref, ComparisonMode.REF_TO_COLOR, 10.0),
        np.maximum(0, ref - color) * 10.0,
    )
    assert np.allclose(
        comparison_image(color, ref, ComparisonMode.COLOR_TO_REF, 10.0),
        np.maximum(0, color - ref) * 10.0,
    )
    lum = comparison_image(color, ref, ComparisonMode.LUMINANCE, 10.0)
    lc, lr = color.mean(-1), ref.mean(-1)  # dot(c, 1/3) per the reference
    assert np.allclose(lum[..., 0], np.maximum(0, lc - lr) * 10.0, atol=1e-6)
    assert np.allclose(lum[..., 1], np.maximum(0, lr - lc) * 10.0, atol=1e-6)
    assert (lum[..., 2] == 0).all()
    assert np.array_equal(
        comparison_image(color, ref, ComparisonMode.DISABLED), color
    )


def test_blit_display_manual_srgb_ordering():
    """MANUAL_SRGB moves the sRGB encode across the comparison diff.

    Reference semantics (Shaders.metal:47-51 vs Renderer.mm:88-94): identical
    pixels in normal display, different pixels in comparison modes (manual =
    diff of sRGB-encoded color, displayed raw; hardware = diff of linear
    color, sRGB-encoded by the framebuffer).
    """
    from pathtracer.utils.compare import blit_display

    rng = np.random.default_rng(1)
    color = rng.random((6, 6, 3)).astype(np.float32)
    ref = rng.random((6, 6, 3)).astype(np.float32)

    plain_hw = blit_display(color, ref, ComparisonMode.DISABLED, tonemap=True)
    plain_manual = blit_display(color, ref, ComparisonMode.DISABLED,
                                tonemap=True, manual_srgb=True)
    np.testing.assert_allclose(plain_hw, plain_manual, atol=1e-6)

    diff_hw = blit_display(color, ref, ComparisonMode.ABSOLUTE_VALUE, 10.0)
    diff_manual = blit_display(color, ref, ComparisonMode.ABSOLUTE_VALUE, 10.0,
                               manual_srgb=True)
    assert not np.allclose(diff_hw, diff_manual, atol=1e-3)

    # exact pipelines, re-derived independently
    def srgb(v):
        v = np.clip(v, 0.0, 1.0)
        return np.where(v < 0.0031308, 12.92 * v,
                        1.055 * np.power(v, 1 / 2.4) - 0.055)

    np.testing.assert_allclose(
        diff_hw, np.clip(srgb(np.abs(color - ref) * 10.0), 0, 1), atol=1e-5)
    np.testing.assert_allclose(
        diff_manual, np.clip(np.abs(srgb(color) - ref) * 10.0, 0, 1), atol=1e-5)


def test_srgb_roundtrip_and_tonemap():
    import jax.numpy as jnp

    v = jnp.linspace(0.0, 1.0, 64)
    np.testing.assert_allclose(
        np.asarray(to_linear(to_srgb(v))), np.asarray(v), atol=1e-5
    )
    tm = np.asarray(tonemap_exposure(jnp.array([0.0, 1.0, 100.0])))
    assert tm[0] == 0.0 and tm[2] <= 1.0 and 0.6 < tm[1] < 0.7


def test_display_path_flags():
    cfg = RenderConfig(
        samples_per_frame=1, max_path_length=2, intersector="brute",
        enable_tone_mapping=True,
    )
    r = Renderer("cornellbox", cfg=cfg, **TINY)
    r.run(1)
    out = r.image(tonemapped=True)
    assert (out >= 0).all() and (out <= 1).all()


def test_animate_noise_off_freezes_tile_data():
    """ANIMATE_NOISE=0 parity: tile data is frame-independent, so frames 0 and
    1 (whose tile-lookup offsets frame//3, frame//5 coincide) trace identical
    samples; with animation on they differ (reference: Renderer.mm:485-497)."""
    import jax
    import jax.numpy as jnp

    from pathtracer.models.camera import Camera
    from pathtracer.render.state import sample_sum
    from pathtracer.scene import load_scene, scene_path

    scene = load_scene(scene_path("cornellbox"))
    cam = Camera.reference_default()
    key = jax.random.PRNGKey(3)

    def frame_img(cfg, fi):
        return np.asarray(
            sample_sum(scene, cfg, cam, 16, 16, key, jnp.int32(fi))
        )

    static = RenderConfig(
        samples_per_frame=1, max_path_length=2, intersector="brute",
        noise_mode=NoiseMode.TILED, animate_noise=False,
    )
    assert np.array_equal(frame_img(static, 0), frame_img(static, 1))
    animated = static.replace(animate_noise=True)
    assert not np.array_equal(frame_img(animated, 0), frame_img(animated, 1))


def test_spectral_save_collapses_to_rgb(tmp_path):
    from pathtracer.io.exr import read_exr

    cfg = RenderConfig(
        samples_per_frame=1, max_path_length=2, intersector="brute",
        spectrum_samples=8,
    )
    r = Renderer("cornellbox", cfg=cfg, **TINY)
    r.run(1)
    exr = str(tmp_path / "s8.exr")
    png = str(tmp_path / "s8.png")
    r.save_exr(exr)
    r.save_png(png)
    img, channels = read_exr(exr)
    assert channels == ["R", "G", "B"]
    assert img.shape == (TINY["height"], TINY["width"], 3)
    expect = np.asarray(spec.to_rgb(r.state.accum))
    np.testing.assert_allclose(img, expect, atol=2e-3)


def test_hero_wavelength_matches_full_spectral():
    """Hero sampling (C of S bins per path, weight S/C) must estimate the
    same image as tracing all S bins; with the bundled non-dispersive
    materials the per-bin means converge to the same values."""
    import jax

    from pathtracer.models.camera import Camera
    from pathtracer.render.state import sample_sum
    from pathtracer.scene import load_scene, scene_path

    scene = load_scene(scene_path("cornellbox"), samples=8)
    cam = Camera.reference_default()
    key = jax.random.PRNGKey(1)

    base = RenderConfig(
        samples_per_frame=6, max_path_length=3, intersector="brute",
        spectrum_samples=8,
    )
    full = np.asarray(sample_sum(scene, base, cam, 24, 32, key, 0)) / 6
    hero = np.asarray(
        sample_sum(
            scene, base.replace(hero_wavelengths=2), cam, 24, 32, key, 0
        )
    ) / 6
    assert np.isfinite(hero).all()
    assert hero.shape == full.shape == (24, 32, 8)
    # same estimator target; hero has extra variance at 6 spp
    assert abs(hero.mean() / full.mean() - 1.0) < 0.08
    # per-band energies agree loosely too
    for s in range(8):
        assert abs(hero[..., s].mean() / full[..., s].mean() - 1.0) < 0.25


def test_hero_wavelength_sorted_pipeline():
    """Hero bins must survive the shadow-carrying wavefront sort (pure-JAX
    BVH intersector exercises the same sorted pipeline on CPU)."""
    cfg = RenderConfig(
        samples_per_frame=2, max_path_length=3,
        spectrum_samples=8, hero_wavelengths=4,
    )
    r = Renderer("cornellbox", cfg=cfg, **TINY)
    r.run(2)
    img = r.state.accum
    assert img.shape == (TINY["height"], TINY["width"], 8)
    assert np.isfinite(img).all() and img.max() > 0
    # unsorted brute render of the same config agrees statistically
    r2 = Renderer("cornellbox", cfg=cfg.replace(intersector="brute"), **TINY)
    r2.run(2)
    np.testing.assert_allclose(np.asarray(img), np.asarray(r2.state.accum),
                               rtol=1e-4, atol=1e-5)


def test_tiled_noise_structure_matches_reference():
    """Structural (not statistical) TILED parity: the 64x64 tile is reused
    with the reference's offset formula and intra-bounce component swizzles
    (reference: renderer/Shaders.metal:91,135-138,152-159,204)."""
    import jax
    import jax.numpy as jnp

    from pathtracer.render.noise import (
        _tile,
        _tile_lookup,
        bounce_uniforms,
        camera_jitter,
    )

    cfg = RenderConfig(noise_mode=NoiseMode.TILED, noise_dimensions=64)
    key = jax.random.PRNGKey(5)
    H, W = 96, 128
    rows = jnp.arange(0, H, 7, dtype=jnp.int32)
    cols = jnp.arange(0, len(rows) * 9, 9, dtype=jnp.int32) % W
    pids = rows.astype(jnp.uint32) * W + cols.astype(jnp.uint32)
    frame = jnp.int32(7)
    bounce = jnp.int32(2)

    u = bounce_uniforms(cfg, key, frame, bounce, pids, H, W)
    tile = _tile(cfg, key, bounce)
    smp = np.asarray(_tile_lookup(cfg, tile, frame, bounce, rows, cols, H))

    # reference swizzles: light_select = .z, light_bary = .wx, lobe = .y,
    # bounce_dir = .zw — including the correlated reuse of z and w
    np.testing.assert_array_equal(np.asarray(u["light_select"]), smp[:, 2])
    np.testing.assert_array_equal(np.asarray(u["light_bary"][0]), smp[:, 3])
    np.testing.assert_array_equal(np.asarray(u["light_bary"][1]), smp[:, 0])
    np.testing.assert_array_equal(np.asarray(u["lobe"]), smp[:, 1])
    np.testing.assert_array_equal(np.asarray(u["bounce_dir"][0]), smp[:, 2])
    np.testing.assert_array_equal(np.asarray(u["bounce_dir"][1]), smp[:, 3])

    # tile-index formula: ((x + b + f/3) % 64, (y_bottom_up + b + f/5) % 64)
    nd = 64
    t = np.asarray(tile)
    y = (H - 1) - np.asarray(rows)
    ix = (np.asarray(cols) + 2 + 7 // 3) % nd
    iy = (y + 2 + 7 // 5) % nd
    np.testing.assert_array_equal(smp, t[ix + iy * nd])

    # pixels exactly 64 apart share samples (the reference's correlation)
    if W > 64:
        r2 = jnp.array([3, 3], jnp.int32)
        c2 = jnp.array([5, 69], jnp.int32)
        p2 = r2.astype(jnp.uint32) * W + c2.astype(jnp.uint32)
        u2 = bounce_uniforms(cfg, key, frame, bounce, p2, H, W)
        np.testing.assert_array_equal(
            np.asarray(u2["lobe"])[0], np.asarray(u2["lobe"])[1]
        )

    # camera jitter uses the camera tile's .xy with no frame offset
    cj = np.asarray(camera_jitter(cfg, key, frame, pids, H, W))
    cam_tile = np.asarray(_tile(cfg, key, -1))
    jx = np.asarray(cols) % nd
    jy = ((H - 1) - np.asarray(rows)) % nd
    np.testing.assert_array_equal(cj[0], cam_tile[jx + jy * nd][:, 0])
    np.testing.assert_array_equal(cj[1], cam_tile[jx + jy * nd][:, 1])


@pytest.mark.slow
def test_live_prefix_ladder_matches_full_width():
    # The ladder (RenderConfig.live_ladder) runs each bounce on the shortest
    # static prefix covering every live lane; per-lane math is width- and
    # tile-independent, so the image matches full-width to the last ulp (XLA
    # fuses fma chains differently at different static widths, so exact
    # bitwise equality is not guaranteed — observed max delta ~5e-7).
    base = RenderConfig(
        samples_per_frame=1, max_path_length=6, intersector="bvh",
        live_ladder=0,
    )
    cfg_l = base.replace(live_ladder=3)
    size = dict(width=128, height=96)
    r0 = Renderer("cornellbox", cfg=base, **size)
    r0.run(2)
    r1 = Renderer("cornellbox", cfg=cfg_l, **size)
    r1.run(2)
    a, b = r0.image(), r1.image()
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, atol=2e-6, rtol=1e-5)
    # the overwhelming majority of pixels are exactly equal
    assert (a == b).mean() > 0.9


@pytest.mark.slow
def test_prefix_sort_matches_full_width_sorts():
    # cfg.prefix_sort runs each bounce's wavefront sort at the rung width the
    # previous bounce compacted the live lanes into, instead of full width.
    # Dead suffix lanes never revive and every lane's radiance is keyed by
    # its unique pixel id, so the image matches the full-width-sort ladder
    # up to XLA's width-dependent fma fusion (same tolerance as the ladder
    # equivalence test above).
    base = RenderConfig(
        samples_per_frame=1, max_path_length=6, intersector="bvh",
        live_ladder=3,
    )
    size = dict(width=128, height=96)
    r0 = Renderer("cornellbox", cfg=base, **size)
    r0.run(2)
    r1 = Renderer("cornellbox", cfg=base.replace(prefix_sort=True), **size)
    r1.run(2)
    a, b = np.asarray(r0.image()), np.asarray(r1.image())
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, atol=2e-6, rtol=1e-5)
    assert (a == b).mean() > 0.9


@pytest.mark.slow
def test_prefix_sort_hero_and_fused():
    # prefix_sort's rung-width sort must carry every payload plane the
    # full-width sort carries: the (C, N) hero-bin plane (scatter-add image
    # assembly) and fused-sample lanes (virtual pixel ids spanning spp
    # copies of the frame).  Both compare against the eager-ladder pipeline.
    size = dict(width=128, height=96)
    hero = RenderConfig(
        samples_per_frame=1, max_path_length=5, spectrum_samples=8,
        hero_wavelengths=4, live_ladder=3,
    )
    fused = RenderConfig(
        samples_per_frame=2, fuse_samples=2, max_path_length=5,
        intersector="bvh", live_ladder=3,
    )
    for base in (hero, fused):
        r0 = Renderer("cornellbox", cfg=base, **size)
        r0.run(2)
        r1 = Renderer("cornellbox", cfg=base.replace(prefix_sort=True), **size)
        r1.run(2)
        a, b = np.asarray(r0.image()), np.asarray(r1.image())
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, atol=2e-6, rtol=1e-5)


@pytest.mark.slow
def test_live_prefix_ladder_with_hero_bins():
    # Ladder slicing must also carry the (C, N) hero-bin plane and the
    # scatter-add image assembly; compare against the full-width pipeline.
    base = RenderConfig(
        samples_per_frame=1, max_path_length=5, spectrum_samples=8,
        hero_wavelengths=4, live_ladder=0,
    )
    size = dict(width=128, height=96)
    r0 = Renderer("cornellbox", cfg=base, **size)
    r0.run(2)
    r1 = Renderer("cornellbox", cfg=base.replace(live_ladder=3), **size)
    r1.run(2)
    a, b = np.asarray(r0.image()), np.asarray(r1.image())
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, atol=2e-6, rtol=1e-5)


def test_fused_samples_match_per_sample_loop():
    # PRNG sample fusion: spp traced as ONE wide wavefront must equal the
    # per-sample loop exactly — both draw from the same absolute
    # virtual-pixel-id counter streams, only the wavefront grouping differs.
    base = RenderConfig(samples_per_frame=4, max_path_length=4)
    size = dict(width=48, height=32)
    r0 = Renderer("cornellbox", cfg=base.replace(fuse_samples=1), **size)
    r0.run(2)
    r1 = Renderer("cornellbox", cfg=base.replace(fuse_samples=4), **size)
    r1.run(2)
    a, b = np.asarray(r0.image()), np.asarray(r1.image())
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-5)


def test_fused_samples_odd_chunking():
    # spp=5 with fuse=2 exercises the 2+2+1 chunk schedule
    base = RenderConfig(samples_per_frame=5, max_path_length=3)
    size = dict(width=32, height=24)
    r0 = Renderer("cornellbox", cfg=base.replace(fuse_samples=1), **size)
    r0.run(1)
    r1 = Renderer("cornellbox", cfg=base.replace(fuse_samples=2), **size)
    r1.run(1)
    np.testing.assert_allclose(
        np.asarray(r0.image()), np.asarray(r1.image()), atol=1e-6, rtol=1e-5
    )


def test_fused_samples_hero_spectral():
    # fusion + hero-wavelength scatter accumulation compose
    base = RenderConfig(samples_per_frame=2, max_path_length=3,
                        spectrum_samples=8, hero_wavelengths=4)
    size = dict(width=32, height=24)
    r0 = Renderer("cornellbox", cfg=base.replace(fuse_samples=1), **size)
    r0.run(1)
    r1 = Renderer("cornellbox", cfg=base.replace(fuse_samples=2), **size)
    r1.run(1)
    a, b = np.asarray(r0.image()), np.asarray(r1.image())
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-5)


@pytest.mark.slow
def test_row_tiles_bit_identical():
    """cfg.row_tiles renders the frame in sequential row tiles; output is
    identical up to float summation order (same bound as the multi-chip
    path), bounding peak HBM."""
    import numpy as np

    from pathtracer.config import RenderConfig
    from pathtracer.render import init_state, render_frame_jit
    from pathtracer.scene import load_scene, scene_path

    scene = load_scene(scene_path("cornellbox"))
    base = RenderConfig(samples_per_frame=2, max_path_length=3)
    a = init_state(24, 32)
    b = init_state(24, 32)
    c = init_state(24, 32)
    for _ in range(2):
        a = render_frame_jit(a, scene, base)
        b = render_frame_jit(b, scene, base.replace(row_tiles=4))
        c = render_frame_jit(c, scene, base.replace(row_tiles=24))
    np.testing.assert_allclose(np.asarray(a.accum), np.asarray(b.accum),
                               atol=2e-6)
    np.testing.assert_allclose(np.asarray(a.accum), np.asarray(c.accum),
                               atol=2e-6)

    import pytest

    with pytest.raises(ValueError, match="row_tiles"):
        render_frame_jit(init_state(25, 32), scene, base.replace(row_tiles=4))


@pytest.mark.slow
def test_gather_sort_lowering_full_frame_identical():
    # cfg.sort_lowering="gather" replaces the variadic bounce sort with an
    # argsort + per-plane gathers; lax.sort stability makes the permutation
    # identical, so the whole frame must match BIT-FOR-BIT (no fma-fusion
    # tolerance needed: the same values flow through the same shade math).
    base = RenderConfig(
        samples_per_frame=1, max_path_length=6, intersector="bvh",
        live_ladder=2,
    )
    size = dict(width=128, height=96)
    r0 = Renderer("cornellbox", cfg=base, **size)
    r0.run(2)
    r1 = Renderer("cornellbox", cfg=base.replace(sort_lowering="gather"), **size)
    r1.run(2)
    a, b = np.asarray(r0.image()), np.asarray(r1.image())
    assert np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)


@pytest.mark.slow
def test_sort_bounce_skip_matches_default():
    # cfg.sort_bounce_skip: a skipped bounce reuses the previous bounce's
    # lane order and ladder rung.  Exact because dead lanes never revive —
    # every live lane still sits inside the last sorted prefix — so the only
    # permitted deltas are fma-fusion differences across rung widths (the
    # skipped bounce may run a wider compiled branch than the eager ladder
    # would pick).  Skips at the loop's first and last bounce exercise both
    # the idx carry init and the stale-rung reuse.
    base = RenderConfig(
        samples_per_frame=1, max_path_length=6, intersector="bvh",
        live_ladder=2,
    )
    size = dict(width=128, height=96)
    r0 = Renderer("cornellbox", cfg=base, **size)
    r0.run(2)
    r1 = Renderer(
        "cornellbox", cfg=base.replace(sort_bounce_skip="1,4,5"), **size
    )
    r1.run(2)
    a, b = np.asarray(r0.image()), np.asarray(r1.image())
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, atol=2e-6, rtol=1e-5)


def test_sort_bounce_skip_validation():
    with pytest.raises(ValueError, match="sort_bounce_skip"):
        RenderConfig(sort_bounce_skip="0")
    with pytest.raises(ValueError, match="sort_bounce_skip"):
        RenderConfig(sort_bounce_skip="8", max_path_length=8)
    with pytest.raises(ValueError, match="sort_bounce_skip"):
        RenderConfig(sort_bounce_skip="1;2")
    with pytest.raises(ValueError, match="prefix_sort"):
        RenderConfig(sort_bounce_skip="1", prefix_sort=True)
    RenderConfig(sort_bounce_skip="1,7", max_path_length=8)  # valid


@pytest.mark.slow
def test_gather_sort_lowering_with_prefix_sort():
    # The attractive combination: prefix_sort compiles one sort instance per
    # ladder rung, and the gather lowering makes each instance near-free to
    # compile.  Must still match the eager full-width variadic pipeline
    # (same tolerance as the prefix-sort equivalence test: XLA's fma fusion
    # differs across widths).
    base = RenderConfig(
        samples_per_frame=1, max_path_length=5, intersector="bvh",
        live_ladder=2,
    )
    size = dict(width=96, height=64)
    r0 = Renderer("cornellbox", cfg=base, **size)
    r0.run(2)
    r1 = Renderer(
        "cornellbox",
        cfg=base.replace(prefix_sort=True, sort_lowering="gather"),
        **size,
    )
    r1.run(2)
    a, b = np.asarray(r0.image()), np.asarray(r1.image())
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, atol=2e-6, rtol=1e-5)


@pytest.mark.slow
def test_cull_zero_nee_bit_identical():
    # cfg.cull_zero_nee skips occlusion walks for shadow rays whose
    # precomputed NEE contribution is exactly zero in every bin (delta-lobe
    # lanes: the mirror sphere here).  A clear shadow ray adds contrib and an
    # occluded one adds 0, so culling a contrib==0 lane changes nothing; the
    # wavefront sort's KEY planes don't involve light_ok, so the lane order
    # (and therefore every fma grouping) is unchanged -> bitwise equality.
    base = RenderConfig(
        samples_per_frame=1, max_path_length=5, intersector="bvh",
        live_ladder=2, cull_zero_nee=False,
    )
    size = dict(width=96, height=64)
    r0 = Renderer("CornellBox-Water-plastic", cfg=base, **size)
    r0.run(2)
    r1 = Renderer(
        "CornellBox-Water-plastic", cfg=base.replace(cull_zero_nee=True),
        **size,
    )
    r1.run(2)
    a, b = np.asarray(r0.image()), np.asarray(r1.image())
    assert np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)
