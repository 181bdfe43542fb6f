import jax
import jax.numpy as jnp
import pytest
import numpy as np

from pathtracer.ops.rng import uniforms
from pathtracer.ops.tables import select_cols
from pathtracer.render.order import choose_block, image_from_flat, make_order


def test_order_roundtrip():
    h, w = 24, 40
    order = make_order(h, w, tile=64)
    # the flat value "row*W+col" must land at pixel (row, col)
    flat = (order.rows * w + order.cols).astype(jnp.float32)[None]
    img = np.asarray(image_from_flat(flat, order))[..., 0]
    expect = np.arange(h * w, dtype=np.float32).reshape(h, w)
    np.testing.assert_array_equal(img, expect)


def test_choose_block_divides():
    for (h, w, t) in ((1080, 1920, 1536), (540, 960, 512), (75, 100, 256)):
        bh, bw = choose_block(h, w, t)
        assert h % bh == 0 and w % bw == 0 and bh * bw <= t


def test_select_cols_matches_gather():
    key = jax.random.PRNGKey(0)
    table = jax.random.normal(key, (3, 9))
    idx = jax.random.randint(jax.random.PRNGKey(1), (77,), 0, 9)
    np.testing.assert_array_equal(
        np.asarray(select_cols(table, idx)), np.asarray(table[:, idx])
    )
    one_d = jax.random.normal(key, (9,))
    np.testing.assert_array_equal(
        np.asarray(select_cols(one_d, idx)), np.asarray(one_d[idx])
    )


def test_rng_uniform_and_decorrelated():
    pid = jnp.arange(100_000, dtype=jnp.uint32)
    u = np.asarray(uniforms(pid, 3, 2, jnp.uint32(123), 6))
    assert u.shape == (6, 100_000)
    assert (u >= 0).all() and (u < 1).all()
    np.testing.assert_allclose(u.mean(axis=1), 0.5, atol=0.01)
    # distinct purposes decorrelated
    corr = np.corrcoef(u)
    off_diag = corr - np.eye(6)
    assert np.abs(off_diag).max() < 0.02


def test_rng_counter_determinism_and_sensitivity():
    pid = jnp.arange(1000, dtype=jnp.uint32)
    a = np.asarray(uniforms(pid, 1, 2, jnp.uint32(9), 4))
    b = np.asarray(uniforms(pid, 1, 2, jnp.uint32(9), 4))
    np.testing.assert_array_equal(a, b)  # pure function of counters
    c = np.asarray(uniforms(pid, 2, 2, jnp.uint32(9), 4))
    d = np.asarray(uniforms(pid, 1, 3, jnp.uint32(9), 4))
    e = np.asarray(uniforms(pid, 1, 2, jnp.uint32(10), 4))
    for other in (c, d, e):
        assert np.abs(a - other).min() > 0  # any counter change changes everything


def test_exact_ray_count_matches_probe_at_same_resolution():
    """count_traced_rays_exact (in-pipeline counters) == the probe run at
    probe_scale=1 with the same intersector (both count alive path rays +
    live shadow rays per bounce)."""
    from pathtracer.config import RenderConfig
    from pathtracer.render.stats import (
        count_traced_rays,
        count_traced_rays_exact,
    )
    from pathtracer.scene import load_scene, scene_path

    scene = load_scene(scene_path("cornellbox"))
    cfg = RenderConfig(samples_per_frame=1, max_path_length=4, intersector="brute")
    probe = count_traced_rays(scene, cfg, 48, 64, probe_scale=1)
    exact = count_traced_rays_exact(scene, cfg, 48, 64, frame_indices=(0,))
    # the probe keys RNG directly on the base key while the exact counter
    # mirrors sample_sum's per-frame/per-sample fold-ins, so paths differ
    # slightly; counts must still agree to a fraction of a percent
    assert abs(probe - exact) / exact < 0.005, (probe, exact)
    # sanity bounds: between primaries-only and the dispatch upper bound
    n = 48 * 64
    assert n <= exact <= n * (2 * cfg.max_path_length + 1)


@pytest.mark.slow
def test_exact_ray_count_invariant_to_row_tiles_and_fusion():
    """Per-lane ray counts are a pure function of each lane's absolute-pixel
    RNG stream, so the exact counter must return the SAME total however the
    lanes are grouped — untiled, row-tiled, or sample-fused (the counter
    mirrors render_frame's tiling so HBM-bounded configs can be counted at
    all)."""
    from pathtracer.config import RenderConfig
    from pathtracer.render.stats import count_traced_rays_exact
    from pathtracer.scene import load_scene, scene_path

    scene = load_scene(scene_path("cornellbox"))
    base = dict(samples_per_frame=4, max_path_length=4, intersector="brute")
    ref = count_traced_rays_exact(
        scene, RenderConfig(**base, fuse_samples=1), 48, 64)
    for cfg in (
        RenderConfig(**base, fuse_samples=4),
        RenderConfig(**base, fuse_samples=2, row_tiles=2),
        RenderConfig(**base, fuse_samples=4, row_tiles=4),
    ):
        got = count_traced_rays_exact(scene, cfg, 48, 64)
        assert got == ref, (cfg.fuse_samples, cfg.row_tiles, got, ref)


def test_r2_sampler_stratifies_and_integrates():
    """uniforms_r2: per-dim stratification near the lattice ideal over 256
    frames, and quadrature error on a smooth integrand an order of
    magnitude below i.i.d. PRNG."""
    import jax.numpy as jnp

    from pathtracer.ops.rng import uniforms, uniforms_r2

    pid = jnp.asarray([5, 77, 123456], dtype=jnp.uint32)
    us = np.stack([np.asarray(uniforms_r2(pid, f, 1, jnp.uint32(9), 6))
                   for f in range(256)])  # (256, 6, 3)
    for d in range(6):
        for p in range(3):
            x = np.sort(us[:, d, p])
            gaps = np.diff(np.concatenate([[0.0], x, [1.0]]))
            assert gaps.max() < 0.012, (d, p, gaps.max())  # iid ~ 0.022+

    # smooth 2D integrand over the aligned block (dims 0, 1):
    # E[u0*u1 + sin(pi u0)] = 0.25 + 2/pi
    truth = 0.25 + 2.0 / np.pi
    up = np.stack([np.asarray(uniforms(pid, f, 1, jnp.uint32(9), 6))
                   for f in range(256)])
    def est(a):
        return (a[:, 0] * a[:, 1] + np.sin(np.pi * a[:, 0])).mean(0)
    err_r2 = np.abs(est(us) - truth).max()
    err_pr = np.abs(est(up) - truth).max()
    assert err_r2 < 2e-3, err_r2          # lattice-grade
    assert err_r2 < err_pr / 3.0, (err_r2, err_pr)


def test_r2_sampler_render_deterministic_and_finite():
    """sampler='r2' through the full pipeline: deterministic, finite, and
    converging to the same image as PRNG (same estimator, different points)."""
    from pathtracer.config import RenderConfig
    from pathtracer.render import init_state, render_frame_jit
    from pathtracer.scene import load_scene, scene_path

    scene = load_scene(scene_path("cornellbox"))
    cfg = RenderConfig(samples_per_frame=2, max_path_length=3,
                       intersector="brute", sampler="r2")
    a = init_state(24, 32)
    b = init_state(24, 32)
    for _ in range(3):
        a = render_frame_jit(a, scene, cfg)
        b = render_frame_jit(b, scene, cfg)
    ia, ib = np.asarray(a.accum), np.asarray(b.accum)
    np.testing.assert_array_equal(ia, ib)
    assert np.isfinite(ia).all() and ia.min() >= 0.0

    # same estimator: a longer r2 run approaches the PRNG long-run image
    long_cfg = cfg.replace(samples_per_frame=8)
    pr_cfg = long_cfg.replace(sampler="prng")
    sa = init_state(24, 32)
    sb = init_state(24, 32)
    for _ in range(24):
        sa = render_frame_jit(sa, scene, long_cfg)
        sb = render_frame_jit(sb, scene, pr_cfg)
    ra, rb = np.asarray(sa.accum), np.asarray(sb.accum)
    rel = np.abs(ra - rb).mean() / max(rb.mean(), 1e-9)
    assert rel < 0.12, rel  # both are ~192-sample noisy estimates
    mean_rel = abs(ra.mean() - rb.mean()) / max(rb.mean(), 1e-9)
    # 192 samples/pixel: image-mean agreement at the few-percent level
    # (long-run means agree to 0.1-0.3%, checked offline — no bias)
    assert mean_rel < 0.03, mean_rel
