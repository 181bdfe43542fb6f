import os

import pytest
import numpy as np

from pathtracer.config import RenderConfig
from pathtracer.io.checkpoint import load_checkpoint, save_checkpoint
from pathtracer.io.png import write_png
from pathtracer.renderer import Renderer

TINY = dict(width=32, height=24)
CFG = RenderConfig(samples_per_frame=2, max_path_length=3, intersector="brute")


def test_renderer_progressive_and_hud():
    r = Renderer("cornellbox", cfg=CFG, **TINY)
    r.run(3)
    assert r.frame_index == 3
    img = r.image()
    assert img.shape == (24, 32, 3)
    assert np.isfinite(img).all() and img.max() > 0
    assert "Frame: 3" in r.hud() and "Mrays/s" in r.hud()


def test_renderer_max_frames_gate():
    r = Renderer("cornellbox", cfg=CFG.replace(max_frames=2), **TINY)
    r.run(5)
    assert r.frame_index == 2  # reference: MAX_FRAMES gate (Renderer.mm:589-591)


def test_checkpoint_resume(tmp_path):
    r = Renderer("cornellbox", cfg=CFG, **TINY)
    r.run(2)
    path = str(tmp_path / "ckpt.npz")
    r.save_checkpoint(path)
    r.run(2)
    after4 = r.image()

    r2 = Renderer("cornellbox", cfg=CFG, **TINY)
    r2.load_checkpoint(path)
    assert r2.frame_index == 2
    r2.run(2)
    np.testing.assert_array_equal(r2.image(), after4)  # bit-exact resume


def test_save_outputs(tmp_path):
    r = Renderer("cornellbox", cfg=CFG, **TINY)
    r.run(1)
    exr = str(tmp_path / "out.exr")
    png = str(tmp_path / "out.png")
    r.save_exr(exr)
    r.save_png(png)
    from pathtracer.io.exr import read_exr

    back, _ = read_exr(exr)
    np.testing.assert_allclose(back, r.image(), atol=2e-2)  # half precision
    assert os.path.getsize(png) > 100
    with open(png, "rb") as fh:
        assert fh.read(8) == b"\x89PNG\r\n\x1a\n"


def test_reset_is_drawable_size_change(tmp_path):
    r = Renderer("cornellbox", cfg=CFG, **TINY)
    r.run(2)
    r.reset(width=16, height=8)
    assert r.frame_index == 0
    assert r.image().shape == (8, 16, 3)


def test_cli_smoke(tmp_path):
    from pathtracer.cli import main

    out = str(tmp_path / "cli.exr")
    rc = main([
        "--scene", "cornellbox", "--width", "32", "--height", "24",
        "--frames", "2", "--depth", "3", "--intersector", "brute",
        "--hud-every", "0", "-o", out,
    ])
    assert rc == 0 and os.path.exists(out)


def test_cli_resume_shape_mismatch(tmp_path):
    """--resume with a checkpoint at a different resolution must fail loudly
    instead of silently overriding --width/--height."""
    from pathtracer.cli import main

    ckpt = str(tmp_path / "c.npz")
    r = Renderer("cornellbox", cfg=CFG, **TINY)
    r.run(1)
    r.save_checkpoint(ckpt)
    rc = main([
        "--scene", "cornellbox", "--width", "64", "--height", "48",
        "--frames", "1", "--depth", "3", "--intersector", "brute",
        "--resume", ckpt,
    ])
    assert rc == 2


def test_frames_in_flight_async_equals_sync():
    """K frames queued asynchronously produce the same image as blocking
    every frame (the reference's triple-buffering, Renderer.mm:16,593-600)."""
    r_async = Renderer("cornellbox", cfg=CFG.replace(frames_in_flight=3), **TINY)
    r_sync = Renderer("cornellbox", cfg=CFG.replace(frames_in_flight=1), **TINY)
    r_async.run(5)
    r_sync.run(5)
    assert r_async.frame_index == r_sync.frame_index == 5
    np.testing.assert_array_equal(r_async.image(), r_sync.image())
    # max_frames gate still counts queued frames correctly
    r_gate = Renderer(
        "cornellbox", cfg=CFG.replace(frames_in_flight=3, max_frames=4), **TINY
    )
    r_gate.run(9)
    assert r_gate.frame_index == 4


def test_cli_content_scale(tmp_path):
    """--content-scale renders at drawable*s like the reference's
    CONTENT_SCALE (Renderer.mm:642-643)."""
    from pathtracer.cli import main
    from pathtracer.io.exr import read_exr

    out = str(tmp_path / "half.exr")
    rc = main([
        "--scene", "cornellbox", "--width", "128", "--height", "96",
        "--content-scale", "0.5", "--frames", "1", "--depth", "2",
        "--intersector", "brute", "-o", out,
    ])
    assert rc == 0
    img, _ = read_exr(out)
    assert img.shape == (48, 64, 3)


def test_checkpoint_resume_orbax(tmp_path):
    # Orbax backend (directory checkpoints, per-shard writes for large or
    # multi-host-sharded accumulators) round-trips bit-exactly, same as npz.
    pytest.importorskip("orbax.checkpoint")
    r = Renderer("cornellbox", cfg=CFG, **TINY)
    r.run(2)
    path = str(tmp_path / "ckpt_orbax")  # no .npz suffix -> orbax
    r.save_checkpoint(path)
    r.run(2)
    after4 = r.image()

    r2 = Renderer("cornellbox", cfg=CFG, **TINY)
    r2.load_checkpoint(path)
    assert r2.frame_index == 2
    r2.run(2)
    np.testing.assert_array_equal(r2.image(), after4)


def test_checkpoint_orbax_sharded_accumulator(tmp_path):
    """Orbax saves a MESH-SHARDED accumulator without a host gather and
    restores it into a fresh (unsharded) state bit-exactly — the multi-host
    checkpoint story (parallel/multihost.py) in miniature on the virtual
    8-device CPU mesh."""
    pytest.importorskip("orbax.checkpoint")
    from pathtracer.io.checkpoint import load_checkpoint, save_checkpoint
    from pathtracer.parallel.tiles import make_mesh, shard_state
    from pathtracer.render import init_state

    mesh = make_mesh(8, 1)
    state = init_state(32, 16)
    state = state._replace(
        accum=state.accum + np.arange(32, dtype=np.float32)[:, None, None],
        frame_index=state.frame_index + 7,
    )
    sharded = shard_state(state, mesh)
    assert len(sharded.accum.sharding.device_set) == 8
    path = str(tmp_path / "ckpt_sharded")
    save_checkpoint(path, sharded)
    back = load_checkpoint(path)
    np.testing.assert_array_equal(np.asarray(back.accum),
                                  np.asarray(state.accum))
    assert int(back.frame_index) == 7
    import jax

    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(back.key)),
        np.asarray(jax.random.key_data(state.key)),
    )


def test_downsample_upscale_no_nan():
    """Regression: target dims larger than the source (the default 960x540
    render vs 800x600 goldens) left empty bins -> NaN columns."""
    from pathtracer.utils.compare import downsample

    src = np.random.default_rng(3).random((600, 800, 3)).astype(np.float32)
    for h, w in [(540, 960), (1080, 1920), (700, 640), (300, 400)]:
        out = downsample(src, h, w)
        assert out.shape == (h, w, 3)
        assert np.isfinite(out).all(), (h, w)
    # pure shrink stays an exact box mean
    np.testing.assert_allclose(
        downsample(src, 300, 400),
        src.reshape(300, 2, 400, 2, 3).mean(axis=(1, 3)), rtol=1e-6)


def test_metrics_masked_golden_nan():
    """A non-finite golden pixel must not leak NaN into rel_mse."""
    from pathtracer.utils.compare import metrics

    img = np.ones((16, 16, 3))
    gold = np.ones((16, 16, 3))
    gold[3, 4, 1] = np.nan
    m = metrics(img, gold)
    assert np.isfinite(m["rel_mse"]) and np.isfinite(m["rmse"])
