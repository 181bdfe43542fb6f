"""Texture sampling: PNG decode, bilinear lookup, OBJ texcoord plumbing, and
the map_Kd modulation through the full render pipeline."""

import os

import jax.numpy as jnp
import numpy as np

from pathtracer.config import RenderConfig
from pathtracer.io.png import read_png, write_png
from pathtracer.models.texture import resample_nearest, sample_bilinear
from pathtracer.render import init_state, render_frame_jit
from pathtracer.scene import load_scene


def test_png_roundtrip(tmp_path):
    img = np.random.default_rng(0).uniform(0, 1, (9, 14, 3)).astype(np.float32)
    srgb = np.where(img <= 0.0031308, img * 12.92,
                    1.055 * img ** (1 / 2.4) - 0.055)
    p = str(tmp_path / "t.png")
    write_png(p, srgb)
    back = read_png(p)
    assert back.shape == (9, 14, 3)
    assert np.abs(back - img).max() < 0.01  # 8-bit quantization


def test_bilinear_sample_centers_and_blend():
    # one 2x2 texture: texel centers return exact texel colors
    tex = jnp.asarray(np.array(
        [[[[1, 0, 0], [0, 1, 0]],
          [[0, 0, 1], [1, 1, 1]]]], np.float32))  # (1, 2, 2, 3)
    idx = jnp.zeros((5,), jnp.int32)
    # OBJ v: 0 = bottom row (row index 1)
    uv = jnp.asarray([
        [0.25, 0.75, 0.25, 0.75, 0.5],
        [0.75, 0.75, 0.25, 0.25, 0.5],
    ], jnp.float32)
    out = np.asarray(sample_bilinear(tex, idx, uv)).T
    np.testing.assert_allclose(out[0], [1, 0, 0], atol=1e-6)   # top-left
    np.testing.assert_allclose(out[1], [0, 1, 0], atol=1e-6)   # top-right
    np.testing.assert_allclose(out[2], [0, 0, 1], atol=1e-6)   # bottom-left
    np.testing.assert_allclose(out[3], [1, 1, 1], atol=1e-6)   # bottom-right
    np.testing.assert_allclose(out[4], [0.5, 0.5, 0.5], atol=1e-6)  # center
    # untextured lanes (-1) read white
    out2 = sample_bilinear(tex, jnp.asarray([-1]), uv[:, :1])
    np.testing.assert_allclose(np.asarray(out2)[:, 0], 1.0)


def test_resample_nearest():
    img = np.arange(12, dtype=np.float32).reshape(2, 2, 3)
    up = resample_nearest(img, 4, 4)
    assert up.shape == (4, 4, 3)
    np.testing.assert_array_equal(up[0, 0], img[0, 0])
    np.testing.assert_array_equal(up[3, 3], img[1, 1])


def _textured_scene(tmp_path, tex_rgb):
    """A floor quad with a map_Kd texture, lit by an emissive ceiling quad."""
    write_png(str(tmp_path / "tex.png"), tex_rgb)  # written as-is (linear-ish)
    obj = """
mtllib scene.mtl
v -2 0 -2
v  2 0 -2
v  2 0  2
v -2 0  2
v -1 3 -1
v  1 3 -1
v  1 3  1
v -1 3  1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 1 0
vn 0 -1 0
usemtl floor
f 1/1/1 2/2/1 3/3/1
f 1/1/1 3/3/1 4/4/1
usemtl lamp
f 5/1/2 7/3/2 6/2/2
f 5/1/2 8/4/2 7/3/2
"""
    mtl = """
newmtl floor
Kd 1 1 1
Ka 0 0 0
Ks 1 0 0
map_Kd tex.png
newmtl lamp
Kd 0 0 0
Ka 8 8 8
Ks 1 0 0
"""
    with open(tmp_path / "scene.obj", "w") as fh:
        fh.write(obj)
    with open(tmp_path / "scene.mtl", "w") as fh:
        fh.write(mtl)
    return load_scene(str(tmp_path / "scene.obj"))


def test_textured_scene_loads_and_modulates(tmp_path):
    # red left half, blue right half
    tex = np.zeros((8, 8, 3), np.float32)
    tex[:, :4, 0] = 1.0
    tex[:, 4:, 2] = 1.0
    srgb = np.where(tex <= 0.0031308, tex * 12.92,
                    1.055 * np.maximum(tex, 1e-9) ** (1 / 2.4) - 0.055)
    scene = _textured_scene(tmp_path, srgb)
    assert scene.textures is not None and scene.textures.shape[0] == 1
    assert scene.tri_uv is not None and scene.tri_uv.shape == (6, 4)
    assert np.asarray(scene.mat_tex).tolist() == [0, -1]

    cfg = RenderConfig(samples_per_frame=8, max_path_length=3,
                       intersector="brute")
    state = init_state(32, 32)
    for _ in range(4):
        state = render_frame_jit(state, scene, cfg)
    img = np.asarray(state.accum)
    assert np.isfinite(img).all()
    # camera at (0,1,2.35) looking -z over the floor: left pixels see the
    # red half (u<0.5 -> x<0), right pixels the blue half
    bottom = img[-10:]
    left, right = bottom[:, :12], bottom[:, -12:]
    assert left[..., 0].mean() > 5 * left[..., 2].mean() + 1e-6
    assert right[..., 2].mean() > 5 * right[..., 0].mean() + 1e-6


def test_untextured_scenes_unchanged(tmp_path):
    """A texture of all ones must not change the image at all."""
    ones = np.ones((4, 4, 3), np.float32)
    scene_t = _textured_scene(tmp_path, ones)  # sRGB(1.0) == 1.0
    scene_p = scene_t._replace(textures=None, mat_tex=None, tri_uv=None)
    cfg = RenderConfig(samples_per_frame=4, max_path_length=2,
                       intersector="brute")
    a = render_frame_jit(init_state(16, 16), scene_t, cfg)
    b = render_frame_jit(init_state(16, 16), scene_p, cfg)
    np.testing.assert_allclose(
        np.asarray(a.accum), np.asarray(b.accum), atol=1e-6
    )


def test_missing_texture_falls_back_untextured(tmp_path):
    """A map_Kd pointing at a missing/undecodable file must warn and render
    untextured, not make the scene unloadable (the reference ignores
    textures entirely; renderer/Renderer.mm:365-369)."""
    obj = """
mtllib m.mtl
v -2 0 -2
v  2 0 -2
v  2 0  2
vt 0 0
vt 1 0
vt 1 1
vn 0 1 0
usemtl floor
f 1/1/1 2/2/1 3/3/1
"""
    mtl = """
newmtl floor
Kd 0.5 0.5 0.5
Ka 0 0 0
Ks 1 0 0
map_Kd does_not_exist.png
"""
    with open(tmp_path / "m.obj", "w") as fh:
        fh.write(obj)
    with open(tmp_path / "m.mtl", "w") as fh:
        fh.write(mtl)
    scene = load_scene(str(tmp_path / "m.obj"))
    assert scene.textures is None and scene.mat_tex is None
    # a corrupt PNG (wrong magic) must degrade the same way
    with open(tmp_path / "bad.png", "wb") as fh:
        fh.write(b"not a png at all")
    with open(tmp_path / "m.mtl", "w") as fh:
        fh.write(mtl.replace("does_not_exist.png", "bad.png"))
    scene = load_scene(str(tmp_path / "m.obj"))
    assert scene.textures is None and scene.mat_tex is None


def _encode_png_with_filters(img_u8: np.ndarray, filters):
    """Minimal PNG encoder applying a given filter type per row (test-only:
    exercises every defilter branch of read_png against a known image)."""
    import struct
    import zlib

    h, w, ch = img_u8.shape
    assert len(filters) == h
    rows = img_u8.astype(np.int32)
    raw = bytearray()
    prev = np.zeros((w, ch), np.int32)
    for r, ft in enumerate(filters):
        cur = rows[r]
        left = np.zeros_like(cur)
        left[1:] = cur[:-1]
        pleft = np.zeros_like(prev)
        pleft[1:] = prev[:-1]
        if ft == 0:
            enc = cur
        elif ft == 1:
            enc = cur - left
        elif ft == 2:
            enc = cur - prev
        elif ft == 3:
            enc = cur - ((left + prev) >> 1)
        else:  # Paeth
            pa = np.abs(prev - pleft)
            pb = np.abs(left - pleft)
            pc = np.abs(left + prev - 2 * pleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, pleft))
            enc = cur - pred
        raw.append(ft)
        raw.extend((enc & 0xFF).astype(np.uint8).tobytes())
        prev = cur

    def chunk(tag, payload):
        body = tag + payload
        return (struct.pack(">I", len(payload)) + body
                + struct.pack(">I", zlib.crc32(body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


def test_read_png_all_filter_types(tmp_path):
    """Decode correctness for every PNG filter type (0/Sub/Up/Average/Paeth),
    including the vectorized Sub/Up paths and the bytearray Average/Paeth
    recurrence."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (20, 13, 3), np.uint8)
    filters = [0, 1, 2, 3, 4] * 4
    p = str(tmp_path / "filters.png")
    with open(p, "wb") as fh:
        fh.write(_encode_png_with_filters(img, filters))
    got = read_png(p)
    srgb = img.astype(np.float32) / 255.0
    want = np.where(srgb <= 0.04045, srgb / 12.92,
                    ((srgb + 0.055) / 1.055) ** 2.4)
    np.testing.assert_allclose(got, want.astype(np.float32), atol=1e-6)
