import jax.numpy as jnp
import numpy as np

from pathtracer.models.camera import Camera, generate_rays


def _rays(h, w):
    jitter = jnp.full((2, h * w), 0.5)  # zero jitter (0.5 -> dudv = 0)
    o, d = generate_rays(Camera.reference_default(), h, w, jitter)
    return np.asarray(o), np.asarray(d)  # (3, N) each, row-major lanes


def _at(a, h, w, r, c):
    return a[:, r * w + c]


def test_origin_and_center_direction():
    o, d = _rays(101, 101)
    np.testing.assert_allclose(_at(o, 101, 101, 0, 0), [0.0, 1.0, 2.35], atol=1e-6)
    np.testing.assert_allclose(_at(d, 101, 101, 50, 50), [0.0, 0.0, -1.0], atol=1e-6)


def test_fov_is_90_degrees_horizontal():
    _, d = _rays(101, 101)
    # ncx = -1 at x=0 -> direction (-1, 0, -1)/sqrt(2): 45 degrees off axis
    np.testing.assert_allclose(
        _at(d, 101, 101, 50, 0), np.array([-1, 0, -1]) / np.sqrt(2), atol=1e-6
    )


def test_aspect_and_vertical_orientation():
    h, w = 51, 101
    _, d = _rays(h, w)
    top = _at(d, h, w, 0, 50)        # row 0 = top of image
    bottom = _at(d, h, w, h - 1, 50)
    assert top[1] > 0 and bottom[1] < 0  # top row looks up
    aspect = h / w
    expected_y = aspect / np.sqrt(aspect**2 + 1)
    np.testing.assert_allclose(
        top, [0, expected_y, -np.sqrt(1 - expected_y**2)], atol=1e-6
    )


def test_unit_directions():
    _, d = _rays(33, 65)
    np.testing.assert_allclose(np.linalg.norm(d, axis=0), 1.0, atol=1e-6)


def test_thin_lens_focus_plane_sharp():
    """Thin lens: rays from many lens samples through one pixel reconverge
    at the focal plane (tight spread) and diverge away from it; aperture=0
    reproduces the pinhole exactly."""
    import jax

    from pathtracer.models.camera import Camera, generate_rays_flat

    n = 4096
    rows = jnp.full((n,), 30, jnp.int32)
    cols = jnp.full((n,), 40, jnp.int32)
    jit = jnp.full((2, n), 0.5)  # pixel center
    lens = jax.random.uniform(jax.random.PRNGKey(0), (2, n))

    pin = Camera.reference_default()
    o0, d0 = generate_rays_flat(pin, rows, cols, jit, 60, 80, lens_u=lens)
    # aperture=0: identical to not passing lens uniforms at all
    o0b, d0b = generate_rays_flat(pin, rows, cols, jit, 60, 80)
    np.testing.assert_array_equal(np.asarray(o0), np.asarray(o0b))
    np.testing.assert_array_equal(np.asarray(d0), np.asarray(d0b))

    cam = Camera(t=jnp.float32(0.0), aperture=0.05, focus=2.0)
    o, d = generate_rays_flat(cam, rows, cols, jit, 60, 80, lens_u=lens)
    # lens origins spread over the aperture disk
    spread_o = np.asarray(o).std(axis=1).max()
    assert 0.01 < spread_o < 0.05
    # intersect the focal plane (distance along view = -z from the camera):
    view_t = (np.float32(2.0)) / np.asarray(-d[2])  # view = (0,0,-1) at t=0
    pts = np.asarray(o) + np.asarray(d) * view_t
    assert pts[:2].std(axis=1).max() < 1e-4  # sharp at focus
    # clearly blurred well off the focal plane
    view_t2 = np.float32(3.2) / np.asarray(-d[2])
    pts2 = np.asarray(o) + np.asarray(d) * view_t2
    # circle of confusion: aperture * |t - F| / F = 0.05*1.2/2 = 0.03
    # across the disk -> std ~ 0.015
    assert pts2[:2].std(axis=1).max() > 0.01


def test_thin_lens_render_finite_and_blurs():
    """Full pipeline with aperture: finite, deterministic, and the strongly
    defocused render differs from the pinhole one."""
    from pathtracer.config import RenderConfig
    from pathtracer.models.camera import Camera
    from pathtracer.render import init_state
    from pathtracer.render.state import render_frame
    from pathtracer.scene import load_scene, scene_path

    scene = load_scene(scene_path("cornellbox"))
    cfg = RenderConfig(samples_per_frame=4, max_path_length=2,
                       intersector="brute")
    import jax

    cam = Camera(t=jnp.float32(0.0), aperture=0.25, focus=1.0)
    step = jax.jit(lambda s: render_frame(s, scene, cfg, cam))
    step_pin = jax.jit(lambda s: render_frame(s, scene, cfg))
    a = init_state(24, 32)
    b = init_state(24, 32)
    for _ in range(3):
        a = step(a)
        b = step_pin(b)
    ia, ib = np.asarray(a.accum), np.asarray(b.accum)
    assert np.isfinite(ia).all() and ia.min() >= 0.0
    assert np.abs(ia - ib).max() > 0.02
