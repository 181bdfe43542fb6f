"""Environment-light correctness: alias sampler distribution (chi-square),
sampler/evaluator consistency, MIS energy (furnace test), and pipeline wiring.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.config import RenderConfig
from pathtracer.models.envlight import build_env, eval_env, sample_env
from pathtracer.render import init_state, render_frame_jit
from pathtracer.scene import attach_env, load_scene, scene_path


def _test_map(eh=16, ew=32, seed=3):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.05, 1.0, (eh, ew, 3)).astype(np.float32)
    img[4, 7] = 40.0  # a hot texel: importance sampling must favor it
    return img


def test_alias_table_chi_square():
    """Sampled texel counts must follow pdf_map (chi-square over K texels)."""
    img = _test_map()
    env = build_env(img, select_p=1.0)
    eh, ew = env.pdf_sa.shape
    k = eh * ew
    n = 400_000
    u = jax.random.uniform(jax.random.PRNGKey(0), (3, n))
    d, _, _ = sample_env(env, u[0], u[1:3])
    # recover the texel from the direction (nearest-texel convention)
    _, pdf = eval_env(env, d)
    # bin by texel index via the same mapping eval_env uses
    phi = jnp.arctan2(d[2], d[0])
    uu = (phi + np.pi) / (2 * np.pi)
    uu = uu - jnp.floor(uu)
    vv = jnp.arccos(jnp.clip(d[1], -1, 1)) / np.pi
    j = jnp.clip((uu * ew).astype(jnp.int32), 0, ew - 1)
    i = jnp.clip((vv * eh).astype(jnp.int32), 0, eh - 1)
    counts = np.bincount(np.asarray(i * ew + j), minlength=k)

    # expected from the builder's texel pdf
    theta_edges = np.linspace(0, np.pi, eh + 1)
    domega = (2 * np.pi / ew) * (np.cos(theta_edges[:-1]) - np.cos(theta_edges[1:]))
    lum = img @ np.asarray([0.2126, 0.7152, 0.0722], np.float32)
    w = lum * domega[:, None]
    p = (w / w.sum()).reshape(-1)
    expected = p * n
    chi2 = ((counts - expected) ** 2 / np.maximum(expected, 1e-9)).sum()
    # dof = K - 1 = 511; 99.9th percentile ~ 627
    assert chi2 < 640.0, chi2


def test_sample_eval_pdf_consistent():
    """eval_env at a sampled direction returns the sampler's pdf/radiance."""
    env = build_env(_test_map(), select_p=1.0)
    u = jax.random.uniform(jax.random.PRNGKey(1), (3, 4096))
    d, pdf_s, rad_s = sample_env(env, u[0], u[1:3])
    rad_e, pdf_e = eval_env(env, d)
    np.testing.assert_allclose(np.asarray(pdf_s), np.asarray(pdf_e), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(rad_s), np.asarray(rad_e), rtol=1e-5)


def test_pdf_integrates_to_one():
    """Sum over texels of pdf_sa * texel solid angle == 1."""
    env = build_env(_test_map())
    eh, ew = env.pdf_sa.shape
    theta_edges = np.linspace(0, np.pi, eh + 1)
    domega = (2 * np.pi / ew) * (np.cos(theta_edges[:-1]) - np.cos(theta_edges[1:]))
    total = (np.asarray(env.pdf_sa) * domega[:, None]).sum()
    np.testing.assert_allclose(total, 1.0, rtol=1e-5)


def _obj_scene(obj: str, mtl: str, name: str):
    """Write an OBJ/MTL pair to a temp dir and load it (test scene builder)."""
    import tempfile

    d = tempfile.mkdtemp()
    with open(f"{d}/{name}.obj", "w") as fh:
        fh.write(obj)
    with open(f"{d}/{name}.mtl", "w") as fh:
        fh.write(mtl)
    return load_scene(f"{d}/{name}.obj")


def _furnace_scene():
    """A single diffuse floor quad, no area lights, under a constant env."""
    obj = """
mtllib furnace.mtl
v -50 0 -50
v  50 0 -50
v  50 0  50
v -50 0  50
vn 0 1 0
usemtl floor
f 1//1 2//1 3//1
f 1//1 3//1 4//1
"""
    mtl = """
newmtl floor
Kd 0.5 0.5 0.5
Ka 0 0 0
Ks 1 0 0
"""
    return _obj_scene(obj, mtl, "furnace")


@pytest.mark.parametrize("quirks", [True, False])
def test_furnace_energy(quirks):
    """Diffuse albedo-0.5 floor under a constant unit env: every floor pixel
    must converge to 0.5 (NEE + BSDF-arm MIS bookkeeping is unbiased), and
    sky pixels to 1.0."""
    scene = _furnace_scene()
    scene = attach_env(scene, np.ones((8, 16, 3), np.float32))
    assert float(scene.env.select_p) == 1.0  # no area lights
    cfg = RenderConfig(
        samples_per_frame=8, max_path_length=6, intersector="brute",
        reference_quirks=quirks,
    )
    state = init_state(24, 32)
    for _ in range(8):
        state = render_frame_jit(state, scene, cfg)
    img = np.asarray(state.accum)
    assert np.isfinite(img).all()
    # camera looks level at the horizon: top rows are sky, bottom rows floor
    sky = img[:6]
    floor = img[-8:]
    np.testing.assert_allclose(sky.mean(), 1.0, rtol=0.02)
    np.testing.assert_allclose(floor.mean(), 0.5, rtol=0.05)
    # per-pixel, not just on average
    assert np.abs(floor - 0.5).max() < 0.12


def test_env_render_cornellbox_wiring():
    """Env-lit cornellbox: runs through the full production pipeline (sorted
    wavefront, deferred NEE pack) with finite output and more energy than the
    env-less render."""
    scene = load_scene(scene_path("cornellbox"))
    lit = attach_env(scene, 0.5 * np.ones((8, 16, 3), np.float32))
    assert 0.1 <= float(lit.env.select_p) <= 0.9
    cfg = RenderConfig(samples_per_frame=4, max_path_length=4)
    s_base = render_frame_jit(init_state(24, 32), scene, cfg)
    s_env = render_frame_jit(init_state(24, 32), lit, cfg)
    base = np.asarray(s_base.accum)
    env = np.asarray(s_env.accum)
    assert np.isfinite(env).all()
    assert env.mean() > base.mean() * 1.05


def test_env_deterministic_and_mesh_invariant():
    """Env sampling keys on the counter RNG: same seed -> identical images."""
    scene = attach_env(
        load_scene(scene_path("cornellbox")), _test_map(), strength=0.3
    )
    cfg = RenderConfig(samples_per_frame=2, max_path_length=3)
    a = render_frame_jit(init_state(16, 24), scene, cfg)
    b = render_frame_jit(init_state(16, 24), scene, cfg)
    np.testing.assert_array_equal(np.asarray(a.accum), np.asarray(b.accum))


def _small_quad_scene(half=2.0):
    """A small diffuse quad: below-horizon shadow rays escape past its edge."""
    obj = f"""
mtllib quad.mtl
v -{half} 0 -{half}
v  {half} 0 -{half}
v  {half} 0  {half}
v -{half} 0  {half}
vn 0 1 0
usemtl floor
f 1//1 2//1 3//1
f 1//1 3//1 4//1
"""
    mtl = """
newmtl floor
Kd 0.5 0.5 0.5
Ka 0 0 0
Ks 1 0 0
"""
    return _obj_scene(obj, mtl, "quad")


def test_env_below_horizon_no_negative_radiance():
    """Env radiance concentrated just BELOW the quad's horizon must add
    exactly zero to the quad, never negative: below-horizon env NEE lanes
    are cos-gated out of the estimator (the signed diffuse eval cos/pi < 0
    would otherwise multiply a huge escaped-ray env sample)."""
    img = 0.001 * np.ones((16, 32, 3), np.float32)
    img[8, :] = 200.0  # hot band at cos(theta) in (-0.2, 0]: below horizon
    lit = attach_env(_small_quad_scene(), img)
    cfg = RenderConfig(
        samples_per_frame=8, max_path_length=2, intersector="brute"
    )
    state = init_state(24, 32)
    for _ in range(16):
        state = render_frame_jit(state, lit, cfg)
    out = np.asarray(state.accum)
    assert np.isfinite(out).all()
    assert out.min() >= 0.0, out.min()


def _big_light_scene():
    """Diffuse floor under a LARGE close emissive ceiling: BSDF-bounce rays
    hit the light often and its solid-angle pdf is comparable to the bsdf
    pdf, so the BSDF-arm MIS weight materially shapes the image (the regime
    where a selection-probability mismatch between the two arms shows)."""
    obj = """
mtllib biglight.mtl
v -2 0 -2
v  2 0 -2
v  2 0  2
v -2 0  2
v -2 1.5 -2
v  2 1.5 -2
v  2 1.5  2
v -2 1.5  2
vn 0 1 0
vn 0 -1 0
usemtl floor
f 1//1 2//1 3//1
f 1//1 3//1 4//1
usemtl lamp
f 5//2 7//2 6//2
f 5//2 8//2 7//2
"""
    mtl = """
newmtl floor
Kd 0.5 0.5 0.5
Ka 0 0 0
Ks 1 0 0
newmtl lamp
Kd 0 0 0
Ka 1 1 1
Ks 1 0 0
"""
    return _obj_scene(obj, mtl, "biglight")


def test_env_select_p_invariance_with_area_lights():
    """The unified {area, env} one-sample-MIS estimator must be invariant to
    select_p: BOTH MIS arms carry the selection-scaled densities.  (A
    BSDF-arm emit_lpdf missing its (1 - select_p) factor makes the two
    weights sum below 1 and darkens area-light direct lighting by up to
    ~17% at select_p=0.75 on this scene.)

    Attaching a BLACK env must also reproduce the env-less image exactly.
    Runs with reference_quirks=False: the reference's *pdf emitter quirk
    (renderer/Shaders.metal:189) deliberately scales one MIS arm, so only
    the quirk-free estimator is exactly selection-invariant."""
    scene = _big_light_scene()
    cfg = RenderConfig(
        samples_per_frame=8, max_path_length=3, intersector="brute",
        reference_quirks=False,
    )

    def run(sc, frames=96):
        state = init_state(24, 32)
        for _ in range(frames):
            state = render_frame_jit(state, sc, cfg)
        return np.asarray(state.accum)

    base = run(scene)
    black = np.full((8, 16, 3), 1e-9, np.float32)
    for sp in (0.25, 0.75):
        img = run(attach_env(scene, black, select_p=sp))
        # floor rows carry all the area direct light; the old bug showed
        # here as -4.5% (sp .25) to -17% (sp .75)
        np.testing.assert_allclose(
            img[-10:].mean(), base[-10:].mean(), rtol=0.004
        )
