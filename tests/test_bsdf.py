import jax
import jax.numpy as jnp
import numpy as np

from pathtracer.config import PI
from pathtracer.core.math3d import dot, reflect
from pathtracer.models import bsdf

N_UP = jnp.array([[0.0], [0.0], [1.0]])


def test_fresnel_normal_incidence():
    # R0 = ((n1-n2)/(n1+n2))^2
    i = jnp.array([[0.0], [0.0], [1.0]])
    got = float(bsdf.fresnel(N_UP, i, 1.0, 1.5)[0])
    assert np.isclose(got, ((1.0 - 1.5) / (1.0 + 1.5)) ** 2, rtol=1e-5)


def test_fresnel_grazing_and_tir():
    # grazing incidence -> ~1
    i = jnp.array([[1.0], [0.0], [1e-4]])
    i = i / jnp.linalg.norm(i)
    assert float(bsdf.fresnel(N_UP, i, 1.0, 1.5)[0]) > 0.99
    # total internal reflection going from dense to sparse past critical angle
    i = jnp.array([[0.9], [0.0], [np.sqrt(1 - 0.81)]])
    assert float(bsdf.fresnel(N_UP, i, 1.5, 1.0)[0]) == 1.0


def test_reflect_matches_metal_semantics():
    i = jnp.array([[1.0], [0.0], [-1.0]]) / np.sqrt(2.0)  # incoming, toward surface
    r = reflect(i, N_UP)
    assert np.allclose(
        np.asarray(r), np.array([[1.0], [0.0], [1.0]]) / np.sqrt(2), atol=1e-6
    )


def _scalar_eval(mtype, ior, w_i, w_o, lobe_u):
    out = bsdf.eval_material(
        jnp.int32(mtype), jnp.float32(ior),
        jnp.asarray(w_i, jnp.float32).reshape(3, 1),
        jnp.asarray(w_o, jnp.float32).reshape(3, 1), N_UP,
        jnp.float32(lobe_u), 3.807693583e-5,
    )
    return float(out[0][0]), float(out[1][0])


def test_eval_diffuse():
    w_o = np.array([0.0, 0.6, 0.8], np.float32)
    b, p = _scalar_eval(bsdf.MATERIAL_DIFFUSE, 0.0, [0, 0, -1], w_o, 0.5)
    assert np.isclose(b, 0.8 / PI, rtol=1e-5)
    assert b == p  # reference quirk: bsdf == pdf for the diffuse lobe


def test_eval_mirror_only_in_mirror_direction():
    w_i = np.array([1.0, 0.0, -1.0], np.float32) / np.sqrt(2)
    w_mirror = np.array([1.0, 0.0, 1.0], np.float32) / np.sqrt(2)
    b, p = _scalar_eval(bsdf.MATERIAL_MIRROR, 0.0, w_i, w_mirror, 0.5)
    assert np.isclose(b, w_mirror[2], rtol=1e-5) and p == 1.0
    b, p = _scalar_eval(bsdf.MATERIAL_MIRROR, 0.0, w_i, [0.0, 0.6, 0.8], 0.5)
    assert b == 0.0 and p == 1.0


def test_eval_dielectric_transmission_is_zero():
    # lobe_u above fresnel -> transmission branch -> bsdf = pdf = 0
    w_i = np.array([0.0, 0.0, -1.0], np.float32)
    b, p = _scalar_eval(bsdf.MATERIAL_SMOOTH_DIELECTRIC, 1.5, w_i, [0, 0.6, 0.8], 0.99)
    assert b == 0.0 and p == 0.0


def test_sample_bounce_mirror():
    w_i = jnp.array([[1.0], [0.0], [-1.0]]) / np.sqrt(2.0)
    w_o, b, p, ior, _ = bsdf.sample_bounce(
        jnp.int32(bsdf.MATERIAL_MIRROR), jnp.float32(0.0), w_i, N_UP,
        jnp.float32(0.5), jnp.array([[0.3], [0.7]]), jnp.float32(1.00029),
    )
    assert np.allclose(np.asarray(w_o), np.asarray(reflect(w_i, N_UP)), atol=1e-6)
    assert float(p[0]) == 1.0
    assert np.isclose(float(b[0]), float(dot(w_o, N_UP)[0]), rtol=1e-6)
    assert float(ior[0]) == np.float32(1.00029)


def test_sample_bounce_dielectric_transmission_passes_straight_through():
    w_i = jnp.array([[0.0], [0.6], [-0.8]])
    # lobe_u = 1.0 > fresnel -> transmit
    w_o, b, p, ior, _ = bsdf.sample_bounce(
        jnp.int32(bsdf.MATERIAL_SMOOTH_DIELECTRIC), jnp.float32(1.5), w_i, N_UP,
        jnp.float32(1.0), jnp.array([[0.3], [0.7]]), jnp.float32(1.00029),
    )
    assert np.allclose(np.asarray(w_o), np.asarray(w_i))  # no refraction bend
    assert float(b[0]) == 1.0 and float(p[0]) == 1.0
    assert float(ior[0]) == 1.5  # enters the medium


def test_sample_bounce_plastic_lobes():
    w_i = jnp.array([[0.0], [0.0], [-1.0]])
    # fresnel at normal incidence for ior 1.5 is ~0.04: u=0.5 -> diffuse lobe
    w_o, b, p, _, _ = bsdf.sample_bounce(
        jnp.int32(bsdf.MATERIAL_SMOOTH_PLASTIC), jnp.float32(1.5), w_i, N_UP,
        jnp.float32(0.5), jnp.array([[0.3], [0.7]]), jnp.float32(1.0),
    )
    assert float(w_o[2, 0]) > 0.0  # upper hemisphere
    assert np.isclose(float(b[0]), float(w_o[2, 0]) / PI, rtol=1e-5)
    # u=0.01 < fresnel -> specular lobe
    w_o2, b2, p2, _, _ = bsdf.sample_bounce(
        jnp.int32(bsdf.MATERIAL_SMOOTH_PLASTIC), jnp.float32(1.5), w_i, N_UP,
        jnp.float32(0.01), jnp.array([[0.3], [0.7]]), jnp.float32(1.0),
    )
    assert np.allclose(np.asarray(w_o2), np.asarray(reflect(w_i, N_UP)), atol=1e-6)
    assert float(p2[0]) == 1.0


def test_refract_dielectric_snell_and_tir():
    """cfg.refract_dielectric extension: transmission obeys Snell's law with
    two-sided normals; beyond the critical angle the oriented fresnel hits 1
    and every lane reflects (TIR)."""
    import jax

    n = jnp.zeros((3, 256)).at[1].set(1.0)
    # 45-degree incidence from air into ior 1.5
    w_i = jnp.zeros((3, 256)).at[0].set(np.sqrt(0.5)).at[1].set(-np.sqrt(0.5))
    mtype = jnp.full((256,), bsdf.MATERIAL_SMOOTH_DIELECTRIC, jnp.int32)
    ior = jnp.full((256,), 1.5)
    cur = jnp.ones((256,))
    lobe_u = jax.random.uniform(jax.random.PRNGKey(0), (256,))
    dir_u = jax.random.uniform(jax.random.PRNGKey(1), (2, 256))
    w_o, b, p, new_ior, _ = bsdf.sample_bounce(
        mtype, ior, w_i, n, lobe_u, dir_u, cur, refract=True
    )
    f = bsdf.fresnel(n, -w_i, cur, ior)
    trans = np.asarray(f < lobe_u)
    # Snell: sin_t = sin(45)/1.5, going down (-y), bending toward the normal
    sin_t = np.sqrt(0.5) / 1.5
    wo = np.asarray(w_o)
    np.testing.assert_allclose(wo[0, trans], sin_t, atol=1e-6)
    np.testing.assert_allclose(wo[1, trans], -np.sqrt(1 - sin_t**2), atol=1e-6)
    np.testing.assert_allclose(np.asarray(new_ior)[trans], 1.5)
    # radiance scale (eta_i/eta_t)^2
    np.testing.assert_allclose(np.asarray(b)[trans], (1 / 1.5) ** 2, rtol=1e-6)
    # TIR: from INSIDE (cur = 1.5 -> air) at 60 degrees > critical (~41.8)
    w_i2 = jnp.zeros((3, 256)).at[0].set(np.sqrt(3) / 2).at[1].set(0.5)
    cur2 = jnp.full((256,), 1.5)
    w_o2, b2, _, ior2, _ = bsdf.sample_bounce(
        mtype, ior, w_i2, n, lobe_u, dir_u, cur2, refract=True, quirks=False
    )
    wo2 = np.asarray(w_o2)
    # every lane reflects off the flipped normal: y component flips sign
    np.testing.assert_allclose(wo2[0], np.sqrt(3) / 2, atol=1e-6)
    np.testing.assert_allclose(wo2[1], -0.5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(b2), 1.0)
    np.testing.assert_allclose(np.asarray(ior2), 1.5)  # still inside
    assert np.isfinite(wo2).all()


def test_refract_slab_roundtrip_identity():
    """Enter + exit a parallel slab at normal incidence: direction restored
    and the two (eta_i/eta_t)^2 radiance scales cancel exactly."""
    import jax

    n = jnp.zeros((3, 8)).at[1].set(1.0)
    w_i = jnp.zeros((3, 8)).at[1].set(-1.0)  # straight down into the slab
    mtype = jnp.full((8,), bsdf.MATERIAL_SMOOTH_DIELECTRIC, jnp.int32)
    ior = jnp.full((8,), 1.5)
    lobe_u = jnp.ones((8,))  # always take the transmission arm (F < 1)
    dir_u = jnp.zeros((2, 8))
    w1, b1, _, ior1, _ = bsdf.sample_bounce(
        mtype, ior, w_i, n, lobe_u, dir_u, jnp.ones((8,)), refract=True
    )
    # exit through the bottom face (outward normal -y; ray still going down)
    n2 = jnp.zeros((3, 8)).at[1].set(-1.0)
    w2, b2, _, ior2, _ = bsdf.sample_bounce(
        mtype, ior, w1, n2, lobe_u, dir_u, ior1, refract=True
    )
    np.testing.assert_allclose(np.asarray(w2), np.asarray(w_i), atol=1e-6)
    np.testing.assert_allclose(np.asarray(b1) * np.asarray(b2), 1.0, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(ior2), 1.0)


def test_refract_scene_renders_finite_and_differs():
    """A scene with a REAL smooth dielectric (none of the bundled scenes has
    one: their "water" is the plastic type): a tilted glass pane over a lit
    floor. cfg.refract_dielectric bends transmitted rays, shifting what the
    camera sees through the pane; straight-through parity does not."""
    import tempfile

    from pathtracer.config import RenderConfig
    from pathtracer.render import init_state, render_frame_jit
    from pathtracer.scene import load_scene

    obj = """
mtllib glass.mtl
v -3 0 -3
v  3 0 -3
v  3 0  3
v -3 0  3
v -2 0.2 1.4
v  2 0.2 1.4
v  2 2.2 0.4
v -2 2.2 0.4
v -2 3.2 -2
v  2 3.2 -2
v  2 3.2  0
v -2 3.2  0
vn 0 1 0
vn 0 0.4472 0.8944
vn 0 -1 0
usemtl floor
f 1//1 2//1 3//1
f 1//1 3//1 4//1
usemtl glass
f 5//2 6//2 7//2
f 5//2 7//2 8//2
usemtl lamp
f 9//3 11//3 10//3
f 9//3 12//3 11//3
"""
    mtl = """
newmtl floor
Kd 0.8 0.2 0.1
Ka 0 0 0
Ks 1 0 0
newmtl glass
Kd 1 1 1
Ka 0 0 0
Ks 0 0 1.5
newmtl lamp
Kd 0 0 0
Ka 3 3 3
Ks 1 0 0
"""
    d = tempfile.mkdtemp()
    with open(f"{d}/glass.obj", "w") as fh:
        fh.write(obj)
    with open(f"{d}/glass.mtl", "w") as fh:
        fh.write(mtl)
    scene = load_scene(f"{d}/glass.obj")
    assert (np.asarray(scene.mat_type) == bsdf.MATERIAL_SMOOTH_DIELECTRIC).any()

    base_cfg = RenderConfig(samples_per_frame=4, max_path_length=4,
                            intersector="brute", reference_quirks=False)
    refr_cfg = base_cfg.replace(refract_dielectric=True)
    a = init_state(24, 32)
    b = init_state(24, 32)
    for _ in range(4):
        a = render_frame_jit(a, scene, base_cfg)
        b = render_frame_jit(b, scene, refr_cfg)
    ia, ib = np.asarray(a.accum), np.asarray(b.accum)
    assert np.isfinite(ib).all() and ib.min() >= 0.0
    # the tilted pane bends transmitted rays: the view through it changes
    assert np.abs(ia - ib).max() > 0.05


def test_refract_transmits_through_pane():
    """Regression: a Snell-mode transmitted ray must actually PASS the
    interface.  Before the signed origin offset, the new origin was pushed
    back to the incident side (+n), so the transmitted ray re-hit its own
    pane every bounce (t = eps/|cos| survives the kill rule) and looped
    there until max bounces — an emissive floor under a glass pane rendered
    near-black through the glass."""
    import tempfile

    from pathtracer.config import RenderConfig
    from pathtracer.render import init_state, render_frame_jit
    from pathtracer.scene import load_scene

    # emissive wall at z=-5 facing the camera (which sits at (0,1,2.35)
    # looking -z); a CLOSED vertical glass slab (front z=-2, back z=-2.3,
    # outward normals) covers the x<0 half, so one image half sees the wall
    # THROUGH the slab and the other directly.  A closed slab makes the
    # (eta_i/eta_t)^2 radiance factors cancel: through-slab brightness is
    # just the double fresnel loss (~0.92 of direct).
    obj = """
mtllib pane.mtl
v -9 -9 -5
v  9 -9 -5
v  9  9 -5
v -9  9 -5
v -9 -9 -2
v  0 -9 -2
v  0  9 -2
v -9  9 -2
v -9 -9 -2.3
v  0 -9 -2.3
v  0  9 -2.3
v -9  9 -2.3
vn 0 0 1
vn 0 0 -1
usemtl lamp
f 1//1 2//1 3//1
f 1//1 3//1 4//1
usemtl glass
f 5//1 6//1 7//1
f 5//1 7//1 8//1
f 9//2 10//2 11//2
f 9//2 11//2 12//2
"""
    mtl = """
newmtl lamp
Kd 0 0 0
Ka 2 2 2
Ks 1 0 0
newmtl glass
Kd 1 1 1
Ka 0 0 0
Ks 0 0 1.5
"""
    d = tempfile.mkdtemp()
    with open(f"{d}/pane.obj", "w") as fh:
        fh.write(obj)
    with open(f"{d}/pane.mtl", "w") as fh:
        fh.write(mtl)
    scene = load_scene(f"{d}/pane.obj")

    cfg = RenderConfig(samples_per_frame=8, max_path_length=4,
                       intersector="brute", reference_quirks=False,
                       refract_dielectric=True)
    st = init_state(16, 32)
    for _ in range(2):
        st = render_frame_jit(st, scene, cfg)
    img = np.asarray(st.accum)  # (16, 32, 3)
    lum = img.mean(axis=2)
    # one image half is through-pane, the other direct (orientation-agnostic:
    # compare the two halves' means)
    a = lum[:, : lum.shape[1] // 2].mean()
    b = lum[:, lum.shape[1] // 2:].mean()
    assert max(a, b) > 0.5, "direct wall view must be lit"
    # near-normal fresnel loss is ~4% per interface: the through-pane half
    # must stay within ~25% of the direct half (the pre-fix loop rendered
    # it near-black: ratio < 0.1)
    assert min(a, b) > 0.75 * max(a, b)
