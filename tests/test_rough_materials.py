"""GGX extension materials (the reference's TODO stubs, opt-in via
load_scene(rough_materials=True)): lobe math identities, classifier opt-in,
estimator integration (MIS select_p invariance), and parity defaults."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.config import RenderConfig
from pathtracer.models import bsdf, ggx
from pathtracer.render import init_state, render_frame_jit
from pathtracer.scene import load_scene
from pathtracer.scene.materials import classify
from pathtracer.scene.objmtl import load_obj

from test_envlight import _obj_scene  # noqa: E402  (shared scene builder)


def _rand_views(n, key=0):
    k1, k2 = jax.random.split(jax.random.PRNGKey(key))
    nrm = jnp.zeros((3, n)).at[1].set(1.0)
    v = jax.random.normal(k1, (3, n))
    v = v / jnp.linalg.norm(v, axis=0, keepdims=True)
    v = v.at[1].set(jnp.abs(v[1]) + 0.05)
    v = v / jnp.linalg.norm(v, axis=0, keepdims=True)
    u = jax.random.uniform(k2, (2, n))
    return -v, nrm, u


@pytest.mark.parametrize("alpha", [0.04, 0.25, 0.7])
def test_ggx_sample_eval_consistent(alpha):
    """sample_lobe's (pdf, cos_vm) == eval_lobe at the sampled direction,
    the VNDF weight identity f*cos/pdf == G2/G1 holds, and single-scatter
    energy never exceeds 1."""
    w_i, n, u = _rand_views(100_000)
    w_o, wgt, pdf_s, cvm_s = ggx.sample_lobe(w_i, n, alpha, u)
    fcos, pdf_e, cvm_e = ggx.eval_lobe(w_i, w_o, n, alpha)
    ok = np.asarray(wgt) > 0
    np.testing.assert_allclose(np.asarray(pdf_s)[ok], np.asarray(pdf_e)[ok],
                               rtol=3e-3)
    np.testing.assert_allclose(np.asarray(cvm_s)[ok], np.asarray(cvm_e)[ok],
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(fcos)[ok] / np.asarray(pdf_e)[ok], np.asarray(wgt)[ok],
        rtol=3e-3,
    )
    assert np.asarray(wgt).max() < 1.0 + 1e-4


def test_ggx_smooth_limit_is_mirror():
    """At tiny roughness the sampled direction collapses to the mirror
    reflection with weight ~1."""
    from pathtracer.core.math3d import dot, reflect

    w_i, n, u = _rand_views(4096, key=3)
    w_o, wgt, _, _ = ggx.sample_lobe(w_i, n, 0.02 * 0.02, u)
    mirror = reflect(w_i, n)
    ok = np.asarray(wgt) > 0
    align = np.asarray(dot(w_o, mirror))[ok]
    assert np.median(align) > 0.9999
    assert align.min() > 0.97  # grazing views spread a touch wider
    assert np.asarray(wgt)[ok].min() > 0.95


def test_ggx_chi_square_direction_distribution():
    """Histogram of sampled w_o matches the eval pdf (one fixed view)."""
    n = 400_000
    v = jnp.zeros((3, n)).at[0].set(0.6).at[1].set(0.8)
    w_i = -v
    nrm = jnp.zeros((3, n)).at[1].set(1.0)
    u = jax.random.uniform(jax.random.PRNGKey(1), (2, n))
    alpha = 0.3
    w_o, wgt, _, _ = ggx.sample_lobe(w_i, nrm, alpha, u)
    keep = np.asarray(wgt) > 0
    d = np.asarray(w_o)[:, keep]
    # bin over (cos_theta, phi)
    nb_t, nb_p = 12, 16
    ct = np.clip(d[1], 0, 1)
    phi = np.arctan2(d[2], d[0]) + np.pi
    it = np.minimum((ct * nb_t).astype(int), nb_t - 1)
    ip = np.minimum((phi / (2 * np.pi) * nb_p).astype(int), nb_p - 1)
    counts = np.bincount(it * nb_p + ip, minlength=nb_t * nb_p)
    # expected: pdf at bin-center directions * bin solid angle * N_total
    tc = (np.arange(nb_t) + 0.5) / nb_t
    pc = (np.arange(nb_p) + 0.5) / nb_p * 2 * np.pi - np.pi
    ctg, pg = np.meshgrid(tc, pc, indexing="ij")
    st = np.sqrt(1 - ctg**2)
    dirs = np.stack([st * np.cos(pg), ctg, st * np.sin(pg)]).reshape(3, -1)
    m = dirs.shape[1]
    _, pdf_c, _ = ggx.eval_lobe(
        jnp.broadcast_to(w_i[:, :1], (3, m)), jnp.asarray(dirs),
        jnp.zeros((3, m)).at[1].set(1.0), alpha,
    )
    domega = (1.0 / nb_t) * (2 * np.pi / nb_p)  # d(cos t) * d phi
    expected = np.asarray(pdf_c) * domega * n
    mask = expected > 50  # chi-square needs occupied bins
    chi2 = (((counts - expected)[mask]) ** 2 / expected[mask]).sum()
    dof = int(mask.sum())
    # bin-center pdf vs bin-average introduces bias; allow a wide band
    assert chi2 < dof * 3.0, (chi2, dof)


_ROUGH_MTL = """
newmtl floor
Kd 0.9 0.6 0.3
Ka 0 0 0
Ks {ks}
newmtl lamp
Kd 0 0 0
Ka 1 1 1
Ks 1 0 0
"""

_QUAD_OBJ = """
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


def _rough_scene(ks, rough=True):
    import tempfile

    d = tempfile.mkdtemp()
    with open(f"{d}/biglight.obj", "w") as fh:
        fh.write(_QUAD_OBJ)
    with open(f"{d}/biglight.mtl", "w") as fh:
        fh.write(_ROUGH_MTL.format(ks=ks))
    return load_scene(f"{d}/biglight.obj", rough_materials=rough)


def test_classifier_opt_in_and_parity_default():
    """The same MTL classifies to the GGX type only when opted in; the
    default keeps the reference's diffuse fallback."""
    on = _rough_scene("0.5 1 0", rough=True)
    off = _rough_scene("0.5 1 0", rough=False)
    assert int(on.mat_type[0]) == bsdf.MATERIAL_ROUGH_CONDUCTOR
    assert on.mat_roughness is not None
    assert float(on.mat_roughness[0]) == 0.5
    assert int(off.mat_type[0]) == bsdf.MATERIAL_DIFFUSE
    assert off.mat_roughness is None


@pytest.mark.parametrize("ks,mtype", [
    ("0.5 1 0", bsdf.MATERIAL_ROUGH_CONDUCTOR),
    ("0.3 0 -1.49", bsdf.MATERIAL_ROUGH_PLASTIC),
    ("0.2 0 1.5", bsdf.MATERIAL_ROUGH_DIELECTRIC),
])
def test_rough_scene_renders_finite(ks, mtype):
    scene = _rough_scene(ks)
    assert int(scene.mat_type[0]) == mtype
    cfg = RenderConfig(samples_per_frame=4, max_path_length=4,
                       intersector="brute")
    state = init_state(24, 32)
    for _ in range(4):
        state = render_frame_jit(state, scene, cfg)
    img = np.asarray(state.accum)
    assert np.isfinite(img).all()
    assert img.min() >= 0.0
    assert img.mean() > 0.01  # light reaches the camera


@pytest.mark.parametrize("ks,quirks", [
    ("0.5 1 0", False),
    ("0.35 0 -1.49", False),
    ("0.1 1 0", True),   # low roughness = unbounded VNDF pdf: would blow
                         # out under the reference's x-pdf emitter quirk,
                         # which rough scenes therefore do not apply
])
@pytest.mark.slow
def test_rough_mis_select_p_invariance(ks, quirks):
    """The estimator stays select_p-invariant with a GGX floor: the
    emitter-hit arm must MIS against NEE through the GGX pdf (a missing or
    delta-flagged prev_diffuse double-counts or darkens direct light), and
    rough scenes disable the reference's x-pdf emitter quirk (state.pdf is
    the unbounded VNDF density there, not the parity diffuse cos/pi)."""
    scene = _rough_scene(ks)
    cfg = RenderConfig(samples_per_frame=8, max_path_length=3,
                       intersector="brute", reference_quirks=quirks)

    def run(sc, frames=96):
        state = init_state(24, 32)
        for _ in range(frames):
            state = render_frame_jit(state, sc, cfg)
        return np.asarray(state.accum)

    from pathtracer.scene import attach_env

    base = run(scene)
    black = np.full((8, 16, 3), 1e-9, np.float32)
    for sp in (0.25, 0.75):
        img = run(attach_env(scene, black, select_p=sp))
        np.testing.assert_allclose(img[-10:].mean(), base[-10:].mean(),
                                   rtol=0.01)


@pytest.mark.parametrize("refract", [False, True])
def test_rough_dielectric_straight_through_ior(refract):
    """The rough dielectric keeps the reference's straight-through
    transmission convention IN BOTH refract modes (cfg.refract_dielectric
    bends only the smooth dielectric): transmitted lanes keep direction and
    adopt the material IoR; reflected lanes scatter off-mirror (GGX).
    Regression: with refract=True the smooth path's oriented-fresnel lobe
    choice must NOT leak into the rough dielectric's IoR bookkeeping."""
    n = jnp.zeros((3, 512)).at[1].set(1.0)
    w_i = jnp.zeros((3, 512)).at[1].set(-0.6).at[0].set(0.8)
    w_i = w_i / jnp.linalg.norm(w_i, axis=0, keepdims=True)
    mtype = jnp.full((512,), bsdf.MATERIAL_ROUGH_DIELECTRIC, jnp.int32)
    ior = jnp.full((512,), 1.5)
    cur = jnp.ones((512,))
    lobe_u = jax.random.uniform(jax.random.PRNGKey(2), (512,))
    dir_u = jax.random.uniform(jax.random.PRNGKey(3), (2, 512))
    rough = jnp.full((512,), 0.3)
    w_o, b, p, new_ior, finite = bsdf.sample_bounce(
        mtype, ior, w_i, n, lobe_u, dir_u, cur, roughness=rough,
        refract=refract,
    )
    f = bsdf.fresnel(n, -w_i, cur, ior)
    trans = np.asarray(f < lobe_u)
    np.testing.assert_allclose(np.asarray(w_o)[:, trans],
                               np.asarray(w_i)[:, trans], atol=1e-6)
    np.testing.assert_allclose(np.asarray(new_ior)[trans], 1.5)
    np.testing.assert_allclose(np.asarray(finite)[trans], 0.0)
    refl = ~trans
    np.testing.assert_allclose(np.asarray(new_ior)[refl], 1.0)
    np.testing.assert_allclose(np.asarray(finite)[refl], 1.0)
    # reflections with nonzero weight stay above the surface; below-horizon
    # samples carry bsdf == 0 (the lane's throughput dies, single-scatter GGX)
    live = refl & (np.asarray(b) > 0)
    assert live.any()
    assert np.asarray(w_o)[1, live].min() > 0.0
    assert np.asarray(b)[refl & ~live].max() == 0.0


def test_rough_conductor_white_furnace_bound():
    """White (F0 = 1) rough-conductor floor under a unit env: every pixel
    stays <= 1 (energy conservation) and near 1 (single-scatter GGX loses
    only the multiple-scattering fraction at this roughness)."""
    import tempfile

    from pathtracer.scene import attach_env

    obj = """
mtllib w.mtl
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
Kd 1 1 1
Ka 0 0 0
Ks 0.5 1 0
"""
    d = tempfile.mkdtemp()
    with open(f"{d}/w.obj", "w") as fh:
        fh.write(obj)
    with open(f"{d}/w.mtl", "w") as fh:
        fh.write(mtl)
    scene = load_scene(f"{d}/w.obj", rough_materials=True)
    assert int(scene.mat_type[0]) == bsdf.MATERIAL_ROUGH_CONDUCTOR
    scene = attach_env(scene, np.ones((8, 16, 3), np.float32))
    cfg = RenderConfig(samples_per_frame=8, max_path_length=6,
                       intersector="brute", reference_quirks=False)
    state = init_state(24, 32)
    for _ in range(12):
        state = render_frame_jit(state, scene, cfg)
    img = np.asarray(state.accum)
    assert np.isfinite(img).all()
    floor = img[-8:]
    assert floor.max() < 1.02          # never creates energy
    assert floor.mean() > 0.85         # single-scatter loss only


def test_rough_dielectric_transmits_with_refract_offset():
    """refract_dielectric's signed origin offset also governs ROUGH
    dielectric straight-through transmission lanes: they must cross the
    interface instead of looping on it (the smooth-pane regression's rough
    sibling).  Rough glass scatters the view, so the gate is weaker than
    the smooth slab's: the through-pane half must carry real energy."""
    import tempfile

    import numpy as np

    from pathtracer.config import RenderConfig
    from pathtracer.render import init_state, render_frame_jit
    from pathtracer.scene import load_scene

    obj = """
mtllib rpane.mtl
v -9 -9 -5
v  9 -9 -5
v  9  9 -5
v -9  9 -5
v -9 -9 -2
v  0 -9 -2
v  0  9 -2
v -9  9 -2
vn 0 0 1
usemtl lamp
f 1//1 2//1 3//1
f 1//1 3//1 4//1
usemtl rglass
f 5//1 6//1 7//1
f 5//1 7//1 8//1
"""
    mtl = """
newmtl lamp
Kd 0 0 0
Ka 2 2 2
Ks 1 0 0
newmtl rglass
Kd 1 1 1
Ka 0 0 0
Ks 0.3 0 1.5
"""
    d = tempfile.mkdtemp()
    with open(f"{d}/rpane.obj", "w") as fh:
        fh.write(obj)
    with open(f"{d}/rpane.mtl", "w") as fh:
        fh.write(mtl)
    scene = load_scene(f"{d}/rpane.obj", rough_materials=True)
    from pathtracer.models.bsdf import MATERIAL_ROUGH_DIELECTRIC

    assert (np.asarray(scene.mat_type) == MATERIAL_ROUGH_DIELECTRIC).any()

    cfg = RenderConfig(samples_per_frame=8, max_path_length=4,
                       intersector="brute", reference_quirks=False,
                       refract_dielectric=True)
    st = init_state(16, 32)
    for _ in range(2):
        st = render_frame_jit(st, scene, cfg)
    img = np.asarray(st.accum)
    assert np.isfinite(img).all()
    lum = img.mean(axis=2)
    a = lum[:, : lum.shape[1] // 2].mean()
    b = lum[:, lum.shape[1] // 2:].mean()
    assert max(a, b) > 0.5, "direct wall view must be lit"
    # single rough interface: transmitted arm carries eta^2 ~ 0.44 of the
    # radiance; with the pre-fix loop the through half was near-black (<0.1)
    assert min(a, b) > 0.25 * max(a, b)
