"""Golden-image integration tests: numeric RMSE vs the Mitsuba ground truths.

This is the quantitative version of the reference's on-screen comparison modes
(reference: renderer/Shaders.metal:53-66): thresholds cover path-tracer noise at
the test spp plus the reference-vs-Mitsuba estimator gap (SURVEY.md §7d).
"""

import os

import numpy as np
import pytest

from pathtracer.config import RenderConfig
from pathtracer.io.exr import read_exr
from pathtracer.render import init_state, render_frame_jit
from pathtracer.scene import golden_path, load_scene, scene_path
from pathtracer.utils.compare import downsample, metrics

H, W = 75, 100  # 600/8, 800/8


def _render(scene_name: str, depth: int, spp: int, **cfg_kw):
    scene = load_scene(scene_path(scene_name))
    cfg = RenderConfig(samples_per_frame=spp, max_path_length=depth, **cfg_kw)
    state = init_state(H, W)
    state = render_frame_jit(state, scene, cfg)
    return np.asarray(state.accum)


def _golden(scene_name: str, depth: int):
    gold, _ = read_exr(golden_path(scene_name, depth))
    return downsample(gold, H, W)


@pytest.mark.parametrize("depth", [2, 8])
def test_cornellbox_matches_mitsuba(depth):
    img = _render("cornellbox", depth, spp=48)
    m = metrics(img, _golden("cornellbox", depth))
    assert np.isfinite(img).all()
    assert m["rel_mse"] < 0.05, m
    assert 0.95 < m["mean_ratio"] < 1.05, m


def test_whitebox_direct():
    img = _render("white-box", 2, spp=48)
    m = metrics(img, _golden("white-box", 2))
    assert m["rel_mse"] < 0.05, m
    assert 0.95 < m["mean_ratio"] < 1.05, m


@pytest.mark.slow
def test_quirk_free_estimator_also_matches():
    img = _render("cornellbox", 8, spp=48, reference_quirks=False)
    m = metrics(img, _golden("cornellbox", 8))
    assert m["rel_mse"] < 0.05, m


def test_deterministic_given_seed():
    a = _render("cornellbox", 2, spp=2)
    b = _render("cornellbox", 2, spp=2)
    np.testing.assert_array_equal(a, b)


# ---- Water-variant SANITY BANDS ---------------------------------------------
# The committed Mitsuba goldens for the Water scenes were rendered with
# material tables matching neither the MTLs nor the in-repo XMLs: rendering
# with the XMLs' own materials measures FARTHER from the goldens (water
# mean_ratio 0.65-0.82, plastic 1.40) than the MTL decode does (1.045 /
# 1.17) — scripts/mitsuba_parity_probe.py, docs/PARITY.md "Known deltas".
# With Mitsuba unavailable to re-derive goldens, these tests are SANITY
# BANDS around measured values (deterministic renders, so executable
# regression gates — not estimator-parity claims); exactness for these
# scenes is pinned by the brute-force self-goldens below.

@pytest.mark.slow
def test_water_plastic_golden_sanity_band():
    # measured rel_mse 0.092, mean_ratio 1.169 (materials differ in golden)
    img = _render("CornellBox-Water-plastic", 2, spp=16)
    m = metrics(img, _golden("CornellBox-Water-plastic", 2))
    assert np.isfinite(img).all()
    assert m["rel_mse"] < 0.14, m
    assert 1.08 < m["mean_ratio"] < 1.26, m


@pytest.mark.slow
def test_water_golden_tight_at_high_spp():
    """TIGHT independent-renderer gate for CornellBox-Water: at spp256 the
    MTL-decoded materials under the reference-quirk estimator
    match the Mitsuba golden at rel_mse 0.0085 / mean_ratio 1.045
    (scripts/mitsuba_parity_probe2.py) — the spp8 sanity band's 0.090 was
    noise, not material mismatch.  This test renders spp48 (CPU-feasible)
    where the noise floor sits near 0.02; band 0.05."""
    img = _render("CornellBox-Water", 8, spp=48)
    m = metrics(img, _golden("CornellBox-Water", 8))
    assert np.isfinite(img).all()
    assert m["rel_mse"] < 0.05, m
    assert 0.99 < m["mean_ratio"] < 1.10, m


@pytest.mark.slow
def test_water_depth8_golden_sanity_band():
    # the non-refracting dielectric still lands close on this golden:
    # measured rel_mse 0.090, mean_ratio 1.045 at 8 spp
    img = _render("CornellBox-Water", 8, spp=8)
    m = metrics(img, _golden("CornellBox-Water", 8))
    assert np.isfinite(img).all()
    assert m["rel_mse"] < 0.14, m
    assert 0.98 < m["mean_ratio"] < 1.11, m


@pytest.mark.parametrize(
    "quirks,lo,hi",
    [
        # quirks on: the reference multiplies mirror throughput by cos(theta)
        # (reference: renderer/KernelHelpers.h:131), losing ~10% energy vs
        # Mitsuba -> mean_ratio ~0.907
        (True, 0.86, 0.96),
        # quirks off restores the energy: mean_ratio ~1.058
        (False, 1.00, 1.12),
    ],
)
@pytest.mark.slow
def test_water_mirror_energy_split(quirks, lo, hi):
    img = _render("CornellBox-Water-mirror", 3, spp=16, reference_quirks=quirks)
    m = metrics(img, _golden("CornellBox-Water-mirror", 3))
    assert np.isfinite(img).all()
    assert lo < m["mean_ratio"] < hi, m
    # tightened from 0.75 after the parity probe measured 0.29 at spp48
    # quirks-off; at this test's spp16 the mirror-caustic variance pushes
    # rel_mse past 0.4, so the band stays noise-dominated (a sanity gate,
    # not estimator parity — see module comment)
    assert m["rel_mse"] < 0.60, m


@pytest.mark.slow
def test_water_plastic_xml_materials_match_mitsuba():
    """TIGHT independent-renderer gate: rendering with the golden's OWN
    material table — the XML's diffuse left sphere, plastic 1.76 right
    sphere, plastic 1.333 water, each at Mitsuba's default
    diffuseReflectance 0.5 (assets/reference/CornellBox-Water-plastic.xml)
    — reproduces the Mitsuba golden at rel_mse 0.0068 / mean_ratio 1.009
    (scripts/mitsuba_parity_probe.py, Aug 20).  This recovers the material
    table the golden was actually rendered with (neither the MTL decode,
    ratio 1.17, nor the XML at full albedo, 1.40, comes close) and checks
    our estimator against Mitsuba with matched materials."""
    import jax.numpy as jnp

    scene = load_scene(scene_path("CornellBox-Water-plastic"))
    mt = np.asarray(scene.mat_type).copy()
    mi = np.asarray(scene.mat_ior).copy()
    md = np.asarray(scene.mat_diffuse).copy()
    # material ids from models/bsdf.py: 0 diffuse, 2 smooth plastic
    mt[0], mi[0] = 0, 0.0              # leftSphere: MTL plastic1.5 -> diffuse
    mt[1], mi[1], md[:, 1] = 2, 1.76, 0.5   # rightSphere: mirror -> plastic
    mt[8], mi[8], md[:, 8] = 2, 1.333, 0.5  # water: plastic albedo 1 -> 0.5
    scene = scene._replace(mat_type=jnp.asarray(mt), mat_ior=jnp.asarray(mi),
                           mat_diffuse=jnp.asarray(md))
    cfg = RenderConfig(samples_per_frame=48, max_path_length=2)
    state = init_state(H, W)
    img = np.asarray(render_frame_jit(state, scene, cfg).accum)
    m = metrics(img, _golden("CornellBox-Water-plastic", 2))
    assert np.isfinite(img).all()
    assert m["rel_mse"] < 0.02, m
    assert 0.98 < m["mean_ratio"] < 1.04, m


# ---- Self-golden exact gates (BVH path vs committed brute-force renders) ----
# The committed EXRs (scripts/make_self_goldens.py) were rendered with the
# BRUTE intersector at the SAME deterministic configuration these tests
# re-render through the production BVH path: both sides share every sample,
# so the comparison carries no estimator noise — any disagreement beyond
# shared-edge tie-breaks is an intersection bug.  This removes the "Mitsuba
# golden has different materials" escape hatch for the Water variants.

_SG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "assets", "self_golden")


@pytest.mark.parametrize("scene_name", [
    "CornellBox-Water",
    "CornellBox-Water-mirror",
    "CornellBox-Water-plastic",
])
@pytest.mark.slow
def test_bvh_matches_brute_self_golden(scene_name):
    path = os.path.join(_SG_DIR, f"{scene_name}-8.exr")
    if not os.path.exists(path):
        pytest.skip("self-goldens not generated (scripts/make_self_goldens.py)")
    gold, _ = read_exr(path)
    scene = load_scene(scene_path(scene_name))
    cfg = RenderConfig(samples_per_frame=1, max_path_length=8)
    state = init_state(150, 200)
    for _ in range(16):
        state = render_frame_jit(state, scene, cfg)
    img = np.asarray(state.accum)
    assert np.isfinite(img).all()
    m = metrics(img, gold)
    assert m["rel_mse"] < 1e-3, m
    assert 0.999 < m["mean_ratio"] < 1.001, m
