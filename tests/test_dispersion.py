"""Dispersive fresnel (framework extension): per-wavelength-bin IoR tables
reweight the specular/second lobe per bin around the reference's scalar
fresnel lobe choice (models/bsdf.py:dispersion_weights).  The reference's
dielectric transmits straight through (renderer/KernelHelpers.h:151-166), so
dispersion modulates per-bin reflectance only — paths never split."""

import jax.numpy as jnp
import numpy as np

from pathtracer.config import RenderConfig
from pathtracer.core.spectrum import bin_wavelengths, cauchy_ior_bins
from pathtracer.models import bsdf
from pathtracer.renderer import Renderer
from pathtracer.scene import attach_dispersion, load_scene, scene_path


def test_cauchy_bins_anchor_and_slope():
    bins = np.asarray(cauchy_ior_bins(1.5, 0.0042, samples=16))
    lam = np.asarray(bin_wavelengths(16))
    # monotone decreasing in wavelength; anchored near the d-line
    assert (np.diff(bins) < 0).all()
    d = 1.5 - (0.0042 / 0.5893**2) + 0.0042 / (0.5893**2)
    assert abs(d - 1.5) < 1e-6
    # blue end refracts stronger than red end
    assert bins[0] > 1.5 > bins[-1] or bins[0] > bins[-1]
    assert lam[0] < lam[-1]


def test_dispersion_weights_unbiased():
    """E over the lobe uniform of (bin weight | arm) == per-bin fresnel."""
    n = jnp.asarray([[0.0], [0.0], [1.0]])
    wi = jnp.asarray([[0.6], [0.0], [-0.8]])
    ior = jnp.asarray([1.5])
    bins = jnp.asarray([[1.48], [1.52], [1.56]])
    mt = jnp.asarray([bsdf.MATERIAL_SMOOTH_DIELECTRIC])
    fh = float(bsdf.fresnel(n, -wi, 1.0, ior)[0])
    fb = np.asarray(bsdf.fresnel(n, -wi, 1.0, bins))[:, 0]
    us = np.linspace(1e-6, 1 - 1e-6, 4001)
    w = np.stack([
        np.asarray(bsdf.dispersion_weights(
            mt, ior, bins, wi, n, jnp.asarray([u]), jnp.asarray([1.0])
        ))[:, 0]
        for u in us[:: len(us) // 200]
    ])
    # closed form instead of averaging: each arm's weight is constant
    spec_w = fb / max(fh, 1e-6)
    sec_w = (1 - fb) / max(1 - fh, 1e-6)
    np.testing.assert_allclose(spec_w * fh, fb, rtol=1e-5)
    np.testing.assert_allclose(sec_w * (1 - fh), 1 - fb, rtol=1e-5)
    # and the sampled weights match one of the two closed forms
    for row in w:
        assert np.allclose(row, spec_w, rtol=1e-4) or np.allclose(
            row, sec_w, rtol=1e-4
        )
    # diffuse/mirror lanes are untouched
    for m in (bsdf.MATERIAL_DIFFUSE, bsdf.MATERIAL_MIRROR):
        w1 = np.asarray(bsdf.dispersion_weights(
            jnp.asarray([m]), ior, bins, wi, n, jnp.asarray([0.3]),
            jnp.asarray([1.0])
        ))
        np.testing.assert_array_equal(w1, 1.0)


TINY = dict(width=32, height=24)
CFG = RenderConfig(samples_per_frame=1, max_path_length=4,
                   spectrum_samples=8, intersector="brute")


def test_zero_dispersion_matches_baseline_exactly():
    scene = load_scene(scene_path("CornellBox-Water"), samples=8)
    r0 = Renderer(scene, cfg=CFG, **TINY)
    r0.run(2)
    r1 = Renderer(attach_dispersion(scene, 0.0), cfg=CFG, **TINY)
    r1.run(2)
    np.testing.assert_allclose(
        np.asarray(r0.image()), np.asarray(r1.image()), atol=1e-7
    )


def test_dispersion_changes_image_conserving_energy():
    scene = load_scene(scene_path("CornellBox-Water"), samples=8)
    base = Renderer(scene, cfg=CFG, **TINY)
    base.run(4)
    disp = Renderer(attach_dispersion(scene, 0.02), cfg=CFG, **TINY)
    disp.run(4)
    a = np.asarray(base.image())
    b = np.asarray(disp.image())
    assert np.isfinite(b).all()
    assert not np.allclose(a, b)
    # reweighting is unbiased per arm: total energy moves only via which
    # lobe each (shared) sample took -> means stay close
    assert abs(b.mean() / a.mean() - 1.0) < 0.05


def test_dispersion_composes_with_hero_sampling():
    scene = load_scene(scene_path("CornellBox-Water"), samples=8)
    cfg = CFG.replace(hero_wavelengths=4)
    r = Renderer(attach_dispersion(scene, 0.01), cfg=cfg, **TINY)
    r.run(2)
    assert np.isfinite(np.asarray(r.image())).all()
