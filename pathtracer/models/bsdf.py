"""BSDF library: diffuse, mirror, smooth plastic, smooth dielectric.

JAX re-implementation of the reference's material switch statements
(reference: renderer/KernelHelpers.h:56-179).  Where Metal branches per thread on
``material.materialType``, here every lane computes all four material responses
and selects -- the compute-all-4-select restructuring that avoids divergence
(the four models are a handful of flops each, so redundancy is cheaper than
any gather/scatter shuffle).

Reference quirks deliberately preserved (gated by ``RenderConfig.reference_quirks``):
  * the smooth dielectric transmits *straight through* (wO = wI, no refraction
    bend) and its NEE eval returns bsdf = pdf = 0
    (reference: renderer/KernelHelpers.h:151-166, 89-104);
  * NEE eval uses fresnel(eta_out=1.0) while bounce generation uses the ray's
    tracked current IoR (reference: renderer/KernelHelpers.h:74 vs :137);
  * for the diffuse lobe, bsdf and pdf are the *same* number cos(theta)/pi
    (reference: renderer/KernelHelpers.h:78,108,141,171).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import PI
from ..core.math3d import dot, reflect
from ..core.sampling import generate_diffuse_bounce

# Material type enum (reference: renderer/Raytracing.h:35-43)
MATERIAL_DIFFUSE = 0
MATERIAL_MIRROR = 1
MATERIAL_SMOOTH_PLASTIC = 2
MATERIAL_SMOOTH_DIELECTRIC = 3
# Extension types: the reference's explicit TODO materials
# (reference: renderer/Renderer.mm:305,315,319), GGX-backed (models/ggx.py).
# Only classified when load_scene(..., rough_materials=True); the parity
# default falls back to DIFFUSE exactly like the reference.
MATERIAL_ROUGH_CONDUCTOR = 4
MATERIAL_ROUGH_PLASTIC = 5
MATERIAL_ROUGH_DIELECTRIC = 6
MATERIAL_COUNT = 7

MATERIAL_NAMES = (
    "diffuse", "mirror", "smooth plastic", "smooth dielectric",
    "rough conductor", "rough plastic", "rough dielectric",
)


def fresnel(n, i, eta_out, eta_in):
    """Unpolarized Fresnel reflectance; returns 1.0 under total internal
    reflection (reference: renderer/KernelHelpers.h:7-21).

    ``i`` points away from the surface (the reference passes ``-wI``).
    """
    eta_scale = eta_out / eta_in
    cos_theta_i = jnp.clip(dot(n, i), -1.0, 1.0)
    sin_theta_t_sq = (eta_scale * eta_scale) * (1.0 - cos_theta_i * cos_theta_i)
    cos_theta_t = jnp.sqrt(jnp.maximum(1.0 - sin_theta_t_sq, 0.0))
    r_s = (eta_in * cos_theta_i - eta_out * cos_theta_t) / (
        eta_in * cos_theta_i + eta_out * cos_theta_t
    )
    r_p = (eta_in * cos_theta_t - eta_out * cos_theta_i) / (
        eta_in * cos_theta_t + eta_out * cos_theta_i
    )
    return jnp.where(sin_theta_t_sq < 1.0, 0.5 * (r_s * r_s + r_p * r_p), 1.0)


def _is_mirror_direction(w_i, w_o, n, angle_epsilon):
    """|dot(reflect(wI, n), wO) - 1| < eps (reference: renderer/KernelHelpers.h:67)."""
    return jnp.abs(dot(reflect(w_i, n), w_o) - 1.0) < angle_epsilon


def eval_material(mtype, ior, w_i, w_o, n, lobe_u, angle_epsilon,
                  roughness=None):
    """NEE-side material evaluation -> (bsdf, pdf), all batches (N,)-shaped
    with (3, N) direction/normal arrays.

    Equivalent of ``sampleMaterial`` (reference: renderer/KernelHelpers.h:56-114).
    ``lobe_u`` is the lobe-selection uniform (the reference's noiseSample.y) and
    must be the same sample later fed to :func:`sample_bounce` for this bounce so
    the plastic/dielectric lobe choice is consistent within the bounce.
    """
    cos_theta = dot(w_o, n)
    is_mirror_dir = _is_mirror_direction(w_i, w_o, n, angle_epsilon)
    mirror_bsdf = jnp.where(is_mirror_dir, cos_theta, 0.0)

    diffuse_val = (1.0 / PI) * cos_theta  # bsdf == pdf for the diffuse lobe

    # NEE eval always uses eta_out = 1.0 (reference: renderer/KernelHelpers.h:74,91)
    f_i = fresnel(n, -w_i, 1.0, ior)
    take_second_lobe = f_i < lobe_u  # diffuse (plastic) / transmit (dielectric)

    plastic_bsdf = jnp.where(take_second_lobe, diffuse_val, mirror_bsdf)
    plastic_pdf = jnp.where(take_second_lobe, diffuse_val, 1.0)
    dielectric_bsdf = jnp.where(take_second_lobe, 0.0, mirror_bsdf)
    dielectric_pdf = jnp.where(take_second_lobe, 0.0, 1.0)

    bsdf = _select4(mtype, diffuse_val, mirror_bsdf, plastic_bsdf, dielectric_bsdf)
    pdf = _select4(
        mtype, diffuse_val, jnp.ones_like(diffuse_val), plastic_pdf, dielectric_pdf
    )
    if roughness is None:
        return bsdf, pdf
    # GGX extension lobes (scalar F = 1; spectral conductor Fresnel is a
    # wavefront-side throughput factor). Rough plastic/dielectric keep the
    # smooth models' scalar-fresnel lobe CHOICE; the specular arm swaps the
    # delta mirror for the GGX lobe.
    from . import ggx

    gfcos, gpdf, _ = ggx.eval_lobe(w_i, w_o, n, roughness * roughness)
    r_pl_bsdf = jnp.where(take_second_lobe, diffuse_val, gfcos)
    r_pl_pdf = jnp.where(take_second_lobe, diffuse_val, gpdf)
    r_di_bsdf = jnp.where(take_second_lobe, 0.0, gfcos)
    r_di_pdf = jnp.where(take_second_lobe, 0.0, gpdf)
    bsdf = _select_rough(mtype, bsdf, gfcos, r_pl_bsdf, r_di_bsdf)
    pdf = _select_rough(mtype, pdf, gpdf, r_pl_pdf, r_di_pdf)
    return bsdf, pdf


def sample_bounce(mtype, ior, w_i, n, lobe_u, dir_u, current_ior,
                  quirks: bool = True, roughness=None,
                  refract: bool = False):
    """Sample the next bounce direction
    -> (w_o, bsdf, pdf, new_ior, finite_pdf).

    ``refract=True`` (extension, cfg.refract_dielectric) replaces the
    reference's straight-through smooth-dielectric transmission with a
    Snell-bent refraction: two-sided normals, air (IoR 1.0) outside,
    automatic TIR via the oriented fresnel, and the camera-path radiance
    scale (eta_i/eta_t)^2.  The rough dielectric keeps straight-through
    transmission in either mode.

    ``finite_pdf`` is the flag the emitter-hit MIS arm keys on (the
    reference's params.y "previous bounce was diffuse",
    renderer/Shaders.metal:189): for the four parity materials it is
    exactly the reference's material-level rule (mtype == DIFFUSE); for the
    GGX extension lobes it is per-LOBE — any arm with a finite sampling
    density sets it (a GGX bounce that hits a light must MIS-weight against
    NEE or direct light double-counts).

    Equivalent of ``generateNextBounce`` (reference:
    renderer/KernelHelpers.h:116-179).  ``dir_u`` is (2, N) — the reference's
    noiseSample.zw — used for the cosine-hemisphere warp; ``w_i``/``n`` are
    (3, N); returns ((3, N) w_o, (N,) bsdf, (N,) pdf, (N,) new_ior).

    ``quirks=True`` keeps the reference's specular weighting bug: a perfect
    mirror bounce multiplies throughput by cos(theta)
    (reference: renderer/KernelHelpers.h:131,146,163), darkening every
    specular path; ``quirks=False`` uses the physically correct weight 1.
    """
    mirror_dir = reflect(w_i, n)
    diffuse_dir = generate_diffuse_bounce(dir_u, n)

    mirror_cos = dot(mirror_dir, n)
    if not quirks:
        mirror_cos = jnp.ones_like(mirror_cos)
    diffuse_val = (1.0 / PI) * dot(diffuse_dir, n)

    # Bounce generation uses the ray's tracked IoR as eta_out
    # (reference: renderer/KernelHelpers.h:137,153).
    f_i = fresnel(n, -w_i, current_ior, ior)
    take_second_lobe = f_i < lobe_u

    tsl3 = take_second_lobe[None]
    plastic_dir = jnp.where(tsl3, diffuse_dir, mirror_dir)
    plastic_bsdf = jnp.where(take_second_lobe, diffuse_val, mirror_cos)
    plastic_pdf = jnp.where(take_second_lobe, diffuse_val, 1.0)

    if not refract:
        # straight-through transmission (reference parity,
        # renderer/KernelHelpers.h:151-166: no refraction bend)
        dielectric_dir = jnp.where(tsl3, w_i, mirror_dir)
        dielectric_bsdf = jnp.where(take_second_lobe, 1.0, mirror_cos)
        dielectric_pdf = jnp.ones_like(diffuse_val)
        dielectric_ior = jnp.where(take_second_lobe, ior, current_ior)
    else:
        # physically-correct smooth dielectric (extension): Snell-bent
        # transmission with two-sided normals and air (1.0) on the outside.
        # TIR is automatic (oriented fresnel returns 1 -> reflection arm).
        entering = dot(w_i, n) < 0.0
        n_f = jnp.where(entering[None], n, -n)
        eta_t = jnp.where(entering, ior, 1.0)
        f_r = fresnel(n_f, -w_i, current_ior, eta_t)
        eta = current_ior / jnp.maximum(eta_t, 1e-6)
        cos_i = -dot(w_i, n_f)
        sin_t_sq = eta * eta * jnp.maximum(1.0 - cos_i * cos_i, 0.0)
        cos_t = jnp.sqrt(jnp.maximum(1.0 - sin_t_sq, 0.0))
        refr_dir = eta[None] * w_i + (eta * cos_i - cos_t)[None] * n_f
        # dielectric lanes re-choose their lobe with the oriented fresnel
        # (same lobe_u uniform); plastic keeps the reference's f_i selection
        dsl = f_r < lobe_u
        refl_dir = reflect(w_i, n_f)
        refl_w = dot(refl_dir, n_f) if quirks else jnp.ones_like(diffuse_val)
        dielectric_dir = jnp.where(dsl[None], refr_dir, refl_dir)
        # camera-path radiance convention: transmitted radiance scales by
        # (eta_i/eta_t)^2 — enter+exit through a slab nets exactly 1
        dielectric_bsdf = jnp.where(dsl, eta * eta, refl_w)
        dielectric_pdf = jnp.ones_like(diffuse_val)
        dielectric_ior = jnp.where(dsl, eta_t, current_ior)

    one = jnp.ones_like(diffuse_val)
    w_o = _select4(
        mtype[None], diffuse_dir, mirror_dir, plastic_dir, dielectric_dir
    )
    bsdf = _select4(mtype, diffuse_val, mirror_cos, plastic_bsdf, dielectric_bsdf)
    pdf = _select4(mtype, diffuse_val, one, plastic_pdf, dielectric_pdf)
    new_ior = _select4(mtype, current_ior, current_ior, current_ior, dielectric_ior)
    finite_pdf = (mtype == MATERIAL_DIFFUSE).astype(jnp.float32)
    if roughness is None:
        return w_o, bsdf, pdf, new_ior, finite_pdf

    from . import ggx

    g_dir, g_wgt, g_pdf, _ = ggx.sample_lobe(
        w_i, n, roughness * roughness, dir_u
    )
    # house convention (same as diffuse): bsdf = f*cos, pdf = the sampling
    # density — the ratio is the throughput weight AND pdf is the MIS
    # density the emitter-hit arm needs.  f*cos = weight * pdf (F = 1;
    # spectral conductor Fresnel lands wavefront-side).
    g_fcos = g_wgt * g_pdf
    r_pl_dir = jnp.where(tsl3, diffuse_dir, g_dir)
    r_pl_bsdf = jnp.where(take_second_lobe, diffuse_val, g_fcos)
    r_pl_pdf = jnp.where(take_second_lobe, diffuse_val, g_pdf)
    r_di_dir = jnp.where(tsl3, w_i, g_dir)
    r_di_bsdf = jnp.where(take_second_lobe, 1.0, g_fcos)
    r_di_pdf = jnp.where(take_second_lobe, 1.0, g_pdf)
    # rough dielectric keys its OWN ior update on take_second_lobe (the
    # smooth dielectric_ior keys on refract-mode's oriented-fresnel choice,
    # which diverges for exit rays)
    r_di_ior = jnp.where(take_second_lobe, ior, current_ior)

    w_o = _select_rough(mtype[None], w_o, g_dir, r_pl_dir, r_di_dir)
    bsdf = _select_rough(mtype, bsdf, g_fcos, r_pl_bsdf, r_di_bsdf)
    pdf = _select_rough(mtype, pdf, g_pdf, r_pl_pdf, r_di_pdf)
    new_ior = _select_rough(
        mtype, new_ior, current_ior, current_ior, r_di_ior
    )
    finite = _select_rough(
        mtype,
        finite_pdf,
        jnp.ones_like(finite_pdf),
        jnp.ones_like(finite_pdf),
        jnp.where(take_second_lobe, 0.0, 1.0),
    )
    return w_o, bsdf, pdf, new_ior, finite


def _select4(mtype, v_diffuse, v_mirror, v_plastic, v_dielectric):
    return jnp.where(
        mtype == MATERIAL_DIFFUSE,
        v_diffuse,
        jnp.where(
            mtype == MATERIAL_MIRROR,
            v_mirror,
            jnp.where(mtype == MATERIAL_SMOOTH_PLASTIC, v_plastic, v_dielectric),
        ),
    )


def _select_rough(mtype, v_parity, v_conductor, v_rplastic, v_rdielectric):
    """Layer the GGX extension types over the parity _select4 result."""
    return jnp.where(
        mtype == MATERIAL_ROUGH_CONDUCTOR,
        v_conductor,
        jnp.where(
            mtype == MATERIAL_ROUGH_PLASTIC,
            v_rplastic,
            jnp.where(mtype == MATERIAL_ROUGH_DIELECTRIC,
                      v_rdielectric, v_parity),
        ),
    )


def dispersion_weights(mtype, ior, ior_bins, w_i, n, lobe_u, eta_out):
    """Per-wavelength-bin lobe reweighting for dispersive materials
    -> (S|C, N), multiplied into the bin throughputs.

    The lobe CHOICE stays with the scalar (d-line) fresnel ``f_h`` the
    reference uses — same uniform ``lobe_u``, same branch — and each bin b
    re-weights its arm so its expectation over the choice is exact:
    specular arm F_b/F_h (picked w.p. F_h -> contributes F_b), second lobe
    (1-F_b)/(1-F_h) (picked w.p. 1-F_h -> contributes 1-F_b).  Since the
    reference's dielectric transmits straight through (no refraction bend,
    renderer/KernelHelpers.h:151-166), dispersion cannot split ray paths —
    only reflectance varies per bin — so this is exact per-bin, not an
    approximation, for every bundled material model.  Diffuse and mirror
    lanes get weight 1.

    ``ior_bins``: (S|C, N) per-bin material IoR (scene.mat_ior_bins
    selected per lane); ``eta_out``: the arm's outside IoR — the tracked
    ray IoR for bounce sampling, 1.0 for NEE evaluation (the reference's
    eta quirk, renderer/KernelHelpers.h:74 vs :137).
    """
    f_h = fresnel(n, -w_i, eta_out, ior)                       # (N,)
    f_b = fresnel(n, -w_i, eta_out, ior_bins)                  # (S|C, N)
    take_second = (f_h < lobe_u)[None]
    w_spec = f_b / jnp.maximum(f_h, 1e-6)[None]
    w_sec = (1.0 - f_b) / jnp.maximum(1.0 - f_h, 1e-6)[None]
    w = jnp.where(take_second, w_sec, w_spec)
    has_fresnel_lobe = (
        (mtype == MATERIAL_SMOOTH_PLASTIC)
        | (mtype == MATERIAL_SMOOTH_DIELECTRIC)
        | (mtype == MATERIAL_ROUGH_PLASTIC)
        | (mtype == MATERIAL_ROUGH_DIELECTRIC)
    )[None]
    return jnp.where(has_fresnel_lobe, w, 1.0)
