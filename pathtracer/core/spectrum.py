"""Spectrum representation.

The reference carries radiance as a fixed-size wavelength vector
(``Spectrum { float values[SPECTRUM_SAMPLES] }`` with SPECTRUM_SAMPLES = 3, an
RGB stand-in -- reference: renderer/Spectrum.h:3-21).  Here a spectrum is just
the trailing axis of a batched array: radiance for N rays is an ``(N, S)``
float32 array and every spectrum op (the exhaustively-overloaded
``spectrum_add/mul`` family in renderer/Spectrum.h:25-113) is ordinary
broadcasted arithmetic fused by XLA.  The helpers here exist for readability and
for the S != 3 (true spectral) extension.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

SPECTRUM_SAMPLES = 3  # default, matching reference renderer/Spectrum.h:3

# CIE-ish primaries for S>3 rendering: wavelengths are sampled uniformly in
# [LAMBDA_MIN, LAMBDA_MAX] nm.
LAMBDA_MIN = 400.0
LAMBDA_MAX = 700.0


def constant(value: float, shape=(), samples: int = SPECTRUM_SAMPLES) -> jnp.ndarray:
    """spectrum_set equivalent: a spectrum filled with one value."""
    return jnp.full((*shape, samples), value, jnp.float32)


def apply_bins(vals: jnp.ndarray, bins) -> jnp.ndarray:
    """(S, N) per-lane spectra -> (C, N) hero-wavelength view: each lane reads
    only its ``bins`` (C, N) wavelength bins; identity when bins is None.
    The single definition shared by material, env-light and texture reads."""
    if bins is None:
        return vals
    out = jnp.zeros(bins.shape, jnp.float32)
    for s in range(vals.shape[0]):
        out = jnp.where(bins == s, vals[s][None, :], out)
    return out


def from_rgb(rgb, samples: int = SPECTRUM_SAMPLES) -> jnp.ndarray:
    """Lift an RGB triple to an S-sample spectrum.

    For S == 3 this is the identity (the reference's RGB-as-spectrum stand-in).
    For S > 3 we use a smooth box-basis upsample: each wavelength bin takes the
    value of the RGB channel whose band it falls into (B: 400-490, G: 490-580,
    R: 580-700), which round-trips exactly under :func:`to_rgb`'s band-averaged
    downsample for the constant spectra used by the bundled scenes.
    """
    rgb = jnp.asarray(rgb, jnp.float32)
    if samples == 3:
        return rgb
    lam = jnp.linspace(LAMBDA_MIN, LAMBDA_MAX, samples)
    blue = lam < 490.0
    green = (lam >= 490.0) & (lam < 580.0)
    r, g, b = rgb[..., 0:1], rgb[..., 1:2], rgb[..., 2:3]
    return jnp.where(blue, b, jnp.where(green, g, r))


def to_rgb(spec: jnp.ndarray) -> jnp.ndarray:
    """Collapse an S-sample spectrum back to RGB (band-averaged)."""
    samples = spec.shape[-1]
    if samples == 3:
        return spec
    lam = jnp.linspace(LAMBDA_MIN, LAMBDA_MAX, samples)
    blue = (lam < 490.0).astype(jnp.float32)
    green = ((lam >= 490.0) & (lam < 580.0)).astype(jnp.float32)
    red = (lam >= 580.0).astype(jnp.float32)
    weights = jnp.stack([red, green, blue], axis=0)  # (3, S)
    weights = weights / jnp.sum(weights, axis=1, keepdims=True)
    # HIGHEST: float32 products, never TF32 on a GPU's tensor cores
    return jnp.einsum("...s,cs->...c", spec, weights,
                      precision=jax.lax.Precision.HIGHEST)


def bin_wavelengths(samples: int = SPECTRUM_SAMPLES) -> jnp.ndarray:
    """(S,) nm wavelength of each spectrum bin (uniform in [400, 700];
    for the RGB stand-in S == 3 these are the band centers)."""
    if samples == 3:
        return jnp.asarray([640.0, 535.0, 445.0], jnp.float32)  # R G B centers
    return jnp.linspace(LAMBDA_MIN, LAMBDA_MAX, samples).astype(jnp.float32)


def cauchy_ior_bins(ior_d: float, b_um2: float,
                    samples: int = SPECTRUM_SAMPLES) -> jnp.ndarray:
    """(S,) per-bin index of refraction from a two-term Cauchy model
    n(lambda) = A + B / lambda_um^2, with A chosen so n(589.3 nm) == ior_d
    (the sodium d-line the scalar material IoR is quoted at).  ``b_um2`` is
    the Cauchy B coefficient in um^2 (~0.00420 for BK7 glass)."""
    lam_um = bin_wavelengths(samples) / 1000.0
    a = ior_d - b_um2 / (0.5893 ** 2)
    return (a + b_um2 / (lam_um * lam_um)).astype(jnp.float32)
