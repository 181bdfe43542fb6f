"""Pinhole camera and primary-ray generation.

Equivalent of the ``rayGenerator`` kernel (reference: renderer/Shaders.metal:75-103):
camera at ``up - view*2.35`` = (0, 1, 2.35) looking down -z, 90-degree horizontal
FOV, aspect-corrected, with an AA jitter of +-1/(dim-1) in normalized coords.
The reference's optional turntable parameter ``t`` (hardcoded 0.0,
reference: renderer/Shaders.metal:84) is exposed as a field.

Image convention: images are (H, W, ...) with row 0 at the *top* (EXR/PNG row
order); ray buffers are component-major (3, H*W) flattened row-major.  The
reference indexes rows bottom-up in its texture (Metal sample coords put
texture row 0 at screen bottom; reference: renderer/Renderer.mm:227-240 flips
the golden EXR to the same convention), so the row coordinate here is
``H-1-row`` relative to the reference's ``threadId.y``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..core.math3d import normalize


class Camera(NamedTuple):
    t: jnp.ndarray  # turntable angle, 0.0 in the reference
    # Thin-lens extension (the reference is pinhole-only): lens radius in
    # world units and focal-plane distance along the view axis.  Python
    # floats — trace-time constants, so aperture == 0.0 compiles to the
    # reference's exact pinhole math (bit-identical goldens).
    aperture: float = 0.0
    focus: float = 3.35

    @staticmethod
    def reference_default() -> "Camera":
        return Camera(t=jnp.float32(0.0))


def generate_rays_flat(
    camera: Camera,
    rows: jnp.ndarray,
    cols: jnp.ndarray,
    jitter: jnp.ndarray,
    full_height: int,
    full_width: int,
    lens_u: jnp.ndarray | None = None,
):
    """Primary rays for an arbitrary pixel enumeration.

    Args:
      camera: the (turntable) camera.
      rows, cols: (N,) absolute pixel coordinates (any order — the block-tiled
        order from render/order.py on the BVH path).
      jitter: (2, N) uniforms in [0, 1) for the AA jitter (the reference's
        noiseSample.xy, renderer/Shaders.metal:91-92).
      full_height, full_width: image resolution.
      lens_u: (2, N) uniforms for the thin-lens disk sample; used only when
        ``camera.aperture > 0`` (extension — the reference is pinhole-only).

    Returns:
      origins (3, N), directions (3, N), float32.
    """
    aspect = jnp.float32(full_height) / jnp.float32(full_width)

    ct, st = jnp.cos(camera.t), jnp.sin(camera.t)
    side = jnp.stack([ct, jnp.float32(0.0), st])          # (3,)
    up = jnp.array([0.0, 1.0, 0.0], jnp.float32)
    view = jnp.stack([st, jnp.float32(0.0), -ct])

    x = cols.astype(jnp.float32)
    y = jnp.float32(full_height - 1) - rows.astype(jnp.float32)  # rows count bottom-up

    # max(dim-1, 1): a 1-pixel axis (possible via --content-scale clamping)
    # must not divide by zero
    wm1 = jnp.float32(max(full_width - 1, 1))
    hm1 = jnp.float32(max(full_height - 1, 1))
    du = (jitter[0] * 2.0 - 1.0) / wm1
    dv = (jitter[1] * 2.0 - 1.0) / hm1
    ncx = 2.0 * x / wm1 - 1.0
    ncy = 2.0 * y / hm1 - 1.0

    dx = du + ncx
    # NOTE (parity quirk): aspect scales only the pixel coordinate, NOT the
    # jitter — exactly like the reference (renderer/Shaders.metal:92-98:
    # `dudv.y + normalizedCoords.y * aspect`), so vertical AA jitter spans
    # W/H pixels rather than 1.  Deliberate; do not "fix".
    dy = dv + ncy * aspect
    directions = (
        side[:, None] * dx[None, :] + up[:, None] * dy[None, :] + view[:, None]
    )
    directions = normalize(directions)
    origin = up - view * 2.35
    origins = jnp.broadcast_to(origin[:, None], directions.shape)
    if camera.aperture > 0.0 and lens_u is not None:
        # thin lens: every lens point aims at the pinhole ray's focal-plane
        # point, so geometry at ``focus`` (along the view axis) stays sharp
        ft = jnp.float32(camera.focus) / jnp.maximum(
            (directions * view[:, None]).sum(0), 1e-6
        )
        target = origins + directions * ft[None]
        r = jnp.float32(camera.aperture) * jnp.sqrt(lens_u[0])
        th = jnp.float32(2.0 * 3.14159265358979) * lens_u[1]
        lx = r * jnp.cos(th)
        ly = r * jnp.sin(th)
        origins = origins + side[:, None] * lx[None] + up[:, None] * ly[None]
        directions = normalize(target - origins)
    return origins, directions


def generate_rays(
    camera: Camera,
    height: int,
    width: int,
    jitter: jnp.ndarray,
    row0=0,
    full_height: int | None = None,
    full_width: int | None = None,
):
    """Row-major convenience wrapper over :func:`generate_rays_flat`."""
    full_height = full_height or height
    full_width = full_width or width
    rows = row0 + jnp.repeat(jnp.arange(height, dtype=jnp.int32), width)
    cols = jnp.tile(jnp.arange(width, dtype=jnp.int32), height)
    return generate_rays_flat(camera, rows, cols, jitter, full_height, full_width)
