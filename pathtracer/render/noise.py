"""Random-number supply for the integrator.

Two modes (see :class:`pathtracer.config.NoiseMode`):

* **PRNG** — counter-based PCG4D hashing (ops/rng.py): every uniform is a pure
  function of (absolute pixel id, frame, bounce, purpose, seed).  Independent
  per pixel and per use, and bit-identical regardless of device count, tile
  sharding or pixel enumeration order — the property that makes parallel/
  renders exactly equal to single-chip renders.  This replaces — and fixes —
  the reference's wall-clock-seeded mt19937 noise buffers (reference:
  renderer/Renderer.mm:109-129, 485-497), whose 64x64 tiling correlates pixels
  64 apart and whose one float4 is reused for light selection, lobe choice AND
  bounce direction within a bounce (reference: renderer/Shaders.metal:135-138,
  152-159, 204).

* **TILED** — statistical parity mode reproducing the reference's noise
  plumbing: a 64x64 float4 tile per (frame, bounce), indexed with the
  reference's offset formula, with the same component swizzles and intra-bounce
  reuse.  Useful for studying how much image quality the reference loses to its
  correlated sampling.

All functions take the pixel enumeration as explicit (rows, cols) arrays (see
render/order.py) so any traversal order yields identical samples per pixel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import NoiseMode, RenderConfig
from ..ops import rng as rng_ops

_CAMERA_SALT = 0x5CA1AB1E
_HERO_SALT = 0x4E20
_ENV_SALT = 0xE57


def hero_bins(cfg: RenderConfig, key, frame, pids) -> jnp.ndarray:
    """(C, N) stratified-rotated wavelength bin indices for hero sampling:
    one uniform per path rotates a C-point equidistant set over the S bins."""
    s = cfg.spectrum_samples
    c = cfg.hero_wavelengths
    salt = key_salt(key) ^ jnp.uint32(_HERO_SALT)
    hu = rng_ops.uniforms(pids, frame, 0, salt, 1)[0]          # (N,)
    offs = jnp.arange(c, dtype=jnp.float32)[:, None] / c       # (C, 1)
    return (((hu[None, :] + offs) % 1.0) * s).astype(jnp.int32) % s


def key_salt(key: jnp.ndarray) -> jnp.ndarray:
    """Collapse a jax.random key into a uint32 salt for the counter hash."""
    data = jax.random.key_data(key).reshape(-1).astype(jnp.uint32)
    return data[0] ^ (data[-1] * jnp.uint32(0x9E3779B9))


def _pids(rows, cols, full_width: int) -> jnp.ndarray:
    return rows.astype(jnp.uint32) * jnp.uint32(full_width) + cols.astype(jnp.uint32)


def pids_from_order(order, full_width: int) -> jnp.ndarray:
    """(N,) absolute pixel ids for a PixelOrder."""
    return _pids(order.rows, order.cols, full_width)


def _tile(cfg: RenderConfig, key, bounce) -> jnp.ndarray:
    # bounce -1 marks the camera tile; mask to keep fold_in data unsigned
    nd = cfg.noise_dimensions
    k = jax.random.fold_in(jax.random.fold_in(key, 0x7113D), bounce & 0xFFFF)
    return jax.random.uniform(k, (nd * nd, 4), jnp.float32)


def _tile_lookup(cfg, tile, frame, bounce, rows, cols, full_height):
    """noiseIndex = ((x + bounce + frame/3) % ND) + ((y + bounce + frame/5) % ND) * ND
    (reference: renderer/Shaders.metal:135-138); y counts rows bottom-up."""
    nd = cfg.noise_dimensions
    y = (full_height - 1) - rows
    ix = (cols + bounce + frame // 3) % nd
    iy = (y + bounce + frame // 5) % nd
    return tile[ix + iy * nd]  # (N, 4)


def camera_jitter(
    cfg: RenderConfig, key, frame, pids, full_height: int, full_width: int
) -> jnp.ndarray:
    """(4, N) uniforms: AA jitter rows 0-1 (reference:
    renderer/Shaders.metal:91) + thin-lens disk rows 2-3 (extension)."""
    if cfg.noise_mode == NoiseMode.TILED:
        nd = cfg.noise_dimensions
        tile = _tile(cfg, key, -1)
        rows = (pids // full_width).astype(jnp.int32)
        cols = (pids % full_width).astype(jnp.int32)
        x = cols % nd
        y = ((full_height - 1) - rows) % nd
        return tile[x + y * nd][:, :4].T  # (4, N); xy = AA, zw = lens
    salt = key_salt(key) ^ jnp.uint32(_CAMERA_SALT)
    draw = rng_ops.uniforms_r2 if cfg.sampler == "r2" else rng_ops.uniforms
    # 4 rows: [0:2] AA jitter (byte-identical streams to the historical
    # 2-row draw — the hash computes 4 lanes either way), [2:4] thin-lens
    # disk sample (used only when camera.aperture > 0)
    return draw(pids, frame, 0, salt, 4)  # (4, N)


def bounce_uniforms(
    cfg: RenderConfig, key, frame, bounce, pids,
    full_height: int, full_width: int, with_env: bool = False,
) -> dict:
    """Per-bounce uniforms for one wavefront of N rays.

    Keys: ``light_select`` (N,), ``light_bary`` (2, N), ``lobe`` (N,),
    ``bounce_dir`` (2, N) — component-major like everything else.  With
    ``with_env`` (scene carries an environment light — a framework extension,
    so TILED parity mode also draws these from the counter hash):
    ``env_select`` (N,), ``env_alias`` (N,), ``env_jit`` (2, N).
    """
    if cfg.noise_mode == NoiseMode.TILED:
        rows = (pids // full_width).astype(jnp.int32)
        cols = (pids % full_width).astype(jnp.int32)
        smp = _tile_lookup(
            cfg, _tile(cfg, key, bounce), frame, bounce, rows, cols, full_height
        )
        sx, sy, sz, sw = smp[:, 0], smp[:, 1], smp[:, 2], smp[:, 3]
        out = {
            "light_select": sz,                           # noiseSample.z
            "light_bary": jnp.stack([sw, sx], axis=0),    # noiseSample.wx
            "lobe": sy,                                   # noiseSample.y
            "bounce_dir": jnp.stack([sz, sw], axis=0),    # noiseSample.zw
        }
        if with_env:
            ue = rng_ops.uniforms(
                pids, frame, bounce, key_salt(key) ^ jnp.uint32(_ENV_SALT), 4
            )
            out.update(env_select=ue[0], env_alias=ue[1], env_jit=ue[2:4])
        return out
    n = 10 if with_env else 6
    if cfg.sampler == "r2":
        # dim order aligns the semantic 2D pairs (barycentric warp,
        # hemisphere warp, env jitter) onto whole sampler blocks — the r2
        # sampler stratifies each block as a designed 2D lattice
        # (ops/rng.py:uniforms_r2)
        u = rng_ops.uniforms_r2(pids, frame, bounce, key_salt(key), n)
        out = {
            "light_bary": u[0:2],
            "bounce_dir": u[2:4],
            "light_select": u[4],
            "lobe": u[5],
        }
        if with_env:
            out.update(env_jit=u[6:8], env_select=u[8], env_alias=u[9])
        return out
    u = rng_ops.uniforms(pids, frame, bounce, key_salt(key), n)
    out = {
        "light_select": u[0],
        "light_bary": u[1:3],
        "lobe": u[3],
        "bounce_dir": u[4:6],
    }
    if with_env:
        out.update(env_select=u[6], env_alias=u[7], env_jit=u[8:10])
    return out
