"""The wavefront path-tracing pipeline.

The JAX equivalent of the reference's per-frame kernel sequence
(reference: renderer/Renderer.mm:500-585):

    rayGenerator -> [ intersect -> intersectionHandler -> shadow-intersect
                      -> lightSamplingHandler ] x MAX_PATH_LENGTH -> accumulateImage

Here the whole frame is ONE jitted function: ray state is a pytree of
component-major SoA arrays — (3, N) vectors, (S, N) spectra, (N,) scalars —
(the reference's 68-byte interleaved ``Ray`` structs, restructured so every op
is a dense vector op), the host-unrolled bounce loop becomes ``lax.fori_loop``,
dead rays are masked (matching the reference's ``maxDistance = -1`` convention,
renderer/Shaders.metal:119,124), and XLA fuses the shading stages.  Randomness
is counter-based hashing keyed on (pixel, frame, bounce), replacing the
wall-clock-seeded 64x64 noise tiles (renderer/Renderer.mm:109-129).

Estimator notes (all reference-exact when ``cfg.reference_quirks``):
  * NEE: contribution = emissive * mat.diffuse * throughput * W * bsdf / lightPdf
    with W = powerHeuristic(lightPdf, materialPdf); mat.diffuse multiplies even
    for non-diffuse surfaces (renderer/Shaders.metal:166-169).
  * BSDF-arm MIS on emitter hits: radiance += emissive * throughput * W * mPdf
    with W = powerHeuristic(mPdf, prevDiffuse * lightPdf) — note the extra *mPdf
    factor (renderer/Shaders.metal:189-193); with quirks off the factor is
    dropped (conventional MIS).
  * A nearest hit closer than DISTANCE_EPSILON kills the path outright
    (renderer/Shaders.metal:122-126).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..config import IOR_AIR, NoiseMode, RenderConfig
from ..core.geometry import interpolate
from ..core.math3d import dot, length, where3
from ..core.sampling import balance_heuristic, barycentric, select_light_index
from ..core.spectrum import apply_bins
from ..models import bsdf as bsdf_lib
from ..models.camera import Camera, generate_rays_flat
from ..ops.bvh_kernel import BLOCK, intersect_bvh_kernel
from ..ops.intersect import HitShade, intersect_brute, shade_from_scene
from ..ops.tables import select_cols
from ..ops.traverse import intersect_bvh, make_bvh_intersector
from ..scene.scene import Scene
from .noise import bounce_uniforms, camera_jitter, pids_from_order
from .order import image_from_flat, make_order

IntersectFn = Callable[[jnp.ndarray, jnp.ndarray, jnp.ndarray], HitShade]
# (origins (3, N), directions (3, N), active (N,) bool) -> HitShade


class PathState(NamedTuple):
    """SoA ray state (the reference's Ray struct, renderer/Raytracing.h:54-69,
    plus the owning pixel id so the wavefront can be freely re-sorted)."""

    origin: jnp.ndarray        # (3, N)
    direction: jnp.ndarray     # (3, N)
    throughput: jnp.ndarray    # (S, N)
    radiance: jnp.ndarray      # (S, N)
    pdf: jnp.ndarray           # (N,)  params.x: previous bounce's material pdf
    prev_diffuse: jnp.ndarray  # (N,)  params.y: 1.0 if previous bounce was diffuse
    ior: jnp.ndarray           # (N,)  params.w: current medium IoR
    alive: jnp.ndarray         # (N,) bool (maxDistance > 0 in the reference)
    pixel: jnp.ndarray         # (N,) uint32 absolute pixel id owning this lane
    # (C, N) int32 wavelength-bin indices under hero-wavelength sampling
    # (cfg.hero_wavelengths > 0); None when every spectrum bin is traced.
    bins: jnp.ndarray | None = None


class ShadowPack(NamedTuple):
    """A deferred NEE shadow query (the reference's LightSamplingRay,
    renderer/Raytracing.h:71-83).

    The shadow ray's origin is the SAME hit point the next path ray departs
    from, so the pack rides the next bounce's wavefront sort instead of paying
    its own ``lax.sort``."""

    to_light: jnp.ndarray      # (3, N) unit direction to the sampled light point
    cap: jnp.ndarray           # (N,) range cap just past the light sample
    target: jnp.ndarray        # (N,) int32 light triangle that must be nearest
    contrib: jnp.ndarray       # (S, N) precomputed radiance if unoccluded
    ok: jnp.ndarray            # (N,) bool: query live


def initial_path_state(
    origins, directions, samples: int, pixel=None, bins=None
) -> PathState:
    num = origins.shape[1]
    if pixel is None:
        pixel = jnp.arange(num, dtype=jnp.uint32)
    return PathState(
        origin=origins,
        direction=directions,
        throughput=jnp.ones((samples, num), jnp.float32),
        radiance=jnp.zeros((samples, num), jnp.float32),
        pdf=jnp.ones((num,), jnp.float32),
        prev_diffuse=jnp.zeros((num,), jnp.float32),
        ior=jnp.full((num,), IOR_AIR, jnp.float32),
        alive=jnp.ones((num,), bool),
        pixel=pixel,
        bins=bins,
    )


def select_spectrum(table: jnp.ndarray, idx: jnp.ndarray, bins) -> jnp.ndarray:
    """Spectral table lookup: (S, M) x (N,) -> (S, N), or (C, N) under hero
    sampling."""
    return apply_bins(select_cols(table, idx), bins)


def _morton5(q: jnp.ndarray) -> jnp.ndarray:
    """Spread 5 bits to every 3rd position (for the 15-bit sort cell)."""
    q = (q | (q << 8)) & 0x100F
    q = (q | (q << 4)) & 0x10C3
    q = (q | (q << 2)) & 0x1249
    return q


def ray_sort_key(state: PathState, wmin, winv) -> jnp.ndarray:
    """Wavefront sort key: (dead?, coarse origin cell, direction, fine cell).

    Dead lanes sort last (whole traversal blocks of them exit at once -- the
    compaction half); live lanes group by an 8^3 spatial cell, then by a
    16x16 octahedral direction bin, then by the finer 32^3 Morton bits, so a
    block of neighbouring lanes walks similar parts of the tree.
    Bit 30 is the dead bit (sort_wavefront recovers ``alive`` from it).
    """
    d = state.direction
    o = state.origin
    # 16x16 octahedral direction bin
    anorm = jnp.abs(d[0]) + jnp.abs(d[1]) + jnp.abs(d[2])
    u = d[0] / anorm
    v = d[1] / anorm
    uo = jnp.where(d[2] < 0, (1.0 - jnp.abs(v)) * jnp.sign(u), u)
    vo = jnp.where(d[2] < 0, (1.0 - jnp.abs(u)) * jnp.sign(v), v)
    qu = jnp.clip((uo * 0.5 + 0.5) * 16.0, 0.0, 15.0).astype(jnp.int32)
    qv = jnp.clip((vo * 0.5 + 0.5) * 16.0, 0.0, 15.0).astype(jnp.int32)
    octa = (qu << 4) | qv

    mort = jnp.zeros_like(octa)
    for axis in range(3):
        q = jnp.clip(
            ((o[axis] - wmin[axis]) * winv[axis] * 32.0), 0.0, 31.0
        ).astype(jnp.int32)
        mort = mort | (_morton5(q) << (2 - axis))
    coarse = mort >> 6     # top 9 bits: 8^3 cell
    fine = mort & 63       # bottom 6 bits
    dead = jnp.logical_not(state.alive).astype(jnp.int32)
    return (dead << 30) | (coarse << 20) | (octa << 12) | fine


def _pack_bins(bins) -> list:
    """(C, N) int32 hero-bin indices -> up to ceil(C/4) uint32 sort planes
    (4 8-bit bins per plane; S <= 256)."""
    if bins is None:
        return []
    c = bins.shape[0]
    planes = []
    for p in range(0, c, 4):
        word = jnp.zeros(bins.shape[1:], jnp.uint32)
        for j in range(p, min(p + 4, c)):
            word = word | (bins[j].astype(jnp.uint32) << (8 * (j - p)))
        planes.append(word)
    return planes


def _unpack_bins(planes, like):
    """Inverse of :func:`_pack_bins`; ``like`` supplies C (None -> None)."""
    if like is None:
        return None
    c = like.shape[0]
    rows = []
    for j in range(c):
        word = planes[j // 4]
        rows.append(((word >> (8 * (j % 4))) & jnp.uint32(0xFF)).astype(jnp.int32))
    return jnp.stack(rows)


def _sorted_planes(key, pixel, planes, lowering):
    """(sorted_key, sorted_pixel, *sorted_planes) under either lowering.

    "variadic" hands every plane to ``lax.sort`` as payload; "gather" sorts
    only (key, pixel, iota) and applies the resulting permutation with one
    ``jnp.take`` per plane.  Both are bit-identical: ``lax.sort`` is stable,
    so the sorted iota IS the permutation the variadic form applies.
    """
    if lowering not in ("variadic", "gather"):
        # direct callers (scripts/tests) bypass RenderConfig validation; a
        # typo must not silently pick a lowering
        raise ValueError(f"unknown sort lowering {lowering!r}; "
                         "expected 'variadic' or 'gather'")
    if lowering == "gather":
        n = key.shape[0]
        skey, spixel, perm = jax.lax.sort(
            (key, pixel, jax.lax.iota(jnp.int32, n)), num_keys=2
        )
        return (skey, spixel, *[jnp.take(p, perm, axis=0) for p in planes])
    return jax.lax.sort((key, pixel, *planes), num_keys=2)


def scene_sort_bounds(scene: Scene):
    """Scene-AABB (wmin, winv) for the wavefront sort key's spatial cell —
    the single source shared by render_sample and the telemetry's
    production-order wavefront reconstruction (render/stats.py), so the
    sort-key quantization can never silently diverge between them."""
    wmin = tuple(
        jnp.min(jnp.minimum(jnp.minimum(scene.p0[a], scene.p1[a]), scene.p2[a]))
        for a in range(3)
    )
    wmax = tuple(
        jnp.max(jnp.maximum(jnp.maximum(scene.p0[a], scene.p1[a]), scene.p2[a]))
        for a in range(3)
    )
    winv = tuple(1.0 / jnp.maximum(wmax[a] - wmin[a], 1e-6) for a in range(3))
    return wmin, winv


def sort_wavefront(state: PathState, wmin, winv, pack: ShadowPack | None = None,
                   lowering: str = "variadic"):
    """Re-order the whole wavefront by :func:`ray_sort_key` in ONE lax.sort
    (key + pixel id as tiebreak + every state plane as payload).

    The deferred shadow ``pack`` rides along as extra payload planes instead
    of being sorted separately.  ``lowering`` selects the variadic sort or
    the argsort+gather form (``RenderConfig.sort_lowering``).  Returns
    ``state``, or ``(state, pack)`` when a pack is given.
    """
    key = ray_sort_key(state, wmin, winv)
    samples = state.throughput.shape[0]
    bin_planes = _pack_bins(state.bins)
    nb = len(bin_planes)
    if pack is None:
        planes = [
            state.origin[0], state.origin[1], state.origin[2],
            state.direction[0], state.direction[1], state.direction[2],
            *[state.throughput[s] for s in range(samples)],
            *[state.radiance[s] for s in range(samples)],
            state.pdf, state.prev_diffuse, state.ior,
            state.alive.astype(jnp.int8),
            *bin_planes,
        ]
        out = _sorted_planes(key, state.pixel, planes, lowering)
        pixel = out[1]
        p = out[2:]
        return PathState(
            origin=jnp.stack(p[0:3]),
            direction=jnp.stack(p[3:6]),
            throughput=jnp.stack(p[6:6 + samples]),
            radiance=jnp.stack(p[6 + samples:6 + 2 * samples]),
            pdf=p[6 + 2 * samples],
            prev_diffuse=p[7 + 2 * samples],
            ior=p[8 + 2 * samples],
            alive=p[9 + 2 * samples].astype(bool),
            pixel=pixel,
            bins=_unpack_bins(p[10 + 2 * samples:10 + 2 * samples + nb], state.bins),
        )
    # Pack the small integer fields into one uint32 plane and recover
    # ``alive`` from the sorted key's dead bit (ray_sort_key bit 30), so the
    # shadow-carrying sort carries 24 operands at S = 3.
    flags = (
        jnp.where(pack.ok, jnp.uint32(1), jnp.uint32(0))
        | (state.prev_diffuse.astype(jnp.uint32) << 1)
        # target + 1 so the env sentinel (-1) packs as 0 in the uint32 plane
        | ((pack.target + 1).astype(jnp.uint32) << 2)
    )
    planes = [
        state.origin[0], state.origin[1], state.origin[2],
        state.direction[0], state.direction[1], state.direction[2],
        *[state.throughput[s] for s in range(samples)],
        *[state.radiance[s] for s in range(samples)],
        state.pdf, state.ior,
        pack.to_light[0], pack.to_light[1], pack.to_light[2],
        pack.cap,
        *[pack.contrib[s] for s in range(samples)],
        flags,
        *bin_planes,
    ]
    out = _sorted_planes(key, state.pixel, planes, lowering)
    skey = out[0]
    pixel = out[1]
    p = out[2:]
    fl = p[12 + 3 * samples]
    new_state = PathState(
        origin=jnp.stack(p[0:3]),
        direction=jnp.stack(p[3:6]),
        throughput=jnp.stack(p[6:6 + samples]),
        radiance=jnp.stack(p[6 + samples:6 + 2 * samples]),
        pdf=p[6 + 2 * samples],
        prev_diffuse=((fl >> 1) & jnp.uint32(1)).astype(jnp.float32),
        ior=p[7 + 2 * samples],
        alive=(skey >> 30) == 0,
        pixel=pixel,
        bins=_unpack_bins(p[13 + 3 * samples:13 + 3 * samples + nb], state.bins),
    )
    q = p[8 + 2 * samples:]
    new_pack = ShadowPack(
        to_light=jnp.stack(q[0:3]),
        cap=q[3],
        target=(fl >> 2).astype(jnp.int32) - 1,
        contrib=jnp.stack(q[4:4 + samples]),
        ok=(fl & jnp.uint32(1)) == 1,
    )
    return new_state, new_pack


def make_brute_intersector(scene: Scene, t_min: float = 0.0) -> IntersectFn:
    def fn(o, d, active, t_max=None):
        del active, t_max  # dense backend: all lanes, uncapped
        hit = intersect_brute(o, d, scene.p0, scene.p1, scene.p2, t_min=t_min)
        return shade_from_scene(scene, hit)

    return fn


def traversal_backend(cfg: RenderConfig) -> str:
    """The one place the intersection backend is decided: "brute" when
    cfg.intersector asks for it, else by platform -- "kernel" (the
    Pallas/Triton BVH kernel) on a GPU, "walker" (the XLA BVH walk) on the
    CPU.  Any other platform is an error, not a silent fallback."""
    if cfg.intersector == "brute":
        return "brute"
    platform = jax.devices()[0].platform
    if platform == "gpu":
        return "kernel"
    if platform == "cpu":
        return "walker"
    raise RuntimeError(
        f"no BVH traversal backend for platform {platform!r} "
        "(supported: gpu, cpu)")


def make_intersector(scene: Scene, cfg: RenderConfig, lay=None,
                     lay_occl=None, traverse=None) -> IntersectFn:
    """Build the intersector :func:`traversal_backend` picks.  ``lay_occl``
    optionally gives occlusion (t_max-capped) queries their own layout
    (small leaves suit range-pruned walks -- config.py).  The returned
    function's ``backend`` attribute names the choice.

    ``traverse`` replaces the chosen BVH traversal and is a test seam: the
    kernel in Pallas interpret mode on the CPU, or the XLA walker on a GPU
    to compare against (``backend`` then reads "given")."""
    if lay is None:
        fn = make_brute_intersector(scene)
        fn.backend = "brute"
        return fn
    if traverse is None:
        backend = traversal_backend(cfg)
        traverse = intersect_bvh_kernel if backend == "kernel" else intersect_bvh
    else:
        backend = "given"
    fn = make_bvh_intersector(lay, scene, lay_occl, traverse=traverse)
    fn.backend = backend
    return fn


def _conductor_albedo(m_diffuse, m_type, w_i, out_dir):
    """Spectral throughput factor with rough-conductor Fresnel: Schlick at
    the half-vector (F0 = Kd) REPLACES the albedo on rough-conductor lanes
    (the GGX lobe in models/bsdf.py evaluates with F = 1); every other
    material keeps its plain albedo."""
    from ..models import ggx

    is_rc = (m_type == bsdf_lib.MATERIAL_ROUGH_CONDUCTOR)[None]
    hv = out_dir - w_i  # v + l with v = -w_i
    hlen = jnp.sqrt(jnp.maximum(dot(hv, hv), 1e-12))
    cos_vm = jnp.clip(-dot(w_i, hv) / hlen, 0.0, 1.0)
    return jnp.where(is_rc, ggx.schlick(m_diffuse, cos_vm), m_diffuse)


def trace_bounce(
    scene: Scene,
    cfg: RenderConfig,
    intersect: IntersectFn,
    bounce: jnp.ndarray,
    state: PathState,
    uniforms: dict,
    with_stats: bool = False,
    defer_shadow: bool = False,
):
    """One wavefront stage group: intersect + shade/NEE + shadow + resolve.

    Mirrors intersectionHandler + lightSamplingHandler
    (reference: renderer/Shaders.metal:105-231).  With ``defer_shadow`` the
    NEE occlusion query is returned as a :class:`ShadowPack` instead of
    being traced here -- it rides the next bounce's wavefront sort (one
    lax.sort serves both) and resolves in :func:`resolve_shadow`.
    """
    eps = cfg.distance_epsilon
    aeps = cfg.angle_epsilon

    hit = intersect(state.origin, state.direction, state.alive)
    # A hit nearer than DISTANCE_EPSILON (or a miss) kills the path
    # (reference: renderer/Shaders.metal:122-126 — note the nearest hit is NOT
    # skipped in favor of the next one; the whole path dies).
    valid = state.alive & hit.valid & (hit.t >= eps)

    tri = jnp.where(valid, hit.tri, 0)
    mat = hit.mat
    if hit.mataux is not None:
        # cfg.bake_materials: the resolve row gather already delivered this
        # lane's material constants (accel/layout.py triswide) — no chains.
        # Sentinel-row lanes read zeros; every consumer is valid-masked.
        m_diffuse = apply_bins(hit.mataux["diffuse"], state.bins)
        m_emissive = apply_bins(hit.mataux["emissive"], state.bins)
        m_ior = hit.mataux["ior"]
        m_type = hit.mataux["mtype"]
        m_rough = hit.mataux.get("rough")
    else:
        # material table: tiny -> gather-free compare/select chain; spectral
        # channels read only the lane's hero bins when hero sampling is on
        m_diffuse = select_spectrum(scene.mat_diffuse, mat, state.bins)
        m_emissive = select_spectrum(scene.mat_emissive, mat, state.bins)
        m_ior = select_cols(scene.mat_ior, mat)
        m_type = select_cols(scene.mat_type, mat)
        # GGX extension types (rough conductor/plastic/dielectric — the
        # reference's TODO materials); None keeps the parity math untouched
        m_rough = (select_cols(scene.mat_roughness, mat)
                   if scene.mat_roughness is not None else None)
    if scene.textures is not None:
        # map_Kd modulation at the interpolated texcoords (config-4 extension;
        # the reference drops texcoords, renderer/Renderer.mm:365-369)
        from ..models.texture import diffuse_modulation

        m_diffuse = m_diffuse * diffuse_modulation(
            scene, tri, hit.u, hit.v, mat, state.bins,
            scene.mat_diffuse.shape[0],
        )

    hp, hn = hit.pos, hit.normal

    w_i = state.direction
    lobe_u = uniforms["lobe"]

    # ---- next-event estimation (reference: renderer/Shaders.metal:149-176) ----
    li = select_light_index(uniforms["light_select"], scene.light_cdf)
    lw = barycentric(uniforms["light_bary"])                     # (3, N)
    lp, ln_ = interpolate(
        select_cols(scene.light_p[0], li), select_cols(scene.light_p[1], li),
        select_cols(scene.light_p[2], li),
        select_cols(scene.light_n[0], li), select_cols(scene.light_n[1], li),
        select_cols(scene.light_n[2], li),
        lw,
    )
    to_light_full = lp - hp
    dist = length(to_light_full)
    to_light = to_light_full / jnp.maximum(dist, 1e-30)[None]
    l_dot_d = -dot(to_light, ln_)
    dir_ok = (dist >= eps) & (l_dot_d >= aeps)
    # solid-angle pdf (reference: renderer/KernelHelpers.h:181-190)
    li_pdf = select_cols(scene.light_pdf, li)
    li_area = select_cols(scene.light_area, li)
    light_pdf = jnp.where(
        dir_ok, li_pdf * (dist * dist) / (li_area * l_dot_d), 0.0
    )
    target = select_cols(scene.light_tri, li).astype(jnp.int32)
    if scene.env is not None:
        # Unified NEE over {area lights, environment} (framework extension;
        # the reference has neither env nor any analog): each lane samples
        # the env with probability select_p, and the branch pdfs are scaled
        # by their selection probability so one MIS weight covers both.
        from ..models.envlight import sample_env

        sel_p = scene.env.select_p
        use_env = uniforms["env_select"] < sel_p
        e_dir, e_pdf, e_rad = sample_env(
            scene.env, uniforms["env_alias"], uniforms["env_jit"], state.bins
        )
        nee_dir = where3(use_env, e_dir, to_light)
        light_pdf = jnp.where(
            use_env, e_pdf * sel_p, light_pdf * (1.0 - sel_p)
        )
        nee_emit = jnp.where(
            use_env[None, :], e_rad,
            select_spectrum(scene.light_emissive, li, state.bins),
        )
        not_self = use_env | (target != tri)
        # Below-horizon env samples can only contribute negative radiance
        # through the signed diffuse eval (cos/pi < 0) — gate them out here.
        # Area-light lanes keep the reference's ungated behavior (parity);
        # this touches only the env extension.
        not_self = not_self & (
            jnp.logical_not(use_env) | (dot(nee_dir, hn) > 0.0)
        )
        # env shadow rays are unbounded: any scene hit occludes
        shadow_cap = jnp.where(use_env, jnp.float32(1e30), dist + 4.0 * eps)
        # target -1 marks "visible iff nothing hit" (resolve_shadow)
        target = jnp.where(use_env, jnp.int32(-1), target)
    else:
        nee_dir = to_light
        nee_emit = select_spectrum(scene.light_emissive, li, state.bins)
        not_self = target != tri
        shadow_cap = dist + 4.0 * eps
    nee_bsdf, nee_mpdf = bsdf_lib.eval_material(
        m_type, m_ior, w_i, nee_dir, hn, lobe_u, aeps, roughness=m_rough
    )
    nee_weight = balance_heuristic(light_pdf, nee_mpdf)
    light_ok = (
        valid
        & (light_pdf > 0.0)
        & not_self
        & (bounce + 1 < cfg.max_path_length)
    )
    if not cfg.reference_quirks:
        # physically-correct estimator: gate EVERY NEE lane on the surface
        # cosine.  The reference leaves the signed diffuse eval (cos/pi < 0)
        # ungated for area lights — invisible in its bundled geometry but a
        # negative-radiance source once extensions (e.g. refraction) reach
        # below-horizon light samples with clear shadow paths.
        light_ok = light_ok & (dot(nee_dir, hn) > 0.0)
    nee_scale = jnp.where(
        light_ok, nee_weight * nee_bsdf / jnp.where(light_ok, light_pdf, 1.0), 0.0
    )
    nee_albedo = m_diffuse if m_rough is None else _conductor_albedo(
        m_diffuse, m_type, w_i, nee_dir
    )
    nee_contrib = nee_emit * nee_albedo * state.throughput * nee_scale[None]
    if scene.mat_ior_bins is not None:
        # dispersive fresnel (framework extension, scene.attach_dispersion):
        # per-bin lobe reweighting around the scalar-fresnel lobe choice;
        # NEE arm uses the reference's eta_out = 1.0 quirk
        m_ior_bins = select_spectrum(scene.mat_ior_bins, mat, state.bins)
        nee_contrib = nee_contrib * bsdf_lib.dispersion_weights(
            m_type, m_ior, m_ior_bins, w_i, hn, lobe_u, 1.0
        )
    if cfg.cull_zero_nee:
        # A shadow ray whose contribution is exactly zero in every bin adds
        # zero whether clear or occluded — skip its occlusion walk entirely.
        # Delta-lobe lanes (mirror/smooth-dielectric eval == 0,
        # reference: renderer/KernelHelpers.h:70-95) always qualify; the
        # reference traces them anyway (renderer/Shaders.metal:149-176).
        light_ok = light_ok & jnp.any(nee_contrib != 0.0, axis=0)
    shadow_origin = hp + hn * eps

    # ---- BSDF-arm MIS when the path hits an emitter ----
    # (reference: renderer/Shaders.metal:180-197)
    lti = hit.light
    is_light = valid & (lti >= 0)
    lts = jnp.where(is_light, lti, scene.num_lights)  # sentinel row when unused
    # "lightVertex" is the hit point itself (same triangle, same barycentrics).
    to_emitter_full = hp - state.origin
    e_dist = length(to_emitter_full)
    to_emitter = to_emitter_full / jnp.maximum(e_dist, 1e-30)[None]
    e_cos = -dot(to_emitter, hn)
    e_ok = (e_dist >= eps) & (e_cos >= aeps)
    emit_lpdf = jnp.where(
        e_ok & is_light,
        select_cols(scene.light_pdf, lts) * (e_dist * e_dist)
        / jnp.maximum(select_cols(scene.light_area, lts) * e_cos, 1e-30),
        0.0,
    )
    if scene.env is not None:
        # NEE reaches this emitter point with density light_pdf*(1 - select_p)
        # under the unified {area, env} strategy above — the BSDF-arm MIS
        # competitor must use the same scaled density or the pair of weights
        # stops summing to 1 and direct light darkens (env arm already
        # carries its select_p symmetrically).
        emit_lpdf = emit_lpdf * (1.0 - scene.env.select_p)
    emit_lpdf = state.prev_diffuse * emit_lpdf
    emit_weight = balance_heuristic(state.pdf, emit_lpdf)
    # The reference's x-pdf emitter quirk is bounded only because its sole
    # finite-pdf lobe is diffuse (pdf = cos/pi <= 1/pi).  A GGX lane's
    # state.pdf is the VNDF density (unbounded near specular), so scenes
    # that opted into rough materials use the conventional weighting for
    # every lane — they are extension scenes, not parity scenes.
    quirk = cfg.reference_quirks and m_rough is None
    emit_factor = emit_weight * (state.pdf if quirk else 1.0)
    emit_contrib = (
        m_emissive * state.throughput * jnp.where(is_light, emit_factor, 0.0)[None]
    )
    if scene.env is not None:
        # BSDF-arm env radiance: a live lane whose ray escapes the scene sees
        # the env, MIS-weighted against the NEE env arm (conventional weight —
        # the reference's *pdf emitter quirk applies only to its area lights)
        from ..models.envlight import eval_env

        miss_env = state.alive & jnp.logical_not(hit.valid)
        env_rad, env_pdf = eval_env(scene.env, state.direction, state.bins)
        env_lpdf = state.prev_diffuse * scene.env.select_p * env_pdf
        env_w = balance_heuristic(state.pdf, env_lpdf)
        emit_contrib = emit_contrib + (
            env_rad * state.throughput * jnp.where(miss_env, env_w, 0.0)[None]
        )

    # ---- sample the next bounce (reference: renderer/Shaders.metal:199-211) ----
    if cfg.refract_dielectric and scene.mat_ior_bins is not None:
        raise NotImplementedError(
            "refract_dielectric + attach_dispersion: the per-bin lobe "
            "reweighting is exact only for straight-through transmission"
        )
    w_o, nb_bsdf, nb_pdf, nb_ior, nb_finite = bsdf_lib.sample_bounce(
        m_type, m_ior, w_i, hn, lobe_u, uniforms["bounce_dir"], state.ior,
        quirks=cfg.reference_quirks, roughness=m_rough,
        refract=cfg.refract_dielectric,
    )
    safe_pdf = jnp.where(jnp.abs(nb_pdf) > cfg.pdf_floor, nb_pdf, cfg.pdf_floor)
    bounce_albedo = m_diffuse if m_rough is None else _conductor_albedo(
        m_diffuse, m_type, w_i, w_o
    )
    throughput_scale = bounce_albedo * (nb_bsdf / safe_pdf)[None]
    if scene.mat_ior_bins is not None:
        # bounce arm: eta_out is the ray's tracked (hero/d-line) IoR
        throughput_scale = throughput_scale * bsdf_lib.dispersion_weights(
            m_type, m_ior, m_ior_bins, w_i, hn, lobe_u, state.ior
        )

    origin_off = hn * eps
    if cfg.refract_dielectric:
        # Snell-mode transmitted lanes leave on the FAR side of the surface:
        # offset the new origin toward the outgoing direction's side, or the
        # transmitted ray re-intersects its own interface (t = eps/|cos| >=
        # eps survives the kill rule) and loops there until max bounces.
        # Parity mode keeps the reference's unconditional +n offset verbatim
        # (renderer/Shaders.metal:205) — its straight-through dielectric
        # shares that re-hit quirk by construction.
        origin_off = jnp.where(dot(w_o, hn) < 0.0, -eps, eps)[None] * hn
    new_state = PathState(
        origin=where3(valid, hp + origin_off, state.origin),
        direction=where3(valid, w_o, state.direction),
        throughput=where3(valid, state.throughput * throughput_scale,
                          state.throughput),
        radiance=state.radiance + emit_contrib,
        pdf=jnp.where(valid, nb_pdf, state.pdf),
        # "previous lobe has a finite sampling density" — the emitter-hit
        # MIS gate (reference's params.y; per-lobe for the GGX extensions)
        prev_diffuse=jnp.where(valid, nb_finite, state.prev_diffuse),
        ior=jnp.where(valid, nb_ior, state.ior),
        alive=valid,
        pixel=state.pixel,
        bins=state.bins,
    )

    # ---- shadow intersect + NEE resolve (reference: renderer/Shaders.metal:214-231) ----
    # range cap just past the sampled light point: pure traversal cull,
    # cannot change which hit is nearest within the range
    pack = ShadowPack(
        to_light=nee_dir,
        cap=shadow_cap,
        target=target,
        contrib=nee_contrib,
        ok=light_ok,
    )
    if defer_shadow:
        # the query's origin == new_state.origin (hp + eps*n): it rides the
        # next bounce's wavefront sort and resolves there (resolve_shadow)
        if with_stats:
            stats = {
                "path": jnp.sum(state.alive.astype(jnp.int32)),
                "shadow": jnp.sum(light_ok.astype(jnp.int32)),
            }
            return new_state, pack, stats
        return new_state, pack
    shadow_clear = occlusion_clear(
        intersect, shadow_origin, nee_dir, light_ok, shadow_cap, target, eps
    )
    new_state = new_state._replace(
        radiance=new_state.radiance + jnp.where(shadow_clear[None], nee_contrib, 0.0)
    )
    if with_stats:
        # rays the traversal actually processed this bounce (the reference's
        # MPS skips lanes with maxDistance < 0)
        stats = {
            "path": jnp.sum(state.alive.astype(jnp.int32)),
            "shadow": jnp.sum(light_ok.astype(jnp.int32)),
        }
        return new_state, stats
    return new_state


def occlusion_clear(
    intersect: IntersectFn, o, d, ok, cap, target, eps: float
) -> jnp.ndarray:
    """Shadow visibility, reference semantics: the NEAREST hit within the
    range cap must BE the targeted light triangle (reference:
    renderer/Shaders.metal:214-231); env samples (target -1) are clear iff
    nothing is hit."""
    hit = intersect(o, d, ok, t_max=cap)
    return ok & jnp.where(
        target >= 0,
        hit.valid & (hit.t >= eps) & (hit.tri == target),
        jnp.logical_not(hit.valid),
    )


def resolve_shadow(
    intersect: IntersectFn, state: PathState, pack: ShadowPack, eps: float
) -> PathState:
    """Resolve a deferred NEE pack against the (sorted) wavefront: the shadow
    origin is the lane's current path origin (same hit point).  Mirrors
    lightSamplingHandler (reference: renderer/Shaders.metal:214-231)."""
    clear = occlusion_clear(
        intersect, state.origin, pack.to_light, pack.ok, pack.cap,
        pack.target.astype(jnp.int32), eps,
    )
    return state._replace(
        radiance=state.radiance + jnp.where(clear[None], pack.contrib, 0.0)
    )


def render_sample(
    scene: Scene,
    cfg: RenderConfig,
    camera: Camera,
    height: int,
    width: int,
    key: jnp.ndarray,
    frame_index: jnp.ndarray,
    intersect: IntersectFn | None = None,
    row0=0,
    full_height: int | None = None,
    full_width: int | None = None,
    with_ray_count: bool = False,
    samples: int = 1,
    sample0=0,
) -> jnp.ndarray:
    """Trace ``samples`` path-traced samples per pixel in ONE fused wavefront
    -> SUMMED (H, W, S) radiance.

    ``row0``/``full_height``/``full_width`` render a row-tile of a larger image
    (used by parallel/ to shard pixels across a device mesh); the counter-based
    RNG keys on absolute pixel ids, so a tiled render is bit-identical to the
    single-chip one.

    Sample fusion (``samples`` > 1, PRNG noise only): each sample's lanes get
    a VIRTUAL pixel id ``pixel + (sample0 + s) * full_height * full_width``,
    so every uniform — a pure function of (id, frame, salt) — is independent
    per sample yet identical however samples are grouped into wavefronts or
    sharded across chips.  Fusing shares every sort and traversal launch,
    and a denser wavefront makes neighbouring sorted lanes more coherent.

    ``with_ray_count`` additionally returns the EXACT number of rays the
    traversal processed (live path rays per bounce + live NEE shadow rays) as
    a float32 scalar — the honest Mrays/s numerator (the reference HUD counts
    only the primary dispatch size, renderer/Renderer.mm:631-637).
    """
    if intersect is None:
        intersect = make_brute_intersector(scene)
    full_height = full_height or height
    full_width = full_width or width
    npix_full = full_height * full_width

    # Pixel enumeration: block-tiled for the BVH backends (a traversal block
    # of camera rays then covers one compact screen patch), row-major for
    # brute force.  The RNG keys on absolute pixel coordinates, so the order
    # never changes the image.
    bvh_path = cfg.intersector == "bvh"
    tile = cfg.traversal_tile if bvh_path else None
    order = make_order(height, width, row0, tile)
    pids = pids_from_order(order, full_width)

    if cfg.noise_mode == NoiseMode.PRNG:
        base = jnp.uint32(sample0) * jnp.uint32(npix_full)
        if samples > 1:
            pids = jnp.concatenate(
                [pids + base + jnp.uint32(s * npix_full) for s in range(samples)]
            )
            rows = jnp.concatenate([jnp.asarray(order.rows)] * samples)
            cols = jnp.concatenate([jnp.asarray(order.cols)] * samples)
        else:
            pids = pids + base
            rows, cols = order.rows, order.cols
    else:
        # TILED parity mode decodes x/y from the pixel id, so virtual ids
        # cannot apply; sample_sum keeps the per-sample key fold instead.
        assert samples == 1, "sample fusion requires PRNG noise"
        sample0 = 0
        rows, cols = order.rows, order.cols

    cam_key = jax.random.fold_in(key, 0xC0FFEE)
    jitter = camera_jitter(cfg, cam_key, frame_index, pids, full_height, full_width)
    origins, directions = generate_rays_flat(
        camera, rows, cols, jitter[0:2], full_height, full_width,
        lens_u=jitter[2:4],
    )
    hero = (
        cfg.hero_wavelengths
        if (cfg.spectrum_samples > 3 and cfg.hero_wavelengths > 0)
        else 0
    )
    if hero:
        from .noise import hero_bins

        bins = hero_bins(cfg, key, frame_index, pids)           # (C, N)
        state = initial_path_state(origins, directions, hero, pids, bins=bins)
    else:
        state = initial_path_state(origins, directions, cfg.spectrum_samples, pids)

    do_sort = cfg.sort_rays and bvh_path
    if do_sort:
        # scene bounds for the sort key's spatial cell
        wmin, winv = scene_sort_bounds(scene)

    def shade(b, st):
        uniforms = bounce_uniforms(
            cfg, key, frame_index, b, st.pixel, full_height, full_width,
            with_env=scene.env is not None,
        )
        return trace_bounce(
            scene, cfg, intersect, b, st, uniforms,
            defer_shadow=do_sort, with_stats=with_ray_count,
        )

    def _nrays(stats):
        return (stats["path"] + stats["shadow"]).astype(jnp.float32)

    # bounce 0 is camera-coherent already (block order); sort before each
    # secondary bounce
    if do_sort:
        # deferred-shadow pipeline: ONE sort per bounce carries both the next
        # path wavefront and the previous bounce's NEE pack (whose origin is
        # the same hit point); the pack resolves right after the sort
        out0 = shade(jnp.int32(0), state)
        state, pack = out0[0], out0[1]
        nrays = _nrays(out0[2]) if with_ray_count else jnp.float32(0)

        def stage(b, st, pk):
            """resolve previous NEE pack + shade one bounce (any lane width)."""
            st = resolve_shadow(intersect, st, pk, cfg.distance_epsilon)
            out = shade(b, st)
            nr = _nrays(out[2]) if with_ray_count else jnp.float32(0)
            return out[0], out[1], nr

        n_lanes = state.alive.shape[0]
        # Live-prefix ladder sizes: N, N/2, ... (see RenderConfig.live_ladder).
        # Every size stays >= one traversal kernel block; sizes must halve
        # exactly (odd N disables further cuts).
        sizes = [n_lanes]
        for _ in range(cfg.live_ladder):
            s = sizes[-1] // 2
            if sizes[-1] % 2 or s < BLOCK:
                break
            sizes.append(s)

        if cfg.prefix_sort and len(sizes) > 1:
            # Prefix-width sorts: bounce b's live lanes all sit inside the
            # prefix the previous bounce's sort compacted them into (dead
            # suffix lanes never revive), so the sort itself — the one
            # remaining full-width op per bounce — can run at that rung's
            # width.  The rung index rides the loop carry; the stage runs at
            # the sort's width, trailing the eager ladder's rung by at most
            # one bounce on live-count transitions.  The next rung is
            # computable BEFORE the sort (sorting preserves the alive set,
            # and it compacts the live lanes into the first `live` slots).
            def body(b, carry):
                st, pk, cnt, rung = carry

                def make_branch(s):
                    def br(st, pk):
                        cut = lambda x: jax.lax.slice_in_dim(x, 0, s, axis=-1)
                        stp, pkp = sort_wavefront(
                            jax.tree.map(cut, st), wmin, winv,
                            jax.tree.map(cut, pk),
                            lowering=cfg.sort_lowering,
                        )
                        nst, npk, nr = stage(b, stp, pkp)
                        put = lambda full, pre: (
                            jax.lax.dynamic_update_slice_in_dim(
                                full, pre, 0, axis=-1))
                        return (
                            jax.tree.map(put, st, nst),
                            jax.tree.map(put, pk, npk),
                            nr,
                        )
                    return br

                live = jnp.sum(st.alive.astype(jnp.int32))
                nst, npk, nr = jax.lax.switch(
                    rung, [make_branch(s) for s in sizes], st, pk
                )
                nrung = jnp.int32(0)
                for s in sizes[1:]:
                    nrung = nrung + (live <= s).astype(jnp.int32)
                return nst, npk, cnt + nr, nrung

            state, pack, nrays, _ = jax.lax.fori_loop(
                1, cfg.max_path_length, body,
                (state, pack, nrays, jnp.int32(0)),
            )
            sorted_loop_done = True
        else:
            sorted_loop_done = False

        # static set of bounces whose sort is skipped (cfg.sort_bounce_skip):
        # exact, because a bounce only kills lanes — every live lane still
        # sits inside the last sorted prefix, so the stale order and the
        # stale ladder rung (carried through the loop) both stay valid
        skip = (tuple(int(x) for x in cfg.sort_bounce_skip.split(","))
                if cfg.sort_bounce_skip else ())
        skip_arr = jnp.asarray(skip, jnp.int32) if skip else None

        def body(b, carry):
            st, pk, cnt, idx = carry
            if skip_arr is not None:
                do_skip = jnp.any(skip_arr == b)
                st, pk = jax.lax.cond(
                    do_skip,
                    lambda s, p: (s, p),
                    lambda s, p: sort_wavefront(
                        s, wmin, winv, p, lowering=cfg.sort_lowering),
                    st, pk,
                )
            else:
                do_skip = None
                st, pk = sort_wavefront(st, wmin, winv, pk,
                                        lowering=cfg.sort_lowering)
            if len(sizes) == 1:
                nst, npk, nr = stage(b, st, pk)
                return nst, npk, cnt + nr, idx
            # after the sort every live lane sits in the prefix; pick the
            # shortest compiled prefix that covers them all
            live = jnp.sum(st.alive.astype(jnp.int32))
            nidx = jnp.int32(0)
            for s in sizes[1:]:
                nidx = nidx + (live <= s).astype(jnp.int32)
            # without a fresh sort the live lanes are compacted only to the
            # LAST sorted rung — a tighter prefix would cut live lanes off
            idx = nidx if do_skip is None else jnp.where(do_skip, idx, nidx)

            def make_branch(s):
                def br(st, pk):
                    cut = lambda x: jax.lax.slice_in_dim(x, 0, s, axis=-1)
                    nst, npk, nr = stage(
                        b, jax.tree.map(cut, st), jax.tree.map(cut, pk)
                    )
                    # dead suffix lanes are untouched by a bounce (all their
                    # updates are alive-masked), so splicing the prefix back
                    # is exact
                    put = lambda full, pre: jax.lax.dynamic_update_slice_in_dim(
                        full, pre, 0, axis=-1
                    )
                    return (
                        jax.tree.map(put, st, nst),
                        jax.tree.map(put, pk, npk),
                        nr,
                    )
                return br

            nst, npk, nr = jax.lax.switch(
                idx, [make_branch(s) for s in sizes], st, pk
            )
            return nst, npk, cnt + nr, idx

        if not sorted_loop_done:
            state, pack, nrays, _ = jax.lax.fori_loop(
                1, cfg.max_path_length, body,
                (state, pack, nrays, jnp.int32(0)),
            )
        # the final bounce's pack is empty by construction: NEE is gated by
        # bounce + 1 < max_path_length (reference: renderer/Shaders.metal:158)
    else:
        out0 = shade(jnp.int32(0), state)
        state = out0[0] if with_ray_count else out0
        nrays = _nrays(out0[1]) if with_ray_count else jnp.float32(0)

        def body(b, carry):
            st, cnt = carry
            out = shade(b, st)
            if with_ray_count:
                return out[0], cnt + _nrays(out[1])
            return out, cnt

        state, nrays = jax.lax.fori_loop(
            1, cfg.max_path_length, body, (state, nrays)
        )

    # virtual id -> (relative sample, true local pixel); samples == 1 keeps
    # the round trip free (srel == 0)
    pix = state.pixel % jnp.uint32(npix_full)
    srel = (state.pixel // jnp.uint32(npix_full)).astype(jnp.int32) - sample0
    local = (pix - jnp.uint32(row0 * full_width)).astype(jnp.int32)
    if hero:
        # each path covered C of the S accumulator bins: scatter-add its
        # radiance into those bins with the S/C inverse-coverage weight
        # (order-independent, so it serves both pipelines and sums fused
        # samples natively)
        flat = jnp.zeros(
            (cfg.spectrum_samples, height * width), jnp.float32
        ).at[state.bins, jnp.broadcast_to(local[None, :], state.bins.shape)].add(
            state.radiance * (cfg.spectrum_samples / hero)
        )
        img = flat.reshape(cfg.spectrum_samples, height, width).transpose(1, 2, 0)
    elif do_sort:
        # lanes are in sorted order: one more lax.sort keyed by (sample,
        # pixel) restores sample-major raster order; fused samples then
        # collapse with one reshape-sum
        skey = srel * jnp.int32(height * width) + local
        planes = jax.lax.sort(
            (skey,) + tuple(state.radiance[s]
                            for s in range(cfg.spectrum_samples)),
            num_keys=1,
        )
        flat = jnp.stack(planes[1:])
        img = (
            flat.reshape(cfg.spectrum_samples, samples, height, width)
            .sum(axis=1)
            .transpose(1, 2, 0)
        )
    elif samples > 1:
        n1 = state.radiance.shape[1] // samples
        img = image_from_flat(state.radiance[:, :n1], order)
        for s in range(1, samples):
            img = img + image_from_flat(
                state.radiance[:, s * n1:(s + 1) * n1], order
            )
    else:
        img = image_from_flat(state.radiance, order)  # (H, W, S)
    if with_ray_count:
        return img, nrays
    return img
