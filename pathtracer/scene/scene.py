"""Flat SoA scene buffers resident in device memory.

Replaces the reference's five GPU buffers (vertex/index/reference/material/
lightTriangle, reference: renderer/Renderer.mm:450-454) with one immutable JAX
pytree.  Triangles are stored fully gathered (three vertex positions + normals
per triangle) -- scenes here are tiny (<= 7k triangles), so a little memory
buys index-free triangle fetches.

The light table mirrors the reference builder exactly: per-emissive-triangle
area = 0.5*|cross|, pdf = area/totalArea, exclusive-prefix cdf, plus a sentinel
entry {cdf=sum, pdf=1, area=0} used by the CDF walk
(reference: renderer/Renderer.mm:393-448).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..core import spectrum as spec
from ..models.bsdf import MATERIAL_ROUGH_CONDUCTOR as _MATERIAL_ROUGH_MIN
from .materials import MaterialTable, classify
from .objmtl import ObjMesh, load_obj


class Scene(NamedTuple):
    # --- triangle geometry, gathered component-major SoA: (3, T) each ---
    p0: jnp.ndarray
    p1: jnp.ndarray
    p2: jnp.ndarray
    n0: jnp.ndarray
    n1: jnp.ndarray
    n2: jnp.ndarray
    # --- per-triangle references (reference: TriangleReference, Raytracing.h:106-111) ---
    material_id: jnp.ndarray     # (T,) int32
    light_index: jnp.ndarray     # (T,) int32, -1 when not emissive
    # --- material table (reference: Material, Raytracing.h:98-104) ---
    mat_diffuse: jnp.ndarray     # (S, M)
    mat_emissive: jnp.ndarray    # (S, M)
    mat_ior: jnp.ndarray         # (M,)
    mat_type: jnp.ndarray        # (M,) int32
    # --- light table incl. sentinel row (reference: LightTriangle, Raytracing.h:113-123) ---
    light_emissive: jnp.ndarray  # (S, L+1)
    light_p: jnp.ndarray         # (3 vertices, 3 components, L+1) positions
    light_n: jnp.ndarray         # (3 vertices, 3 components, L+1) normals
    light_area: jnp.ndarray      # (L+1,)
    light_pdf: jnp.ndarray       # (L+1,)
    light_cdf: jnp.ndarray       # (L+1,) exclusive prefix; sentinel = total
    light_tri: jnp.ndarray       # (L+1,) uint32 triangle index of each light
    # --- framework extensions (no reference equivalent) ---
    # HDR environment light (models/envlight.py); None = no env (reference
    # behavior: rays that miss die, renderer/Shaders.metal:119-124)
    env: object | None = None
    # per-triangle texcoords (6, T): uv0.xy, uv1.xy, uv2.xy (None = untextured;
    # the reference parses texcoords but discards them, Renderer.mm:365-369)
    tri_uv: jnp.ndarray | None = None
    # per-material texture index into ``textures`` (-1 = untextured material)
    mat_tex: jnp.ndarray | None = None
    # (K, TH, TW, 3) RGB texture stack (all textures resampled to one size)
    textures: jnp.ndarray | None = None
    # (S, M) per-wavelength-bin material IoR for dispersive fresnel
    # (attach_dispersion); None = non-dispersive (reference behavior:
    # one scalar IoR per material, renderer/Raytracing.h:101)
    mat_ior_bins: jnp.ndarray | None = None
    # (M,) material roughness, present only when the scene opted into the
    # GGX extension types (load_scene(..., rough_materials=True)); None =
    # parity behavior (the reference leaves its rough TODO materials as
    # diffuse, renderer/Renderer.mm:305,315,319)
    mat_roughness: jnp.ndarray | None = None

    @property
    def num_triangles(self) -> int:
        return self.p0.shape[1]

    @property
    def num_lights(self) -> int:
        return self.light_area.shape[0] - 1


def build_scene(mesh: ObjMesh, samples: int = 3,
                rough_materials: bool = False) -> Scene:
    mats: MaterialTable = classify(mesh.materials,
                                   rough_materials=rough_materials)

    tris = mesh.triangles.astype(np.int64)
    pos, nrm = mesh.positions, mesh.normals
    p = [pos[tris[:, k]] for k in range(3)]
    n = [nrm[tris[:, k]] for k in range(3)]

    # --- light table (reference: renderer/Renderer.mm:393-448) ---
    mat_ids = mesh.material_ids
    is_emitter = (mats.emissive[mat_ids] > 0.0).any(axis=1)
    light_tri = np.nonzero(is_emitter)[0]
    num_lights = len(light_tri)

    light_index = np.full(len(tris), -1, np.int32)
    light_index[light_tri] = np.arange(num_lights, dtype=np.int32)

    lp = np.stack([p[0][light_tri], p[1][light_tri], p[2][light_tri]], axis=1)
    ln = np.stack([n[0][light_tri], n[1][light_tri], n[2][light_tri]], axis=1)
    cross = np.cross(lp[:, 1] - lp[:, 0], lp[:, 2] - lp[:, 0])
    area = 0.5 * np.linalg.norm(cross, axis=1)
    total_area = area.sum() if num_lights else 1.0
    pdf = area / total_area
    cdf = np.concatenate([[0.0], np.cumsum(pdf)[:-1]]) if num_lights else np.zeros(0)
    l_emissive = mats.emissive[mat_ids[light_tri]]

    # sentinel row {cdf = sum(pdf), pdf = 1, area = 0}
    def with_sentinel(arr, sentinel):
        return np.concatenate([arr, np.asarray([sentinel], arr.dtype)], axis=0)

    light_emissive = np.concatenate(
        [l_emissive, np.zeros((1, 3), np.float32)], axis=0
    )
    light_p = np.concatenate([lp, np.zeros((1, 3, 3), np.float32)], axis=0)
    light_n = np.concatenate([ln, np.zeros((1, 3, 3), np.float32)], axis=0)
    light_area = with_sentinel(area.astype(np.float32), 0.0)
    light_pdf = with_sentinel(pdf.astype(np.float32), 1.0)
    light_cdf = with_sentinel(
        cdf.astype(np.float32), np.float32(pdf.sum()) if num_lights else 1.0
    )
    light_tri_idx = with_sentinel(light_tri.astype(np.uint32), 0)

    # --- textures (config-4 extension; reference drops texcoords,
    # renderer/Renderer.mm:365-369): stack every map_Kd at one common size ---
    tri_uv = mat_tex = textures = None
    tex_paths = [m.map_kd for m in mesh.materials]
    if mesh.texcoords is not None and any(tex_paths):
        import logging

        from ..io.png import read_png
        from ..models.texture import resample_nearest

        images, tex_of_mat = [], {}
        for path in tex_paths:
            if path and path not in tex_of_mat:
                # A missing or undecodable map_Kd must not make the scene
                # unloadable (the reference ignores textures entirely;
                # renderer/Renderer.mm:365-369) — warn and render untextured.
                try:
                    img = read_png(path)
                except (OSError, ValueError) as e:
                    logging.warning("map_Kd %s unusable (%s); material "
                                    "renders untextured", path, e)
                    tex_of_mat[path] = -1
                    continue
                tex_of_mat[path] = len(images)
                images.append(img)
        if images:
            th = max(im.shape[0] for im in images)
            tw = max(im.shape[1] for im in images)
            stack = np.stack([
                im if im.shape[:2] == (th, tw)
                else resample_nearest(im, th, tw)
                for im in images
            ])
            mat_tex = jnp.asarray(
                [tex_of_mat.get(p, -1) if p else -1 for p in tex_paths],
                jnp.int32,
            )
            uv = mesh.texcoords  # (V, 2)
            tri_uv = jnp.asarray(np.concatenate(
                [uv[tris[:, k]] for k in range(3)], axis=1
            ).T)  # (6, T): uv0.xy, uv1.xy, uv2.xy
            textures = jnp.asarray(stack)

    # (rows, S) RGB table -> (S, rows) component-major spectrum table
    up = lambda rgb: spec.from_rgb(jnp.asarray(rgb, jnp.float32), samples).T
    cm = lambda arr: jnp.asarray(arr.T)  # (T, 3) -> (3, T)

    return Scene(
        p0=cm(p[0]), p1=cm(p[1]), p2=cm(p[2]),
        n0=cm(n[0]), n1=cm(n[1]), n2=cm(n[2]),
        material_id=jnp.asarray(mat_ids, jnp.int32),
        light_index=jnp.asarray(light_index),
        mat_diffuse=up(mats.diffuse),
        mat_emissive=up(mats.emissive),
        mat_ior=jnp.asarray(mats.ior),
        mat_type=jnp.asarray(mats.mtype),
        light_emissive=up(light_emissive),
        # (L+1, vertex, comp) -> (vertex, comp, L+1)
        light_p=jnp.asarray(np.transpose(light_p, (1, 2, 0))),
        light_n=jnp.asarray(np.transpose(light_n, (1, 2, 0))),
        light_area=jnp.asarray(light_area),
        light_pdf=jnp.asarray(light_pdf),
        light_cdf=jnp.asarray(light_cdf),
        light_tri=jnp.asarray(light_tri_idx),
        tri_uv=tri_uv,
        mat_tex=mat_tex,
        textures=textures,
        # present only when a GGX extension type was actually classified,
        # so parity scenes keep the parity jit treedef (and zero extra math)
        mat_roughness=(
            jnp.asarray(mats.roughness)
            if rough_materials
            and (mats.mtype >= _MATERIAL_ROUGH_MIN).any() else None
        ),
    )


def area_light_power(scene: Scene) -> float:
    """Total emitted power of the area lights (for env select_p balancing):
    sum over lights of luminance(emissive) * area * pi."""
    from ..core import spectrum as spec

    rgb = np.asarray(spec.to_rgb(scene.light_emissive.T).T)  # (3, L+1)
    lum = 0.2126 * rgb[0] + 0.7152 * rgb[1] + 0.0722 * rgb[2]
    return float((lum[:-1] * np.asarray(scene.light_area)[:-1]).sum() * np.pi)


def attach_env(
    scene: Scene,
    image,
    strength: float = 1.0,
    rotation: float = 0.0,
    select_p: float | None = None,
) -> Scene:
    """Attach an HDR lat-long environment light ((Eh, Ew, 3) array or an EXR
    path) to a scene.  NEE then samples env vs area lights by emitted power
    unless ``select_p`` overrides."""
    from ..models.envlight import build_env

    if isinstance(image, str):
        from ..io.exr import read_exr

        image, _ = read_exr(image)
    env = build_env(
        np.asarray(image, np.float32),
        strength=strength,
        rotation=rotation,
        select_p=select_p,
        area_light_power=area_light_power(scene),
        samples=scene.mat_diffuse.shape[0],
    )
    return scene._replace(env=env)


def load_scene(path: str, samples: int = 3,
               rough_materials: bool = False) -> Scene:
    """OBJ path -> device-ready Scene.

    ``rough_materials=True`` opts into the GGX extension types for MTL
    records the reference stubs as TODO (rough conductor / plastic /
    dielectric); the default keeps the reference's diffuse fallback."""
    return build_scene(load_obj(path), samples=samples,
                       rough_materials=rough_materials)


def attach_dispersion(scene: Scene, b_um2: float, materials=None) -> Scene:
    """Return ``scene`` with a per-wavelength-bin IoR table enabling
    dispersive fresnel (framework extension; the reference's materials carry
    one scalar IoR, renderer/Raytracing.h:101, and its dielectric transmits
    straight through, so dispersion modulates per-bin REFLECTANCE, not ray
    direction — see models/bsdf.py:dispersion_weights).

    ``b_um2``: Cauchy B coefficient (um^2) applied to every material whose
    fresnel participates in lobe selection (smooth plastic + smooth
    dielectric), or only to ``materials`` (indices) when given.  The scalar
    ``mat_ior`` stays the hero/d-line value, so lobe choices and tracked ray
    IoR are unchanged; only per-bin throughput weights differ.
    """
    from ..core.spectrum import cauchy_ior_bins
    from ..models.bsdf import MATERIAL_SMOOTH_DIELECTRIC, MATERIAL_SMOOTH_PLASTIC

    samples = scene.mat_diffuse.shape[0]
    m = scene.mat_ior.shape[0]
    mtype = np.asarray(scene.mat_type)
    ior = np.asarray(scene.mat_ior)
    if materials is None:
        sel = (mtype == MATERIAL_SMOOTH_PLASTIC) | (
            mtype == MATERIAL_SMOOTH_DIELECTRIC
        )
    else:
        sel = np.zeros(m, bool)
        sel[np.asarray(materials)] = True
    bins = np.repeat(ior[None, :], samples, axis=0).astype(np.float32)  # (S, M)
    for j in range(m):
        if sel[j]:
            bins[:, j] = np.asarray(cauchy_ior_bins(float(ior[j]), b_um2, samples))
    return scene._replace(mat_ior_bins=jnp.asarray(bins))
