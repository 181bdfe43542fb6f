"""Acceleration structures: LBVH build + DFS-threaded layout.

``build_layout`` is the one-call equivalent of the reference's
``MPSTriangleAccelerationStructure`` setup+rebuild (reference:
renderer/Renderer.mm:456-462).
"""

from __future__ import annotations

import jax

from ..scene.scene import Scene
from .layout import BVHLayout, dfs_layout
from .lbvh import BVH, build, morton_codes  # noqa: F401


def build_layout(
    scene: Scene, leaf_size: int = 16, builder: str = "auto",
    bake_materials: bool = False,
) -> BVHLayout:
    """Build the traversal-ready BVH for a scene.

    ``builder``: "sah" (native C++ binned-SAH, best trees), "lbvh" (jittable
    JAX morton/Karras build), or "auto" (SAH when the native library is
    available, LBVH otherwise); ``BVHLayout.builder`` records which one ran.
    The build is a one-shot host-side step (like the reference's startup
    ``rebuild``); the LBVH path runs on the CPU backend when one is
    available -- the *resulting* layout arrays follow the caller's default
    device.
    """
    bvh = None
    name = "lbvh"
    if builder in ("auto", "sah"):
        from . import native

        if native.available():
            bvh = native.build_sah(scene.p0, scene.p1, scene.p2, leaf_size)
            name = "sah"
        elif builder == "sah":
            raise RuntimeError("native SAH builder unavailable")
    if bvh is None:
        try:
            cpu = jax.devices("cpu")[0]
        except RuntimeError:
            cpu = None
        if cpu is not None:
            with jax.default_device(cpu):
                bvh = build(scene.p0, scene.p1, scene.p2, leaf_size=leaf_size)
                bvh = jax.block_until_ready(bvh)
        else:
            bvh = build(scene.p0, scene.p1, scene.p2, leaf_size=leaf_size)
    mat_tables = None
    if bake_materials:
        # per-material constants copied verbatim into per-triangle rows so
        # the payload resolve reads them with one gather (cfg.bake_materials)
        mat_tables = {
            "material_id": scene.material_id,
            "diffuse": scene.mat_diffuse,
            "emissive": scene.mat_emissive,
            "ior": scene.mat_ior,
            "mtype": scene.mat_type,
            "rough": scene.mat_roughness,
        }
    return dfs_layout(bvh, mat_tables=mat_tables, builder=name)
