"""Large-scene robustness: meshes far beyond the reference's maximum.

The reference's largest bundled scene is 7,088 triangles (BASELINE.md;
renderer/Media/CornellBox-Water*.obj) and its BVH is built by the closed
MPS library.  A production framework must keep working at real content
sizes, so these tests build a ~130K-triangle displaced terrain procedurally
and drive the from-scratch pipeline end to end at that scale: both BVH
builders (native C++ binned SAH and the jittable LBVH), the packed DFS
layout invariants (the node word packs leaf count in 6 bits and first-row
in 25 — accel/layout.py), traversal vs the brute-force oracle, and a small
render through the production wavefront path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.accel import build_layout, native
from pathtracer.config import RenderConfig
from pathtracer.ops.intersect import intersect_brute
from pathtracer.ops.traverse import intersect_bvh
from pathtracer.renderer import Renderer
from pathtracer.scene.objmtl import MtlRecord, ObjMesh
from pathtracer.scene.scene import build_scene

GRID = 256  # (GRID-1)^2 * 2 terrain triangles + 2 lamp triangles = 130,052


def _terrain_mesh(n=GRID):
    """Displaced heightfield + an emissive quad above it, as an ObjMesh."""
    xs = np.linspace(-1.0, 1.0, n, dtype=np.float64)
    x, z = np.meshgrid(xs, xs, indexing="ij")
    y = 0.35 * np.sin(3.0 * x) * np.cos(2.0 * z) + 0.15 * np.sin(
        7.0 * x + 1.0
    ) * np.cos(5.0 * z)
    pos = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    # analytic normals of y = f(x, z): normalize(-df/dx, 1, -df/dz)
    dfdx = 0.35 * 3.0 * np.cos(3.0 * x) * np.cos(2.0 * z) + 0.15 * 7.0 * np.cos(
        7.0 * x + 1.0
    ) * np.cos(5.0 * z)
    dfdz = -0.35 * 2.0 * np.sin(3.0 * x) * np.sin(2.0 * z) - 0.15 * 5.0 * np.sin(
        7.0 * x + 1.0
    ) * np.sin(5.0 * z)
    nrm = np.stack([-dfdx, np.ones_like(x), -dfdz], axis=-1).reshape(-1, 3)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)

    idx = np.arange(n * n).reshape(n, n)
    a, b = idx[:-1, :-1].ravel(), idx[1:, :-1].ravel()
    c, d = idx[1:, 1:].ravel(), idx[:-1, 1:].ravel()
    tris = np.concatenate(
        [np.stack([a, b, c], axis=1), np.stack([a, c, d], axis=1)]
    ).astype(np.uint32)

    # emissive quad hovering above the terrain, facing down
    v0 = len(pos)
    lamp_pos = np.array(
        [[-0.4, 2.0, -0.4], [0.4, 2.0, -0.4], [0.4, 2.0, 0.4], [-0.4, 2.0, 0.4]]
    )
    lamp_nrm = np.tile([[0.0, -1.0, 0.0]], (4, 1))
    lamp_tris = np.array(
        [[v0, v0 + 1, v0 + 2], [v0, v0 + 2, v0 + 3]], np.uint32
    )

    positions = np.concatenate([pos, lamp_pos]).astype(np.float32)
    normals = np.concatenate([nrm, lamp_nrm]).astype(np.float32)
    triangles = np.concatenate([tris, lamp_tris])
    material_ids = np.concatenate(
        [np.zeros(len(tris), np.int32), np.ones(2, np.int32)]
    )
    materials = [
        MtlRecord(name="ground", kd=(0.7, 0.7, 0.7)),
        MtlRecord(name="lamp", kd=(0.0, 0.0, 0.0), ka=(12.0, 12.0, 12.0)),
    ]
    return ObjMesh(
        positions=positions, normals=normals, triangles=triangles,
        material_ids=material_ids, materials=materials,
    )


@pytest.fixture(scope="module")
def big_scene():
    return build_scene(_terrain_mesh())


def _rays_from_above(n, key=7):
    k1, k2 = jax.random.split(jax.random.PRNGKey(key))
    o = jax.random.uniform(k1, (3, n), minval=-0.9, maxval=0.9)
    o = o.at[1].set(1.2 + 0.3 * (o[1] + 0.9) / 1.8)
    d = jax.random.normal(k2, (3, n)) * 0.35
    d = d.at[1].set(-jnp.abs(d[1]) / 0.35 - 0.8)  # steep downward: most hit
    return o, d / jnp.linalg.norm(d, axis=0, keepdims=True)


def _builders():
    out = ["lbvh"]
    if native.available():
        out.append("sah")
    return out


def test_large_scene_layout_invariants(big_scene):
    scene = big_scene
    assert scene.p0.shape[1] == 2 * (GRID - 1) ** 2 + 2
    for builder in _builders():
        lay = build_layout(scene, leaf_size=16, builder=builder)
        miss = np.asarray(lay.miss)
        counts = np.asarray(lay.tri_count)
        first = np.asarray(lay.first_tri)
        m = lay.num_nodes
        assert (miss > np.arange(m)).all()
        assert miss[0] == m
        # the 6-bit count / shifted first-row packing must round-trip at
        # 130K rows (first_tri needs 18 bits here)
        packed = np.asarray(lay.nodes)[:, 6:8].view(np.int32)
        assert (packed[:, 0] == miss).all()
        assert ((packed[:, 1] & 63) == counts).all()
        leaf = counts > 0
        assert ((packed[:, 1] >> 6)[leaf] == first[leaf]).all()
        # leaves cover every triangle exactly once
        total = counts[leaf].sum()
        assert total == lay.num_tris
        order = np.argsort(first[leaf])
        f_sorted = first[leaf][order]
        c_sorted = counts[leaf][order]
        assert f_sorted[0] == 0
        assert (f_sorted[1:] == f_sorted[:-1] + c_sorted[:-1]).all()
        assert np.bincount(
            np.asarray(lay.sorted_to_orig), minlength=lay.num_tris
        ).max() == 1


def test_large_scene_traversal_matches_brute(big_scene):
    scene = big_scene
    o, d = _rays_from_above(128)
    hb = intersect_brute(o, d, scene.p0, scene.p1, scene.p2)
    tb = np.asarray(hb.t)
    assert np.isfinite(tb).mean() > 0.6  # the ray cast actually hits
    for builder in _builders():
        lay = build_layout(scene, leaf_size=16, builder=builder)
        hv = intersect_bvh(o, d, lay)
        tv = np.asarray(hv.t)
        assert (np.isfinite(tb) == np.isfinite(tv)).all(), builder
        both = np.isfinite(tb)
        np.testing.assert_allclose(tb[both], tv[both], rtol=1e-4)
        agree = (np.asarray(hb.tri)[both] == np.asarray(hv.tri)[both]).mean()
        assert agree > 0.98, builder


@pytest.mark.slow
def test_large_scene_renders(big_scene):
    # production wavefront path (sorted pipeline, NEE + MIS) on the 130K-tri
    # scene at a tiny frame: finite, lit, and the lamp lights the terrain
    cfg = RenderConfig(
        samples_per_frame=1, max_path_length=3, intersector="bvh",
    )
    r = Renderer(big_scene, width=48, height=32, cfg=cfg)
    r.run(2)
    img = np.asarray(r.image())
    assert np.isfinite(img).all()
    assert img.mean() > 1e-4
