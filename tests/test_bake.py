"""cfg.bake_materials: material constants baked into per-triangle rows must be
an exact, bit-identical replacement for the select_cols chains."""

import jax
import jax.numpy as jnp
import numpy as np

from pathtracer.accel import build_layout
from pathtracer.config import RenderConfig
from pathtracer.ops.intersect import Hit, shade_from_scene
from pathtracer.ops.tables import select_cols
from pathtracer.render.wavefront import (
    initial_path_state, make_brute_intersector, trace_bounce,
)
from pathtracer.render.noise import bounce_uniforms
from pathtracer.scene import load_scene, scene_path


def test_baked_resolve_matches_chains():
    scene = load_scene(scene_path("CornellBox-Water-plastic"))
    lay_plain = build_layout(scene, leaf_size=8)
    lay_bake = build_layout(scene, leaf_size=8, bake_materials=True)
    assert lay_plain.matrows is None and lay_bake.matrows is not None
    s, has_rough = lay_bake.matmeta
    assert s == scene.mat_diffuse.shape[0]
    assert has_rough == (scene.mat_roughness is not None)

    # synthetic hits on random triangles, plus a sprinkling of misses
    n = 512
    tri = jax.random.randint(jax.random.PRNGKey(3), (n,), 0, lay_plain.num_tris)
    t = jnp.full((n,), 1.25, jnp.float32).at[::7].set(jnp.inf)
    u = jnp.full((n,), 0.25, jnp.float32)
    hit = Hit(t=t, tri=tri.astype(jnp.int32), u=u, v=u)

    hp = shade_from_scene(scene, hit, lay_plain)
    hb = shade_from_scene(scene, hit, lay_bake)

    # geometry identical
    for a, b in [(hp.t, hb.t), (hp.u, hb.u), (hp.v, hb.v), (hp.tri, hb.tri),
                 (hp.mat, hb.mat), (hp.light, hb.light), (hp.pos, hb.pos),
                 (hp.normal, hb.normal)]:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # baked material payload == the chain lookups, bit for bit
    assert hp.mataux is None and hb.mataux is not None
    mat = hb.mat
    np.testing.assert_array_equal(
        np.asarray(hb.mataux["diffuse"]),
        np.asarray(select_cols(scene.mat_diffuse, mat)))
    np.testing.assert_array_equal(
        np.asarray(hb.mataux["emissive"]),
        np.asarray(select_cols(scene.mat_emissive, mat)))
    np.testing.assert_array_equal(
        np.asarray(hb.mataux["ior"]),
        np.asarray(select_cols(scene.mat_ior, mat)))
    np.testing.assert_array_equal(
        np.asarray(hb.mataux["mtype"]),
        np.asarray(select_cols(scene.mat_type, mat)))
    if has_rough:
        np.testing.assert_array_equal(
            np.asarray(hb.mataux["rough"]),
            np.asarray(select_cols(scene.mat_roughness, mat)))


def test_trace_bounce_mataux_bit_identical():
    """trace_bounce through the mataux branch == the select_cols branch."""
    scene = load_scene(scene_path("cornellbox"))
    cfg = RenderConfig(intersector="brute")
    n = 256
    k = jax.random.PRNGKey(11)
    o = jax.random.uniform(k, (3, n), minval=-0.8, maxval=0.8).at[1].add(1.0)
    d = jax.random.normal(jax.random.fold_in(k, 1), (3, n))
    d = d / jnp.linalg.norm(d, axis=0, keepdims=True)
    state = initial_path_state(o, d, scene.mat_diffuse.shape[0])
    uni = bounce_uniforms(cfg, jax.random.PRNGKey(5), jnp.int32(0),
                          jnp.int32(1), state.pixel, 16, 16)

    intersect = make_brute_intersector(scene)
    hit = intersect(o, d, state.alive)
    mat = hit.mat
    mataux = {
        "diffuse": select_cols(scene.mat_diffuse, mat),
        "emissive": select_cols(scene.mat_emissive, mat),
        "ior": select_cols(scene.mat_ior, mat),
        "mtype": select_cols(scene.mat_type, mat),
    }
    hit_baked = hit._replace(mataux=mataux)

    fixed = lambda *a, **kw: hit
    fixed_baked = lambda *a, **kw: hit_baked
    out_a = trace_bounce(scene, cfg, fixed, jnp.int32(1), state, uni)
    out_b = trace_bounce(scene, cfg, fixed_baked, jnp.int32(1), state, uni)
    for a, b in zip(jax.tree_util.tree_leaves(out_a),
                    jax.tree_util.tree_leaves(out_b)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
