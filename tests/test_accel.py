"""BVH build + traversal correctness: the XLA walker and the GPU traversal
kernel (Pallas, Triton route, run here in interpret mode) against the
brute-force oracle and against each other."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.accel import build_layout
from pathtracer.ops.intersect import intersect_brute
from pathtracer.ops.traverse import intersect_bvh
from pathtracer.scene import load_scene, scene_path


def _random_rays(n, key=1):
    k1, k2 = jax.random.split(jax.random.PRNGKey(key))
    o = jax.random.uniform(k1, (3, n), minval=-0.9, maxval=0.9).at[1].add(1.0)
    d = jax.random.normal(k2, (3, n))
    return o, d / jnp.linalg.norm(d, axis=0, keepdims=True)


@pytest.fixture(scope="module", params=["cornellbox", "CornellBox-Water-plastic"])
def scene_and_layout(request):
    scene = load_scene(scene_path(request.param))
    return scene, build_layout(scene, leaf_size=4)


def test_layout_invariants(scene_and_layout):
    scene, lay = scene_and_layout
    miss = np.asarray(lay.miss)
    counts = np.asarray(lay.tri_count)
    first = np.asarray(lay.first_tri)
    m = lay.num_nodes
    # escape links point strictly forward; root escapes to the sentinel
    assert (miss > np.arange(m)).all()
    assert miss[0] == m
    # leaves cover every triangle exactly once
    leaf = counts > 0
    spans = []
    for f, c in zip(first[leaf], counts[leaf]):
        spans.extend(range(f, f + c))
    assert sorted(spans) == list(range(lay.num_tris))
    # sorted_to_orig is a permutation
    assert sorted(np.asarray(lay.sorted_to_orig)) == list(range(lay.num_tris))
    # the node rows' packed int fields decode to the component-major copies
    packed = np.asarray(lay.nodes)[:, 6:8].view(np.int32)
    assert (packed[:, 0] == miss).all()
    assert ((packed[:, 1] & 63) == counts).all()
    assert ((packed[:, 1] >> 6)[leaf] == first[leaf]).all()
    # triangle rows hold p0 and the two edges of the sorted triangles
    tris = np.asarray(lay.tris)
    np.testing.assert_array_equal(tris[:, 0:3], np.asarray(lay.p0).T)
    np.testing.assert_array_equal(
        tris[:, 3:6], (np.asarray(lay.p1) - np.asarray(lay.p0)).T)


def test_traversal_matches_brute(scene_and_layout):
    scene, lay = scene_and_layout
    o, d = _random_rays(1024)
    hb = intersect_brute(o, d, scene.p0, scene.p1, scene.p2)
    hv = intersect_bvh(o, d, lay)
    tb, tv = np.asarray(hb.t), np.asarray(hv.t)
    assert (np.isfinite(tb) == np.isfinite(tv)).all()
    both = np.isfinite(tb)
    np.testing.assert_allclose(tb[both], tv[both], rtol=1e-4)
    # indices agree except for coplanar shared-edge ties (equal t)
    agree = (np.asarray(hb.tri)[both] == np.asarray(hv.tri)[both]).mean()
    assert agree > 0.98


def test_traversal_active_mask(scene_and_layout):
    scene, lay = scene_and_layout
    o, d = _random_rays(512)
    act = jnp.arange(512) % 2 == 0
    hm = intersect_bvh(o, d, lay, active=act)
    hv = intersect_bvh(o, d, lay)
    tm, tv = np.asarray(hm.t), np.asarray(hv.t)
    assert not np.isfinite(tm[1::2]).any()
    np.testing.assert_allclose(tm[0::2], tv[0::2], rtol=1e-5)


# ---------------------------------------------------------------------------
# The GPU traversal kernel (ops/bvh_kernel.py), in Pallas interpret mode.
# Every case is parametrised over the five bundled scenes and stays at or
# below 4,096 lanes.
# ---------------------------------------------------------------------------

from pathtracer.ops.bvh_kernel import BLOCK, intersect_bvh_kernel  # noqa: E402
from pathtracer.scene.assets import SCENE_NAMES  # noqa: E402


@pytest.fixture(scope="module", params=SCENE_NAMES)
def kscene(request):
    scene = load_scene(scene_path(request.param))
    return scene, build_layout(scene, leaf_size=8)


def _kernel(o, d, lay, **kw):
    return intersect_bvh_kernel(o, d, lay, interpret=True, **kw)


def _same_hits(a, b):
    """Kernel and walker walk the same tree in the same order: identical
    hit sets and triangles; distances equal up to the two compilers'
    different fma contraction of the same Moller-Trumbore arithmetic."""
    ta, tb = np.asarray(a.t), np.asarray(b.t)
    np.testing.assert_array_equal(np.isfinite(ta), np.isfinite(tb))
    hit = np.isfinite(ta)
    np.testing.assert_array_equal(np.asarray(a.tri)[hit], np.asarray(b.tri)[hit])
    np.testing.assert_allclose(ta[hit], tb[hit], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(a.u)[hit], np.asarray(b.u)[hit],
                               atol=1e-5)


def _agrees_with_brute(h, hb):
    th, tb = np.asarray(h.t), np.asarray(hb.t)
    np.testing.assert_array_equal(np.isfinite(th), np.isfinite(tb))
    both = np.isfinite(tb)
    np.testing.assert_allclose(th[both], tb[both], rtol=1e-4, atol=1e-6)
    # triangle ids agree except coplanar shared-edge ties (equal t)
    assert (np.asarray(h.tri)[both] == np.asarray(hb.tri)[both]).mean() > 0.98


def test_kernel_nearest_hit(kscene):
    scene, lay = kscene
    o, d = _random_rays(4096, key=5)
    hk = _kernel(o, d, lay)
    _agrees_with_brute(hk, intersect_brute(o, d, scene.p0, scene.p1, scene.p2))
    _same_hits(hk, intersect_bvh(o, d, lay))


def test_kernel_capped_occlusion(kscene):
    """t_max seeds best_t: only hits strictly inside the cap are reported,
    and they are the brute oracle's nearest hits."""
    scene, lay = kscene
    o, d = _random_rays(2048, key=11)
    hb = intersect_brute(o, d, scene.p0, scene.p1, scene.p2)
    tb = np.asarray(hb.t)
    # half the lanes capped past their nearest hit, half short of it
    cap = jnp.where(jnp.isfinite(hb.t),
                    hb.t * jnp.where(jnp.arange(2048) % 2 == 0, 1.25, 0.8),
                    2.0)
    hk = _kernel(o, d, lay, t_max=cap)
    tk = np.asarray(hk.t)
    within = np.isfinite(tb) & (tb < np.asarray(cap))
    np.testing.assert_array_equal(np.isfinite(tk), within)
    np.testing.assert_allclose(tk[within], tb[within], rtol=1e-4, atol=1e-6)
    assert (np.asarray(hk.tri)[within] == np.asarray(hb.tri)[within]).mean() > 0.98
    _same_hits(hk, intersect_bvh(o, d, lay, t_max=cap))


def test_kernel_active_mask(kscene):
    scene, lay = kscene
    o, d = _random_rays(1024, key=13)
    act = jnp.arange(1024) % 3 != 0
    hm = _kernel(o, d, lay, active=act)
    assert not np.isfinite(np.asarray(hm.t)[~np.asarray(act)]).any()
    _same_hits(hm, intersect_bvh(o, d, lay, active=act))


def test_kernel_pads_partial_block(kscene):
    """N not a multiple of the block: the wrapper pads with inactive lanes
    and slices them off; every real lane matches the walker."""
    scene, lay = kscene
    n = 3 * BLOCK + 7
    o, d = _random_rays(n, key=17)
    hk = _kernel(o, d, lay)
    assert hk.t.shape == (n,) and hk.tri.shape == (n,)
    _same_hits(hk, intersect_bvh(o, d, lay))


def test_kernel_far_from_origin(kscene):
    """A scene translated 1e4..3e4 units from the world origin keeps the
    oracle's hits (Moller-Trumbore is translation-invariant)."""
    scene, _ = kscene
    shift = jnp.asarray([1.0e4, -2.0e4, 3.0e4], jnp.float32)[:, None]
    far = scene._replace(
        p0=scene.p0 + shift, p1=scene.p1 + shift, p2=scene.p2 + shift)
    lay = build_layout(far, leaf_size=8)
    o, d = _random_rays(1024, key=9)
    o = o + shift
    hk = _kernel(o, d, lay)
    hb = intersect_brute(o, d, far.p0, far.p1, far.p2)
    tk, tb = np.asarray(hk.t), np.asarray(hb.t)
    np.testing.assert_array_equal(np.isfinite(tk), np.isfinite(tb))
    both = np.isfinite(tb)
    np.testing.assert_allclose(tk[both], tb[both], rtol=2e-4, atol=1e-6)
    assert (np.asarray(hk.tri)[both] == np.asarray(hb.tri)[both]).mean() > 0.98
    _same_hits(hk, intersect_bvh(o, d, lay))


def _nee_queries(scene, n, key):
    """NEE-shaped shadow queries: origins on surface points, directions to
    sampled points on real light triangles, caps just past the light
    (trace_bounce's dist + 4 eps), every 5th lane an env-style unbounded
    query (target -1)."""
    eps = 1e-4
    o0, d0 = _random_rays(n, key=key)
    hb = intersect_brute(o0, d0, scene.p0, scene.p1, scene.p2)
    ok = jnp.isfinite(hb.t)
    origin = o0 + jnp.where(ok, hb.t, 1.0)[None] * d0 - d0 * eps
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(key + 1), 3)
    num_lights = int(scene.light_tri.shape[0]) - 1
    li = jax.random.randint(k1, (n,), 0, max(num_lights, 1))
    tgt = scene.light_tri[li].astype(jnp.int32)
    r1 = jax.random.uniform(k2, (n,))
    r2 = jax.random.uniform(k3, (n,))
    su = 1.0 - jnp.sqrt(r1)
    sv = jnp.sqrt(r1) * r2
    p0, p1, p2 = scene.p0[:, tgt], scene.p1[:, tgt], scene.p2[:, tgt]
    lp = p0 + su[None] * (p1 - p0) + sv[None] * (p2 - p0)
    delta = lp - origin
    dist = jnp.linalg.norm(delta, axis=0)
    to_light = delta / jnp.maximum(dist, 1e-12)[None]
    is_env = jnp.arange(n) % 5 == 0
    tgt = jnp.where(is_env, -1, tgt)
    cap = jnp.where(is_env, 1e30, dist + 4.0 * eps)
    return origin, to_light, ok, cap, tgt, eps


def test_kernel_occlusion_clear_matches_walker(kscene):
    """occlusion_clear (nearest-hit-within-cap must be the target) gives the
    same visibility through the kernel as through the walker."""
    from pathtracer.ops.traverse import make_bvh_intersector
    from pathtracer.render.wavefront import occlusion_clear

    scene, lay = kscene
    o, d, ok, cap, tgt, eps = _nee_queries(scene, 2048, key=23)
    walker = make_bvh_intersector(lay, scene)
    kernel = make_bvh_intersector(
        lay, scene, traverse=lambda *a, **kw: _kernel(*a, **kw))
    ck = np.asarray(occlusion_clear(kernel, o, d, ok, cap, tgt, eps))
    cw = np.asarray(occlusion_clear(walker, o, d, ok, cap, tgt, eps))
    np.testing.assert_array_equal(ck, cw)
    assert not ck[~np.asarray(ok)].any()


@pytest.mark.parametrize("block", [32, 64, 128])
def test_kernel_block_size_is_execution_order_only(block):
    """The block size changes which lanes share a loop, never a lane's
    result."""
    scene = load_scene(scene_path("CornellBox-Water-plastic"))
    lay = build_layout(scene, leaf_size=8)
    o, d = _random_rays(1000, key=19)
    cap = jnp.full((1000,), 1.5)
    ref = _kernel(o, d, lay, t_max=cap)
    hb = _kernel(o, d, lay, t_max=cap, block=block)
    for a, b in zip(ref, hb):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("scene_name", ["cornellbox", "CornellBox-Water-plastic"])
def test_full_frame_kernel_matches_walker(scene_name):
    """One frame through the full sorted-wavefront pipeline (live-prefix
    ladder, deferred shadow packs, raster restore) with the kernel ==
    the same frame with the XLA walker."""
    from pathtracer.config import RenderConfig
    from pathtracer.models.camera import Camera
    from pathtracer.render.state import init_state, render_frame
    from pathtracer.render.wavefront import make_intersector

    scene = load_scene(scene_path(scene_name))
    cfg = RenderConfig(samples_per_frame=1, max_path_length=3, leaf_size=8)
    lay = build_layout(scene, leaf_size=8)
    cam = Camera.reference_default()
    kernel = make_intersector(scene, cfg, lay, traverse=_kernel)
    walker = make_intersector(scene, cfg, lay)
    assert kernel.backend == "given" and walker.backend == "walker"
    out_k = render_frame(init_state(24, 32), scene, cfg, cam, kernel)
    out_w = render_frame(init_state(24, 32), scene, cfg, cam, walker)
    accum_k, accum_w = np.asarray(out_k.accum), np.asarray(out_w.accum)
    assert np.isfinite(accum_k).all() and accum_k.mean() > 0
    np.testing.assert_allclose(accum_k, accum_w, atol=2e-5)


class _FakeDevice:
    def __init__(self, platform):
        self.platform = platform


@pytest.mark.parametrize("platform,intersector,expect", [
    ("gpu", "bvh", "kernel"),
    ("cpu", "bvh", "walker"),
    ("gpu", "brute", "brute"),
    ("metal", "bvh", RuntimeError),
    ("rocm", "bvh", RuntimeError),
])
def test_backend_chosen_in_one_place(monkeypatch, platform, intersector,
                                     expect):
    """gpu -> the kernel, cpu -> the walker, anything else -> an error (no
    silent fallback); brute force is the user's explicit choice."""
    from pathtracer.config import RenderConfig
    from pathtracer.render import wavefront as wf

    cfg = RenderConfig(intersector=intersector)
    scene = load_scene(scene_path("cornellbox"))
    lay = build_layout(scene, leaf_size=4)
    monkeypatch.setattr(wf.jax, "devices", lambda: [_FakeDevice(platform)])
    if expect is RuntimeError:
        with pytest.raises(RuntimeError, match=platform):
            wf.make_intersector(scene, cfg, lay)
        return
    assert wf.traversal_backend(cfg) == expect
    assert wf.make_intersector(scene, cfg, lay).backend == expect


def test_traverse_seam_bypasses_platform_choice(monkeypatch):
    """A given ``traverse`` is used as is, whatever the platform: the seam
    the GPU smoke run uses to render with the XLA walker."""
    from pathtracer.config import RenderConfig
    from pathtracer.render import wavefront as wf

    scene = load_scene(scene_path("cornellbox"))
    lay = build_layout(scene, leaf_size=4)
    calls = []

    def traverse(*args, **kw):
        calls.append(kw.get("t_max"))
        return intersect_bvh(*args, **kw)

    monkeypatch.setattr(wf.jax, "devices", lambda: [_FakeDevice("metal")])
    fn = wf.make_intersector(scene, RenderConfig(), lay, traverse=traverse)
    assert fn.backend == "given"
    o, d = _random_rays(256)
    act = jnp.ones((256,), bool)
    ref = wf.make_bvh_intersector(lay, scene)(o, d, act)
    got = fn(o, d, act)
    assert calls == [None]
    np.testing.assert_array_equal(np.asarray(got.t), np.asarray(ref.t))


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is configured;
    without it the cache goes to the fixed in-checkout directory."""
    from pathtracer.utils import compile_cache as cc

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    if env_set:
        monkeypatch.setenv(cc.ENV_VAR, str(tmp_path))
        assert cc.enable_compile_cache() == str(tmp_path)
        assert cc.compile_cache_dir() == str(tmp_path)
        assert calls == []
    else:
        monkeypatch.delenv(cc.ENV_VAR, raising=False)
        assert cc.enable_compile_cache() == cc.DEFAULT_DIR
        assert ("jax_compilation_cache_dir", cc.DEFAULT_DIR) in calls
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert cc.DEFAULT_DIR == os.path.join(repo, ".jax_cache")
        with open(os.path.join(repo, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
