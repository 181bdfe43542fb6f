import jax
import jax.numpy as jnp
import numpy as np

from pathtracer.ops.intersect import intersect_brute, moller_trumbore
from pathtracer.scene import load_scene, scene_path


def _numpy_oracle(o, d, p0, p1, p2, t_min=0.0):
    """Readable O(N*T) nearest-hit reference.  o/d: (N,3); p*: (T,3)."""
    e1, e2 = p1 - p0, p2 - p0
    best_t = np.full(len(o), np.inf)
    best_i = np.zeros(len(o), np.int32)
    for ti in range(len(p0)):
        pvec = np.cross(d, e2[ti])
        det = (e1[ti] * pvec).sum(-1)
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = np.where(det != 0, 1.0 / det, 0.0)
            tvec = o - p0[ti]
            u = (tvec * pvec).sum(-1) * inv
            qvec = np.cross(tvec, e1[ti])
            v = (d * qvec).sum(-1) * inv
            t = (e2[ti] * qvec).sum(-1) * inv
        ok = (det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > t_min)
        better = ok & (t < best_t)
        best_t = np.where(better, t, best_t)
        best_i = np.where(better, ti, best_i)
    return best_t, best_i


def test_single_triangle_hit_miss():
    p0 = jnp.array([[0.0], [0.0], [0.0]])
    e1 = jnp.array([[1.0], [0.0], [0.0]])
    e2 = jnp.array([[0.0], [1.0], [0.0]])
    o = jnp.array([[0.25, 2.0, 0.25], [0.25, 2.0, 0.25], [1.0, 1.0, -1.0]])
    d = jnp.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [-1.0, -1.0, 1.0]])
    t, u, v = moller_trumbore(o, d, p0, e1, e2)
    assert np.isclose(float(t[0, 0]), 1.0)
    assert np.isclose(float(u[0, 0]), 0.25) and np.isclose(float(v[0, 0]), 0.25)
    assert np.isinf(float(t[1, 0]))  # outside the triangle
    # double-sided: hit from behind too
    assert np.isclose(float(t[2, 0]), 1.0)


def test_brute_matches_oracle_on_cornellbox():
    scene = load_scene(scene_path("cornellbox"))
    p0, p1, p2 = (np.asarray(x).T for x in (scene.p0, scene.p1, scene.p2))
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    o = np.array(jax.random.uniform(k1, (256, 3), minval=-0.9, maxval=0.9))
    o[:, 1] += 1.0  # inside the box
    d = np.array(jax.random.normal(k2, (256, 3)))
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    hit = intersect_brute(
        jnp.asarray(o.T), jnp.asarray(d.T), scene.p0, scene.p1, scene.p2
    )
    ot, oi = _numpy_oracle(o, d, p0, p1, p2)
    np.testing.assert_allclose(np.asarray(hit.t), ot, rtol=1e-4)
    finite = np.isfinite(ot)
    assert (np.asarray(hit.tri)[finite] == oi[finite]).all()
    # most interior rays hit geometry (the box is open toward +z)
    assert finite.mean() > 0.8


def test_brute_chunking_consistency():
    scene = load_scene(scene_path("CornellBox-Water-plastic"))
    key = jax.random.PRNGKey(3)
    o = jnp.broadcast_to(jnp.array([[0.0], [1.0], [2.35]]), (3, 64))
    d = jax.random.normal(key, (3, 64))
    d = d / jnp.linalg.norm(d, axis=0, keepdims=True)
    h1 = intersect_brute(o, d, scene.p0, scene.p1, scene.p2, chunk=128)
    h2 = intersect_brute(o, d, scene.p0, scene.p1, scene.p2, chunk=1024)
    np.testing.assert_allclose(np.asarray(h1.t), np.asarray(h2.t), rtol=1e-5)
    both = np.isfinite(np.asarray(h1.t))
    assert (np.asarray(h1.tri)[both] == np.asarray(h2.tri)[both]).all()


def test_barycentric_convention():
    # position reconstructed from (1-u-v, u, v) weights equals o + t*d
    scene = load_scene(scene_path("cornellbox"))
    o = jnp.array([[0.0], [1.0], [2.35]])
    d = jnp.array([[0.1], [-0.2], [-1.0]])
    d = d / jnp.linalg.norm(d)
    hit = intersect_brute(o, d, scene.p0, scene.p1, scene.p2)
    uvw = np.asarray(hit.uvw)[:, 0]
    ti = int(hit.tri[0])
    p = (
        uvw[0] * np.asarray(scene.p0)[:, ti]
        + uvw[1] * np.asarray(scene.p1)[:, ti]
        + uvw[2] * np.asarray(scene.p2)[:, ti]
    )
    expected = np.asarray(o[:, 0] + hit.t[0] * d[:, 0])
    np.testing.assert_allclose(p, expected, atol=1e-5)
