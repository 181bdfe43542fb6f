import jax
import jax.numpy as jnp
import numpy as np

from pathtracer.core import sampling
from pathtracer.core.math3d import dot, length


def test_halton_reference_quirk():
    # The reference accumulates before dividing, so the first digit has
    # weight 1.0: halton(1, 2) == 1.0 (not the textbook 0.5).
    assert float(sampling.halton(jnp.uint32(1), 2)) == 1.0
    # halton(5, 2): digits (lsb first) 1,0,1 -> 1*1 + 0*0.5 + 1*0.25
    assert float(sampling.halton(jnp.uint32(5), 2)) == 1.25
    assert float(sampling.halton(jnp.uint32(0), 2)) == 0.0


def test_van_der_corput_reference_quirk():
    # baseInv squares each iteration: vdc(3, 2) = 1*0.5 + 1*0.25 = 0.75
    assert float(sampling.van_der_corput(jnp.uint32(3), 2)) == 0.75
    # vdc(7,2) = 0.5 + 0.25 + 0.0625
    assert float(sampling.van_der_corput(jnp.uint32(7), 2)) == 0.8125


def test_balance_heuristic_is_power2():
    f, g = jnp.float32(0.3), jnp.float32(0.7)
    expected = 0.09 / (0.09 + 0.49)
    assert np.isclose(float(sampling.balance_heuristic(f, g)), expected, rtol=1e-6)
    assert float(sampling.balance_heuristic(jnp.float32(1.0), jnp.float32(0.0))) == 1.0


def test_barycentric_valid_and_uniform():
    key = jax.random.PRNGKey(0)
    smp = jax.random.uniform(key, (2, 4096))
    w = np.asarray(sampling.barycentric(smp))  # (3, N)
    assert np.allclose(w.sum(0), 1.0, atol=1e-6)
    assert (w >= 0).all()
    # uniform area sampling -> mean weight 1/3 per vertex
    assert np.allclose(w.mean(1), 1.0 / 3.0, atol=0.02)


def test_orthonormal_basis():
    key = jax.random.PRNGKey(1)
    n = jax.random.normal(key, (3, 512))
    n = n / jnp.linalg.norm(n, axis=0, keepdims=True)
    u, v = sampling.build_orthonormal_basis(n)
    assert np.allclose(np.asarray(length(u)), 1.0, atol=1e-5)
    assert np.allclose(np.asarray(length(v)), 1.0, atol=1e-5)
    for a, b in ((u, v), (u, n), (v, n)):
        assert np.abs(np.asarray(dot(a, b))).max() < 1e-5


def test_diffuse_bounce_cosine_distribution():
    key = jax.random.PRNGKey(2)
    n_samples = 200_000
    smp = jax.random.uniform(key, (2, n_samples))
    n = jnp.broadcast_to(jnp.array([[0.0], [0.0], [1.0]]), (3, n_samples))
    d = sampling.generate_diffuse_bounce(smp, n)  # (3, N)
    cos = np.asarray(d[2])
    assert (cos >= 0).all()
    # cosine-weighted hemisphere: E[cos] = 2/3
    assert np.isclose(cos.mean(), 2.0 / 3.0, atol=0.01)
    # azimuthal symmetry
    assert abs(np.asarray(d[0]).mean()) < 0.01
    assert abs(np.asarray(d[1]).mean()) < 0.01


def test_select_light_index_matches_linear_walk():
    # Exclusive-prefix cdf with sentinel, as built by the light-table builder.
    pdf = np.array([0.125, 0.5, 0.25, 0.125], np.float32)
    cdf = np.concatenate([[0.0], np.cumsum(pdf)]).astype(np.float32)  # len 5

    def linear_walk(xi):  # reference: renderer/KernelHelpers.h:49-54
        index = 0
        while index < len(pdf) and cdf[index + 1] <= xi:
            index += 1
        return index

    xs = np.linspace(0.0, 0.999, 77).astype(np.float32)
    got = np.asarray(sampling.select_light_index(jnp.asarray(xs), jnp.asarray(cdf)))
    expected = np.array([linear_walk(x) for x in xs])
    assert (got == expected).all()
    assert (got < len(pdf)).all()


def test_triangle_sample_pdf():
    v = sampling.triangle_sample_pdf(
        jnp.float32(2.0), jnp.float32(0.5), jnp.float32(3.0)
    )
    assert np.isclose(float(v), 9.0 / 1.0, rtol=1e-6)


def _chi_square(observed, expected):
    observed = np.asarray(observed, np.float64)
    expected = np.asarray(expected, np.float64)
    return float(((observed - expected) ** 2 / expected).sum())


def test_chi_square_cosine_hemisphere():
    """Goodness-of-fit for the cosine-weighted hemisphere sampler
    (SURVEY.md §4: chi-square tests for samplers).  For pdf cos(t)/pi the
    polar CDF is sin^2(t), so binning sin^2(t) uniformly gives
    equal-probability bins; azimuth is uniform."""
    import jax

    from pathtracer.core.sampling import generate_diffuse_bounce

    n = 200_000
    u = jax.random.uniform(jax.random.PRNGKey(3), (2, n))
    normal = jnp.zeros((3, n)).at[2].set(1.0)
    d = np.asarray(generate_diffuse_bounce(u, normal))
    assert (d[2] >= 0).all()

    k = 20
    # chi-square 0.999 quantile for k-1=19 dof ~ 43.8; use 50 for margin
    crit = 50.0
    sin2 = 1.0 - np.clip(d[2], 0, 1) ** 2
    obs, _ = np.histogram(sin2, bins=np.linspace(0, 1, k + 1))
    assert _chi_square(obs, np.full(k, n / k)) < crit, obs

    phi = np.arctan2(d[1], d[0])
    obs, _ = np.histogram(phi, bins=np.linspace(-np.pi, np.pi, k + 1))
    assert _chi_square(obs, np.full(k, n / k)) < crit, obs


def test_chi_square_light_selection():
    """CDF light pick frequencies must match the area-proportional pdf
    (reference table semantics, Renderer.mm:434-448)."""
    import jax

    from pathtracer.core.sampling import select_light_index
    from pathtracer.scene import load_scene, scene_path

    scene = load_scene(scene_path("cornellbox"))
    pdf = np.asarray(scene.light_pdf)[:-1]  # drop sentinel
    n = 200_000
    u = jax.random.uniform(jax.random.PRNGKey(11), (n,))
    li = np.asarray(select_light_index(u, scene.light_cdf))
    obs = np.bincount(li, minlength=len(pdf) + 1)[: len(pdf)]
    # 0.999 quantile for len(pdf)-1 dof is < 21 for the bundled scenes
    assert _chi_square(obs, pdf * n) < 25.0, (obs, pdf * n)
