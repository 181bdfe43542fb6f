"""Fail-fast guards: config validation and the sort lowerings."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.config import RenderConfig
from pathtracer.render import wavefront as wf


def test_config_string_knobs_validated():
    for field, bad in [("sort_lowering", "bitonic"), ("sampler", "halton"),
                       ("intersector", "mps")]:
        with pytest.raises(ValueError):
            RenderConfig(**{field: bad})
    RenderConfig()  # defaults pass


def test_gather_sort_lowering_bit_identical():
    """sort_lowering="gather" (argsort + per-plane takes) must reproduce the
    variadic lax.sort bit-for-bit: lax.sort is stable, so the sorted iota
    payload IS the permutation the variadic form applies to every plane."""
    rng = np.random.default_rng(7)
    n, s = 64, 2
    o = jnp.asarray(rng.standard_normal((3, n)), jnp.float32)
    d = jnp.asarray(rng.standard_normal((3, n)), jnp.float32)
    d = d / jnp.linalg.norm(d, axis=0, keepdims=True)
    st = wf.initial_path_state(o, d, s)
    # scramble alive/pixel so the key has real structure and ties
    st = st._replace(
        alive=jnp.asarray(rng.random(n) < 0.5),
        pixel=jnp.asarray(rng.integers(0, 8, n), jnp.int32),
    )
    pack = wf.ShadowPack(
        to_light=jnp.asarray(rng.standard_normal((3, n)), jnp.float32),
        cap=jnp.asarray(rng.random(n), jnp.float32),
        target=jnp.asarray(rng.integers(-1, 3, n), jnp.int32),
        contrib=jnp.asarray(rng.random((s, n)), jnp.float32),
        ok=jnp.asarray(rng.random(n) < 0.5),
    )
    wmin, winv = (-2.0, -2.0, -2.0), (0.25, 0.25, 0.25)
    a_st, a_pk = wf.sort_wavefront(st, wmin, winv, pack, lowering="variadic")
    b_st, b_pk = wf.sort_wavefront(st, wmin, winv, pack, lowering="gather")
    for a, b in zip(jax.tree.leaves((a_st, a_pk)), jax.tree.leaves((b_st, b_pk))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # pack-less path too
    a2 = wf.sort_wavefront(st, wmin, winv, lowering="variadic")
    b2 = wf.sort_wavefront(st, wmin, winv, lowering="gather")
    for a, b in zip(jax.tree.leaves(a2), jax.tree.leaves(b2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
