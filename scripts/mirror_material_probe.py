"""Recover the mirror-variant golden's WATER material.

scripts/mirror_residual_map.py localized the mirror-golden mismatch to
the water surface alone (bottom-center cells rel 1.4-35 vs ~0.03
elsewhere; golden 7x DARKER there, no tint).  A perfect mirror reflects
the lit room upward — bright; the golden's darkness says its water was
NOT the XML's conductor.  Candidates (all materials the other scenes'
goldens used): refracting dielectric, straight-through dielectric,
Mitsuba plastic at 0.5 / 1.0 albedo.

Usage:
    timeout 3000 python scripts/mirror_material_probe.py > /tmp/mirrmat.log 2>&1
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from pathtracer.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pathtracer.config import RenderConfig  # noqa: E402
from pathtracer.io.exr import read_exr  # noqa: E402
from pathtracer.render import init_state, render_frame_jit  # noqa: E402
from pathtracer.scene import golden_path, load_scene, scene_path  # noqa: E402
from pathtracer.utils.compare import downsample, metrics  # noqa: E402

H, W = 75, 100
DIFF, MIRROR, PLASTIC, DIEL = 0, 1, 2, 3


def set_water(scene, mtype, ior=0.0, kd=None):
    mt = np.asarray(scene.mat_type).copy()
    mi = np.asarray(scene.mat_ior).copy()
    md = np.asarray(scene.mat_diffuse).copy()
    mt[8], mi[8] = mtype, ior
    if kd is not None:
        md[:, 8] = kd
    return scene._replace(mat_type=jnp.asarray(mt), mat_ior=jnp.asarray(mi),
                          mat_diffuse=jnp.asarray(md))


def main():
    print(f"devices: {jax.devices()}", flush=True)
    float(jnp.ones((8, 8)).sum())

    sm = load_scene(scene_path("CornellBox-Water-mirror"))
    golds = {d: downsample(
        read_exr(golden_path("CornellBox-Water-mirror", d))[0], H, W)
        for d in (2, 3, 8)}
    variants = {
        "diel-refract": (set_water(sm, DIEL, 1.333), {"refract_dielectric": True}),
        "diel-straight": (set_water(sm, DIEL, 1.333), {}),
        "plastic-kd0.5": (set_water(sm, PLASTIC, 1.333, kd=0.5), {}),
        "plastic-kd1.0": (set_water(sm, PLASTIC, 1.333, kd=1.0), {}),
    }
    for name, (s, kw) in variants.items():
        for qk in (True, False):
            for depth in (2, 3, 8):
                cfg = RenderConfig(samples_per_frame=16, max_path_length=depth,
                                   reference_quirks=qk, **kw)
                st = init_state(H, W)
                for _ in range(16):
                    st = render_frame_jit(st, s, cfg)
                img = np.asarray(st.accum)
                m = metrics(img, golds[depth])
                print(f"{name:14s} quirks={qk} d{depth}: rel={m['rel_mse']:.4f}"
                      f" r={m['mean_ratio']:.3f}", flush=True)


if __name__ == "__main__":
    main()
