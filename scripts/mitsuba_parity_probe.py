"""Measure Water-variant parity against the Mitsuba goldens with the
goldens' OWN material tables.

The committed Mitsuba EXRs for the Water scenes were rendered from the
in-repo XMLs (assets/reference/*.xml), whose materials DIFFER from the MTL
channel hack the reference app (and our loader) decodes — e.g.
CornellBox-Water.xml makes both spheres diffuse white and the water a true
refracting dielectric, while the MTL gives rightSphere a 1.76 dielectric
(docs/PARITY.md).  The existing golden gates therefore bound rather than
match (rel_mse < 0.14 / 0.75).  This probe renders with the XML's material
assignments — substituting only framework-native BSDFs — to find how tight
the gates can become (VERDICT r4 item 7).

CPU-friendly (75x100, spp <= 64).  Prints one metrics line per experiment.

Usage:
    python scripts/mitsuba_parity_probe.py > /tmp/mitsuba_parity.log 2>&1
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
from pathtracer.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402

from pathtracer.config import RenderConfig  # noqa: E402
from pathtracer.io.exr import read_exr  # noqa: E402
from pathtracer.render import init_state, render_frame_jit  # noqa: E402
from pathtracer.scene import golden_path, load_scene, scene_path  # noqa: E402
from pathtracer.utils.compare import downsample, metrics  # noqa: E402

H, W = 75, 100


def override(scene, idx, mtype, ior=0.0, kd=None):
    mt = np.asarray(scene.mat_type).copy()
    mi = np.asarray(scene.mat_ior).copy()
    md = np.asarray(scene.mat_diffuse).copy()
    mt[idx] = mtype
    mi[idx] = ior
    if kd is not None:
        md[:, idx] = kd
    import jax.numpy as jnp

    return scene._replace(
        mat_type=jnp.asarray(mt), mat_ior=jnp.asarray(mi),
        mat_diffuse=jnp.asarray(md),
    )


def render(scene, depth, spp, **cfg_kw):
    cfg = RenderConfig(samples_per_frame=spp, max_path_length=depth, **cfg_kw)
    state = init_state(H, W)
    state = render_frame_jit(state, scene, cfg)
    return np.asarray(state.accum)


def against(img, scene_name, depth):
    gold, _ = read_exr(golden_path(scene_name, depth))
    return metrics(img, downsample(gold, H, W))


def main():
    # material type ids (models/bsdf.py): 0 diffuse, 1 mirror,
    # 2 smooth plastic, 3 smooth dielectric
    DIFF, MIRROR, PLASTIC, DIEL = 0, 1, 2, 3

    # --- CornellBox-Water: XML = diffuse white spheres + refracting water
    # (the MTL decodes water as PLASTIC 1.333 and rightSphere PLASTIC 1.76) ---
    sc = load_scene(scene_path("CornellBox-Water"))
    sx = override(sc, 1, DIFF)          # rightSphere: plastic 1.76 -> diffuse
    sx = override(sx, 8, DIEL, ior=1.333)   # water: plastic -> dielectric
    for qk in (False, True):
        img = render(sx, 8, 48, reference_quirks=qk, refract_dielectric=True)
        print("water xml-mats refract quirks=%s depth8: %s"
              % (qk, against(img, "CornellBox-Water", 8)), flush=True)
    img = render(sx, 8, 48, reference_quirks=False)
    print("water xml-mats NOrefract quirks=False depth8: %s"
          % against(img, "CornellBox-Water", 8), flush=True)

    # --- Water-mirror: MTL already == XML; quirks are the only delta ---
    sm = load_scene(scene_path("CornellBox-Water-mirror"))
    for depth in (2, 3, 8):
        img = render(sm, depth, 48, reference_quirks=False)
        print("mirror quirks=False depth%d: %s"
              % (depth, against(img, "CornellBox-Water-mirror", depth)),
              flush=True)

    # --- Water-plastic: XML = diffuse left, plastic 1.76 right, plastic
    # 1.333 water (MTL decodes: left plastic 1.5, right MIRROR, water
    # plastic 1.333).  Mitsuba's plastic defaults diffuseReflectance 0.5 ---
    sp = load_scene(scene_path("CornellBox-Water-plastic"))
    sp = override(sp, 0, DIFF)              # leftSphere -> diffuse white
    for kd in (1.0, 0.5):
        s2 = override(sp, 1, PLASTIC, ior=1.76, kd=kd)
        s2 = override(s2, 8, PLASTIC, ior=1.333, kd=kd)
        for qk in (False, True):
            img = render(s2, 2, 48, reference_quirks=qk)
            print("plastic xml-mats kd=%.1f quirks=%s depth2: %s"
                  % (kd, qk, against(img, "CornellBox-Water-plastic", 2)),
                  flush=True)


if __name__ == "__main__":
    main()
