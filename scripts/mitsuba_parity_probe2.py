"""Mitsuba-parity probe round 2: high-spp on the accelerator.

Follow-ups to scripts/mitsuba_parity_probe.py (CPU, spp48), which
recovered the Water-plastic golden's material table (XML assignments at
Mitsuba's default diffuseReflectance 0.5 -> rel_mse 0.0068):

  1. WATER golden recovery attempt: the same recipe applied to
     CornellBox-Water — the MTL decode (plastic water 1.333, plastic right
     sphere 1.76) already lands 1.045/0.090, so test whether 0.5 albedos
     (Mitsuba plastic default) close it the way they closed the plastic
     variant, at depth 8 and high spp.
  2. MIRROR noise-vs-bias split: materials already match the XML exactly;
     spp48 measures rel_mse 0.23-0.29 at mean_ratio 1.02-1.04.  If
     rel_mse falls with spp (-> noise), the CPU test band is honest; if it
     plateaus (-> bias), there is a real estimator delta worth hunting.

Runs the production pipeline at golden comparison size (75x100 via
downsampled 800x600?  No: render AT 75x100 directly, matching the CPU
tests' geometry so numbers are comparable).

Usage:
    timeout 3000 python scripts/mitsuba_parity_probe2.py > /tmp/parity2.log 2>&1
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


def override(scene, idx, mtype=None, ior=None, kd=None):
    mt = np.asarray(scene.mat_type).copy()
    mi = np.asarray(scene.mat_ior).copy()
    md = np.asarray(scene.mat_diffuse).copy()
    if mtype is not None:
        mt[idx] = mtype
    if ior is not None:
        mi[idx] = ior
    if kd is not None:
        md[:, idx] = kd
    return scene._replace(
        mat_type=jnp.asarray(mt), mat_ior=jnp.asarray(mi),
        mat_diffuse=jnp.asarray(md),
    )


def render(scene, depth, spp, frames=1, **cfg_kw):
    """Accumulate ``frames`` progressive frames of ``spp`` each (fused spp
    has an HBM/compile budget; frames are cheap and average like spp)."""
    cfg = RenderConfig(samples_per_frame=spp, max_path_length=depth, **cfg_kw)
    state = init_state(H, W)
    for _ in range(frames):
        state = render_frame_jit(state, scene, cfg)
    return np.asarray(state.accum)


def against(img, scene_name, depth):
    gold, _ = read_exr(golden_path(scene_name, depth))
    return metrics(img, downsample(gold, H, W))


def main():
    print(f"devices: {jax.devices()}", flush=True)
    float(jnp.ones((8, 8)).sum())
    print("device execute OK", flush=True)
    DIFF, PLASTIC = 0, 2

    # --- 1: Water golden recovery (plastic-variant recipe at depth 8) ---
    sc = load_scene(scene_path("CornellBox-Water"))
    tries = {
        "mtl-as-is": sc,
        "kd0.5-water": override(sc, 8, kd=0.5),
        "kd0.5-both": override(override(sc, 8, kd=0.5), 1, kd=0.5),
        "xml+kd0.5": override(
            override(override(sc, 1, mtype=DIFF, ior=0.0), 8, kd=0.5),
            8, mtype=PLASTIC, ior=1.333),
    }
    for name, s in tries.items():
        for qk in (True, False):
            img = render(s, 8, 16, frames=16, reference_quirks=qk)
            print(f"water {name:12s} quirks={qk} spp256: "
                  f"{against(img, 'CornellBox-Water', 8)}", flush=True)

    # --- 2: mirror noise-vs-bias (materials already match the XML) ---
    sm = load_scene(scene_path("CornellBox-Water-mirror"))
    for depth in (3,):
        for spp_total, frames in ((48, 3), (256, 16), (1024, 64)):
            img = render(sm, depth, 16, frames=frames, reference_quirks=False)
            print(f"mirror d{depth} quirks=False spp{spp_total}: "
                  f"{against(img, 'CornellBox-Water-mirror', depth)}",
                  flush=True)


if __name__ == "__main__":
    main()
