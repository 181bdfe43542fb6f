"""Mitsuba-parity probe round 3: the mirror residual is BIAS, find it.

probe2 showed mirror-vs-golden rel_mse plateaus at ~0.248 from spp256 to
spp1024 (ratio ~1.04) — a structural difference, not noise, despite the
materials matching the XML exactly.  Prime suspect: specular-depth
conventions (several renderers do not count delta bounces toward
maxDepth).  This probe renders our depth {2,3,4,5,8} against the
committed mirror goldens {2,3,8} and prints the full matrix; a clean
diagonal shift identifies the convention.

Usage:
    timeout 3000 python scripts/mitsuba_parity_probe3.py > /tmp/parity3.log 2>&1
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


def render(scene, depth, spp, frames, **cfg_kw):
    cfg = RenderConfig(samples_per_frame=spp, max_path_length=depth, **cfg_kw)
    state = init_state(H, W)
    for _ in range(frames):
        state = render_frame_jit(state, scene, cfg)
    return np.asarray(state.accum)


def main():
    print(f"devices: {jax.devices()}", flush=True)
    float(jnp.ones((8, 8)).sum())
    print("device execute OK", flush=True)

    sm = load_scene(scene_path("CornellBox-Water-mirror"))
    golds = {
        d: downsample(read_exr(golden_path("CornellBox-Water-mirror", d))[0],
                      H, W)
        for d in (2, 3, 8)
    }
    for qk in (False, True):
        for depth in (2, 3, 4, 5, 8):
            img = render(sm, depth, 16, frames=16, reference_quirks=qk)
            row = "  ".join(
                f"g{d}: rel={metrics(img, g)['rel_mse']:.4f} "
                f"r={metrics(img, g)['mean_ratio']:.3f}"
                for d, g in golds.items()
            )
            print(f"mirror quirks={qk} ourdepth={depth}  {row}", flush=True)


if __name__ == "__main__":
    main()
