"""Localize the mirror-golden residual: per-region rel-MSE map.

probe3 showed the CornellBox-Water-mirror goldens never match tighter
than rel_mse ~0.16 at ANY depth pairing while mean ratios stay near 1 —
a high-frequency, energy-neutral mismatch.  Hypothesis: the goldens'
water-surface geometry (shapeIndex 8 of the Mitsuba .serialized) differs
from the OBJ's wavy mesh, so the MIRRORED reflections disagree per-pixel.
This script renders ours (depth 3, quirks off, spp256 CPU/GPU) and
prints a coarse 5x5 grid of per-cell rel-MSE vs the golden plus the
row-means, so the error's spatial home is measurable.

Usage: python scripts/mirror_residual_map.py  (any backend)
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pathtracer.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402

from pathtracer.config import RenderConfig  # noqa: E402
from pathtracer.io.exr import read_exr  # noqa: E402
from pathtracer.render import init_state, render_frame_jit  # noqa: E402
from pathtracer.scene import golden_path, load_scene, scene_path  # noqa: E402
from pathtracer.utils.compare import downsample, golden_mask  # noqa: E402

H, W = 75, 100


def main():
    scene = load_scene(scene_path("CornellBox-Water-mirror"))
    cfg = RenderConfig(samples_per_frame=16, max_path_length=3,
                       reference_quirks=False)
    state = init_state(H, W)
    for _ in range(16):
        state = render_frame_jit(state, scene, cfg)
    img = np.asarray(state.accum)
    gold = downsample(read_exr(golden_path("CornellBox-Water-mirror", 3))[0],
                      H, W)
    mask = golden_mask(H, W)

    err = ((img - gold) ** 2).mean(-1)
    den = (gold ** 2).mean(-1) + 1e-3
    rel = np.where(mask, err / den, 0.0)
    print("5x5 rel-MSE grid (rows top->bottom):")
    gh, gw = H // 5, W // 5
    for i in range(5):
        cells = [rel[i * gh:(i + 1) * gh, j * gw:(j + 1) * gw].mean()
                 for j in range(5)]
        print("  " + "  ".join(f"{c:7.4f}" for c in cells)
              + f"   row-mean {np.mean(cells):7.4f}", flush=True)
    print(f"total rel_mse {rel[mask].mean():.4f}")

    # Tint check: if the golden's mirror used Mitsuba's DEFAULT conductor
    # (copper) instead of the XML's material="none", its reflections are
    # warm-tinted and dimmer — per-channel ratios in high-error cells
    # would split R > G > B.
    m3 = np.broadcast_to(mask[..., None], img.shape)
    for name, sel in (("whole image", m3),
                      ("high-err px", m3 & (rel[..., None] > 2 * rel[mask].mean()))):
        ours = np.where(sel, img, 0.0).reshape(-1, 3).sum(0)
        gld = np.where(sel, gold, 0.0).reshape(-1, 3).sum(0)
        r = gld / np.maximum(ours, 1e-9)
        print(f"golden/ours channel ratios ({name}): "
              f"R {r[0]:.3f}  G {r[1]:.3f}  B {r[2]:.3f}", flush=True)


if __name__ == "__main__":
    main()
