"""Generate brute-force self-goldens for the Water scene variants.

The Mitsuba goldens for the Water scenes encode *different materials* than the
reference's MTL channel hack, so the Mitsuba gates are wide bounds rather than
parity proofs.  These self-goldens close that loophole: the BRUTE intersector
(dense Moller-Trumbore over every triangle -- no BVH) renders a
fixed deterministic configuration (seed 0, 16 frames, 200x150, depth 8), and
tests/test_render_golden.py re-renders the SAME configuration through the
production BVH path and gates rel_mse exactly — identical noise on both sides,
so any disagreement is an intersection bug, not estimator variance.

Run on a GPU (brute at this size is seconds there):
    timeout 1200 python scripts/make_self_goldens.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pathtracer.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402

from pathtracer.config import RenderConfig  # noqa: E402
from pathtracer.io.exr import write_exr  # noqa: E402
from pathtracer.render import init_state, render_frame_jit  # noqa: E402
from pathtracer.scene import load_scene, scene_path  # noqa: E402

H, W = 150, 200
FRAMES = 16
DEPTH = 8
SCENES = (
    "CornellBox-Water",
    "CornellBox-Water-mirror",
    "CornellBox-Water-plastic",
)
OUT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "assets", "self_golden")


def main() -> None:
    os.makedirs(OUT_DIR, exist_ok=True)
    cfg = RenderConfig(
        samples_per_frame=1, max_path_length=DEPTH, intersector="brute"
    )
    for name in SCENES:
        scene = load_scene(scene_path(name))
        state = init_state(H, W)
        for _ in range(FRAMES):
            state = render_frame_jit(state, scene, cfg)
        img = np.asarray(state.accum)
        assert np.isfinite(img).all(), name
        path = os.path.join(OUT_DIR, f"{name}-{DEPTH}.exr")
        write_exr(path, img, half=False)  # full f32: the gate is exact
        print(f"{name}: mean={img.mean():.5f} -> {path}", flush=True)


if __name__ == "__main__":
    main()
