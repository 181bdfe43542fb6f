"""Capture the interactive-mode demo: a low-res progressive render through
the live HTTP viewer, with the HUD stats polled and archived.

The reference is a LIVE app (120 fps target at half-res,
reference: renderer/Renderer.mm:97); the headless analog is the viewer's
progressive loop at a preview resolution.  This script starts the viewer
on a background thread, polls /stats.json while frames accumulate, writes
the last sample (plus the fps trajectory) to renders/interactive_stats.json,
and prints the steady-state fps.

Usage (on a GPU; most of the time is the first compile):
    timeout 900 python scripts/interactive_demo.py \
        [--width 640 --height 360 --depth 8 --frames 40]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from pathtracer.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from pathtracer.config import RenderConfig  # noqa: E402
from pathtracer.renderer import Renderer  # noqa: E402
from pathtracer.viewer import ViewerServer  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="cornellbox")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "renders", "interactive_stats.json"))
    args = ap.parse_args()

    print(f"devices: {jax.devices()}", flush=True)

    cfg = RenderConfig(max_path_length=args.depth)
    r = Renderer(args.scene, width=args.width, height=args.height, cfg=cfg)
    server = ViewerServer(r, scene_name=args.scene, host="127.0.0.1", port=0)
    print(f"viewer on http://127.0.0.1:{server.port}/", flush=True)

    t = threading.Thread(
        target=server.serve_while_rendering, args=(args.frames,), daemon=True)
    t0 = time.perf_counter()
    t.start()

    samples = []
    url = f"http://127.0.0.1:{server.port}/stats.json"
    last_frame = -1
    while t.is_alive():
        time.sleep(1.0)
        try:
            with urllib.request.urlopen(url, timeout=10) as resp:
                s = json.loads(resp.read())
        except Exception:  # noqa: BLE001 — serve loop may not be up yet
            continue
        if s["frame"] != last_frame:
            last_frame = s["frame"]
            s["t_wall_s"] = round(time.perf_counter() - t0, 2)
            samples.append(s)
            if s["ms_per_frame"]:
                print(f"frame {s['frame']:4d}  {s['ms_per_frame']:7.1f} ms "
                      f"({1e3 / s['ms_per_frame']:.2f} fps)  "
                      f"{s['mrays_per_s']:.2f} Mrays/s", flush=True)
    t.join()
    server.stop()

    if not samples:
        print("no stats captured", flush=True)
        return 1
    final = samples[-1]
    fps = 1e3 / final["ms_per_frame"] if final["ms_per_frame"] else 0.0
    out = {
        "config": {
            "scene": args.scene, "width": args.width, "height": args.height,
            "depth": args.depth, "frames": args.frames,
        },
        "steady_state": {**final, "fps": round(fps, 2)},
        "trajectory": samples,
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"steady state: {fps:.2f} fps at {args.width}x{args.height} "
          f"depth {args.depth} -> {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
