"""Benchmark harness: traced Mrays/s at 1080p 1 spp on the Cornell-box-with-mesh
scene, on a GPU.

Prints ONE JSON line: {"metric", "value", "unit", ...extras}.

Headline metric: rays actually traced per second (primary + per-bounce path and
shadow rays actually processed by the traversal, i.e. the standard Mrays/s of
the ray-tracing literature), measured over full progressive frames at 1080p,
1 spp/frame, 8 bounces.  ``hud_mrays_per_s`` additionally reports the
reference's HUD definition -- W*H/frame_time, which counts only the primary
dispatch size (reference: renderer/Renderer.mm:631-637).

The result names the device it ran on (platform, device kind, count, and the
card's name and power limit from nvidia-smi).  With no GPU it exits non-zero
instead of timing the CPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import jax
import numpy as np

from pathtracer.config import RenderConfig
from pathtracer.renderer import Renderer
from pathtracer.utils.compile_cache import enable_compile_cache


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the card(s), one per line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="CornellBox-Water-plastic",
                    help="bench scene (default: the Cornell-box-with-mesh)")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--intersector", default="bvh")
    ap.add_argument("--spp", type=int, default=1,
                    help="samples per frame (fused into one wavefront; the "
                         "headline config is 1)")
    ap.add_argument("--bake-materials", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="override cfg.bake_materials either way (A/B the "
                         "baked-row material resolve)")
    ap.add_argument("--row-tiles", type=int, default=1,
                    help="sequential row tiles per frame (cfg.row_tiles); "
                         "composes with --spp fusion to bound device memory")
    ap.add_argument("--fuse", type=int, default=None,
                    help="override cfg.fuse_samples (max samples fused into "
                         "one wavefront)")
    ap.add_argument("--prefix-sort", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="A/B cfg.prefix_sort (bounce sorts at the live "
                         "ladder's rung width instead of full width)")
    ap.add_argument("--sort-lowering", choices=("variadic", "gather"),
                    default=None,
                    help="A/B cfg.sort_lowering (variadic lax.sort vs "
                         "argsort+gather)")
    ap.add_argument("--sort-skip", default=None, metavar="B1,B2",
                    help="A/B cfg.sort_bounce_skip (bounce indices whose "
                         "wavefront sort is skipped, e.g. '1,6,7')")
    ap.add_argument("--cull-zero-nee", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="A/B cfg.cull_zero_nee (skip occlusion walks for "
                         "shadow rays with exactly-zero NEE contribution)")
    ap.add_argument("--mesh", default=None, metavar="TILESxSPP",
                    help="multi-card aggregate bench: shard the frame over a "
                         "('tiles','spp') device mesh (e.g. 2x2) and report "
                         "aggregate Mrays/s")
    ap.add_argument("--progressive", action="store_true",
                    help="also measure BASELINE.json's secondary metric -- "
                         "progressive spp/sec on the cornellbox scene at the "
                         "same resolution (costs one extra compile)")
    args = ap.parse_args()

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found {dev.platform!r}")
    enable_compile_cache()

    over = {}
    if args.bake_materials is not None:
        over["bake_materials"] = args.bake_materials
    if args.prefix_sort is not None:
        over["prefix_sort"] = args.prefix_sort
    if args.sort_lowering is not None:
        over["sort_lowering"] = args.sort_lowering
    if args.sort_skip is not None:
        over["sort_bounce_skip"] = args.sort_skip
    if args.cull_zero_nee is not None:
        over["cull_zero_nee"] = args.cull_zero_nee
    if args.fuse is not None:
        over["fuse_samples"] = args.fuse
    cfg = RenderConfig(
        samples_per_frame=args.spp, max_path_length=args.depth,
        intersector=args.intersector, row_tiles=args.row_tiles, **over,
    )
    mesh = None
    if args.mesh:
        from pathtracer.parallel.tiles import make_mesh

        n_tiles, n_spp = (int(x) for x in args.mesh.lower().split("x"))
        mesh = make_mesh(n_tiles, n_spp)
    r = Renderer(args.scene, width=args.width, height=args.height, cfg=cfg,
                 mesh=mesh)

    t_c = time.perf_counter()
    for _ in range(args.warmup):
        r.step()
    r.sync()
    warmup_s = time.perf_counter() - t_c

    # Individually-synced frame times: the MEDIAN is the headline
    # denominator; best is the floor; all samples print for audit.
    times = []
    for _ in range(args.frames):
        t0 = time.perf_counter()
        r.step()
        r.sync()
        times.append(time.perf_counter() - t0)
    frame_time = float(np.median(times))
    best = min(times)

    pixels = args.width * args.height
    hud_mrays = pixels / frame_time / 1e6

    # honest per-bounce ray count: EXACT in-pipeline counters over the very
    # frame indices measured above (no probe scaling)
    from pathtracer.render.stats import count_traced_rays_exact

    measured = tuple(range(args.warmup, args.warmup + args.frames))
    t_tr = time.perf_counter()
    traced = count_traced_rays_exact(
        r.scene, cfg, args.height, args.width,
        frame_indices=measured, intersect=r._intersect, seed=0,
    )
    traced_count_s = time.perf_counter() - t_tr
    honest_mrays = traced / frame_time / 1e6

    img = r.image()
    metric = (f"traced_mrays_per_sec_aggregate_{args.mesh}mesh_{args.spp}spp"
              if mesh is not None
              else f"traced_mrays_per_sec_per_chip_1080p_{args.spp}spp")
    result = {
        "metric": metric,
        "value": honest_mrays,
        "unit": "Mrays/s",
        "hud_mrays_per_s": hud_mrays,
        "rays_traced_per_frame": int(traced),
        "ms_per_frame": frame_time * 1e3,
        "mean_ms_per_frame": float(np.mean(times)) * 1e3,
        "best_ms_per_frame": best * 1e3,
        "frame_times_ms": [t * 1e3 for t in times],
        "spp_per_sec": args.spp / frame_time,
        "warmup_s": warmup_s,
        "traced_count_s": traced_count_s,
        "scene": args.scene,
        "resolution": f"{args.width}x{args.height}",
        "path_depth": args.depth,
        "traversal": r._intersect.backend,
        "bvh_builder": r.layout.builder if r.layout is not None else None,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "gpu": gpu_name_and_power_limit(),
        "mesh": args.mesh,
        "finite": bool(np.isfinite(img).all()),
        "image_mean": float(img.mean()),
    }

    if args.progressive:
        rc = Renderer("cornellbox", width=args.width, height=args.height,
                      cfg=cfg)
        for _ in range(args.warmup):
            rc.step()
        rc.sync()
        ct = []
        for _ in range(args.frames):
            t0 = time.perf_counter()
            rc.step()
            rc.sync()
            ct.append(time.perf_counter() - t0)
        result["cornellbox_spp_per_sec"] = args.spp / float(np.median(ct))
        result["cornellbox_ms_per_frame"] = float(np.median(ct)) * 1e3

    print(json.dumps(result))


if __name__ == "__main__":
    main()
