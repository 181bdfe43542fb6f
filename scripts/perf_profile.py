"""Where the frame's device time goes: trace a few frame steps of the
renderer with jax.profiler and rank the device's ops by their total time.

    python scripts/perf_profile.py                     # 1080p headline, 3 frames
    python scripts/perf_profile.py --trace-dir DIR --parse-only

Reads the Perfetto JSON that jax.profiler writes beside its xplane, so it
needs no package beyond JAX.  On a GPU it ranks the kernels on the device's
streams and reports how busy the device was over the traced frames; on the
CPU, which has no device process in the trace, it ranks the XLA threads'
ops instead.  The production frame runs as is: nothing is patched.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# Coarse classes of the frame's ops, first match wins (Pallas names the
# traversal kernel after its pallas_call, ops/bvh_kernel.py).
CLASSES = (
    ("traversal kernel", r"bvh_traverse"),
    ("sort", r"sort"),
    ("gather/scatter", r"gather|scatter|dynamic.?slice|dynamic.?update"),
    ("copy/memset", r"memcpy|memset|copy"),
)


def load_trace(trace_dir: str) -> list[dict]:
    """The events of the newest perfetto_trace.json.gz under trace_dir."""
    paths = sorted(glob.glob(os.path.join(
        trace_dir, "**", "perfetto_trace.json.gz"), recursive=True),
        key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no perfetto_trace.json.gz under {trace_dir}")
    with gzip.open(paths[-1]) as f:
        trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def device_ops(events: list[dict]) -> tuple[list[dict], str]:
    """The complete ('X') events that ran on a device, and where from: the
    '/device:...' processes when the trace has any, else the host's XLA
    threads (a CPU run)."""
    procs, threads = {}, {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            procs[e["pid"]] = e["args"]["name"]
        elif e.get("ph") == "M" and e.get("name") == "thread_name":
            threads[(e["pid"], e["tid"])] = e["args"]["name"]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = {p for p, n in procs.items() if n.startswith("/device:")}
    if dev:
        # the kernels run on the 'Stream' threads; other threads of a device
        # process re-list the same time per XLA op or module
        streams = {k for k, n in threads.items()
                   if k[0] in dev and n.startswith("Stream")}
        return ([e for e in spans if e["pid"] in dev
                 and (not streams or (e["pid"], e["tid"]) in streams)],
                "device streams")
    xla = {k for k, n in threads.items() if n.startswith("tf_XLA")}
    return ([e for e in spans if (e["pid"], e["tid"]) in xla],
            "host XLA threads (no device in the trace)")


def busy_time(ops: list[dict]) -> tuple[float, float]:
    """(busy, span) in microseconds: the union of the ops' intervals, and
    the time from the first op's start to the last op's end."""
    if not ops:
        return 0.0, 0.0
    ivs = sorted((e["ts"], e["ts"] + e["dur"]) for e in ops)
    busy, (cur0, cur1) = 0.0, ivs[0]
    for a, b in ivs[1:]:
        if a > cur1:
            busy += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    busy += cur1 - cur0
    return busy, max(b for _, b in ivs) - ivs[0][0]


def classify(name: str) -> str:
    for label, pattern in CLASSES:
        if re.search(pattern, name, re.IGNORECASE):
            return label
    return "other"


def summarize(ops: list[dict]) -> dict:
    """Total microseconds and counts per op name and per class."""
    by_name = collections.defaultdict(lambda: [0.0, 0])
    by_class = collections.defaultdict(float)
    for e in ops:
        by_name[e["name"]][0] += e["dur"]
        by_name[e["name"]][1] += 1
        by_class[classify(e["name"])] += e["dur"]
    busy, span = busy_time(ops)
    return {"by_name": dict(by_name), "by_class": dict(by_class),
            "busy_us": busy, "span_us": span}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="CornellBox-Water-plastic")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--limit", type=int, default=30)
    ap.add_argument("--trace-dir", default=os.path.join(ROOT, "out", "trace"))
    ap.add_argument("--parse-only", action="store_true",
                    help="skip rendering; parse an existing trace dir")
    args = ap.parse_args()

    if not args.parse_only:
        import jax

        from pathtracer.config import RenderConfig
        from pathtracer.renderer import Renderer
        from pathtracer.utils.compile_cache import enable_compile_cache

        enable_compile_cache()
        cfg = RenderConfig(samples_per_frame=1, max_path_length=args.depth,
                           frames_in_flight=1)
        r = Renderer(args.scene, width=args.width, height=args.height, cfg=cfg)
        r.run(1)  # compile outside the trace
        t0 = time.perf_counter()
        with jax.profiler.trace(args.trace_dir, create_perfetto_trace=True):
            r.run(args.frames)
        wall = time.perf_counter() - t0
        print(f"traced {args.frames} frames of {args.scene} at "
              f"{args.width}x{args.height} on {jax.devices()[0].device_kind} "
              f"in {wall:.3f} s (host clock, profiler on)", flush=True)

    ops, source = device_ops(load_trace(args.trace_dir))
    s = summarize(ops)
    total = sum(us for us, _ in s["by_name"].values())
    per_frame = 1e-3 / max(args.frames, 1)
    print(f"ops from {source}: {len(ops)} events, summed time "
          f"{total * per_frame:.3f} ms/frame")
    if s["span_us"]:
        print(f"busy {s['busy_us'] * per_frame:.3f} ms/frame of a "
              f"{s['span_us'] * per_frame:.3f} ms/frame span "
              f"(idle share {1 - s['busy_us'] / s['span_us']:.4f})")
    print(f"{'ms/frame':>10}  {'share':>7}  class")
    for label, us in sorted(s["by_class"].items(), key=lambda kv: -kv[1]):
        print(f"{us * per_frame:10.3f}  {us / max(total, 1e-9):7.2%}  {label}")
    print(f"{'ms/frame':>10}  {'share':>7}  {'calls':>6}  op")
    top = sorted(s["by_name"].items(), key=lambda kv: -kv[1][0])[:args.limit]
    for name, (us, n) in top:
        print(f"{us * per_frame:10.3f}  {us / max(total, 1e-9):7.2%}  "
              f"{n:6d}  {name[:100]}")


if __name__ == "__main__":
    main()
