"""Smoke run of the path tracer on an NVIDIA GPU: the quickest proof that the
main path starts, compiles and renders correctly on the card.

    python chip_smoke.py                # one card, phases (a)-(g)
    python chip_smoke.py --four-cards   # the 4-card mesh path only, phase (h)

Everything runs in this one process, which owns the card(s).  Phases:

  (a) the device as JAX reports it, and the card's name and power limit;
  (b) compile the 1080p frame step of the headline deployment
      (CornellBox-Water-plastic, 1920x1080, 1 spp, depth 8, BVH built by
      the native SAH builder): compile seconds, memory analysis, peak bytes;
  (c) the traversal kernel (ops/bvh_kernel.py, Pallas on the Triton route)
      against the XLA walker on the real 1080p bounce-1 sorted wavefront,
      for nearest hit and for ``occlusion_clear``, and against the
      brute-force intersector on a 65,536-lane slice;
  (d) 4 frames of the headline through ``Renderer`` with the kernel and with
      the walker: the two images agree;
  (e) cornellbox, depth 8, 256 spp at the Mitsuba golden's size against the
      golden (the gate of tests/test_render_golden.py);
  (f) the CLI, in-process, at 128x96 with -o, --png and --compare-mode 1;
  (g) median ms/frame of the 1080p headline with the kernel and with the
      walker, in turns (kernel, walker, walker, kernel); then the ms of one
      traversal call on the bounce-1 wavefront of (c), nearest hit and
      capped occlusion, at the committed leaf sizes, in the same turns.
  (h) --four-cards: the headline at 2 spp on a 4x1 and a 2x2 ('tiles',
      'spp') mesh against the same render on one card.

No phase's failure is caught.  With no GPU the script exits non-zero before
printing any result.  The last line of standard output is one JSON object:
{"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

HEADLINE = "CornellBox-Water-plastic"
WIDTH, HEIGHT = 1920, 1080
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "out", "chip_smoke")


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def rel_diff(a, b) -> float:
    """Mean relative difference of two images: sum|a - b| / sum|b|."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).sum() / max(np.abs(b).sum(), 1e-30))


def headline_renderer(width=WIDTH, height=HEIGHT, mesh=None, traverse=None,
                      **cfg_kw):
    """The headline Renderer; ``traverse`` replaces the GPU's kernel (the
    XLA walker, to compare against)."""
    from pathtracer.config import RenderConfig
    from pathtracer.renderer import Renderer

    cfg_kw = {"samples_per_frame": 1, "max_path_length": 8, **cfg_kw}
    return Renderer(HEADLINE, width=width, height=height,
                    cfg=RenderConfig(**cfg_kw), builder="sah", mesh=mesh,
                    traverse=traverse)


def phase_b(width, height):
    """Compile the headline frame step; returns the kernel renderer."""
    r = headline_renderer(width, height)
    assert r._intersect.backend == "kernel", r._intersect.backend
    log(f"(b) BVH builder: {r.layout.builder}; traversal: "
        f"{r._intersect.backend}; nodes {r.layout.num_nodes}, "
        f"triangles {r.layout.num_tris}")
    t0 = time.perf_counter()
    compiled = r._step.lower(r.state, r.scene).compile()
    compile_s = time.perf_counter() - t0
    log(f"(b) compile_s {compile_s:.3f}")
    log(f"(b) memory_analysis {compiled.memory_analysis()}")
    r.run(1)
    img = r.image()
    assert img.shape == (height, width, 3), img.shape
    assert np.isfinite(img).all() and img.mean() > 0, img.mean()
    stats = jax.devices()[0].memory_stats() or {}
    log(f"(b) peak_bytes_in_use {stats.get('peak_bytes_in_use')}")
    return r


def _hits(fn, *args):
    h = jax.jit(fn)(*args)
    return np.asarray(h.t), np.asarray(h.tri)


def phase_c(r, width, height, slice_lanes=65536, interpret=False):
    """Kernel vs walker (and brute) on the real bounce-1 wavefront, which
    it returns.  ``interpret`` runs the kernel in Pallas interpret mode, to
    rehearse this phase on a machine without a GPU."""
    from pathtracer.ops.bvh_kernel import intersect_bvh_kernel
    from pathtracer.ops.intersect import intersect_brute
    from pathtracer.ops.traverse import intersect_bvh
    from pathtracer.render.stats import first_secondary_wavefront
    from pathtracer.render.wavefront import occlusion_clear

    scene, lay = r.scene, r.layout
    lay_occl = r.layout_occl if r.layout_occl is not None else lay
    st, pk = jax.jit(lambda: first_secondary_wavefront(
        scene, r.cfg, height, width, intersect=r._intersect))()
    live = np.asarray(st.alive)
    log(f"(c) bounce-1 wavefront: {live.size} lanes, {int(live.sum())} live "
        f"path rays, {int(np.asarray(pk.ok).sum())} shadow rays")

    def kernel(o, d, L, **kw):
        return intersect_bvh_kernel(o, d, L, interpret=interpret, **kw)

    o, d, a = st.origin, st.direction, st.alive
    tk, ik = _hits(lambda o, d, a: kernel(o, d, lay, active=a), o, d, a)
    tw, iw = _hits(lambda o, d, a: intersect_bvh(o, d, lay, active=a), o, d, a)
    same = (ik == iw)[live]
    both = live & (ik == iw) & np.isfinite(tw)
    rel_t = np.abs(tk[both] - tw[both]) / np.maximum(np.abs(tw[both]), 1e-30)
    log(f"(c) nearest kernel vs walker: id agree {same.mean():.7f} "
        f"({int((~same).sum())} of {same.size} differ), miss agree "
        f"{(np.isfinite(tk) == np.isfinite(tw))[live].mean():.7f}, max rel t "
        f"{rel_t.max() if rel_t.size else 0.0:.3e}")
    assert same.mean() >= 0.99999
    assert rel_t.size == 0 or rel_t.max() <= 1e-5

    # occlusion_clear: nearest hit within the cap must be the target
    eps = r.cfg.distance_epsilon
    so, sd, sok, cap = st.origin, pk.to_light, pk.ok, pk.cap
    tgt = pk.target.astype(jnp.int32)
    from pathtracer.ops.traverse import make_bvh_intersector

    isect_k = make_bvh_intersector(lay, scene, lay_occl, traverse=kernel)
    isect_w = make_bvh_intersector(lay, scene, lay_occl)
    clear = {}
    capped_t = {}
    for name, fn in (("kernel", isect_k), ("walker", isect_w)):
        clear[name] = np.asarray(jax.jit(
            lambda o, d, ok, c, t, fn=fn: occlusion_clear(
                fn, o, d, ok, c, t, eps))(so, sd, sok, cap, tgt))
        capped_t[name] = np.asarray(jax.jit(
            lambda o, d, ok, c, fn=fn: fn(o, d, ok, t_max=c).t)(
                so, sd, sok, cap))
    capn = np.asarray(cap)
    differ = clear["kernel"] != clear["walker"]
    tie = np.zeros_like(differ)
    for t in capped_t.values():
        tie |= np.abs(t - capn) <= 1e-5 * np.abs(capn)
    log(f"(c) occlusion_clear kernel vs walker: {int(differ.sum())} of "
        f"{int(np.asarray(sok).sum())} live lanes differ, "
        f"{int((differ & ~tie).sum())} of them not a tie at the cap")
    assert not (differ & ~tie).any()

    # brute force on a slice of the live lanes
    idx = np.flatnonzero(live)[:slice_lanes]
    so_, sd_ = o[:, idx], d[:, idx]
    hb = jax.jit(lambda o, d: intersect_brute(o, d, scene.p0, scene.p1,
                                              scene.p2))(so_, sd_)
    tb, ib = np.asarray(hb.t), np.asarray(hb.tri)
    tks, iks = tk[idx], ik[idx]
    hit = np.isfinite(tb)
    same_b = (iks == ib) | ~hit
    with np.errstate(invalid="ignore"):  # inf - inf on misses, masked
        tie_b = ~same_b & hit & (np.abs(tks - tb) <= 1e-5 * np.abs(tb))
    both_b = hit & (iks == ib)
    rel_b = np.abs(tks[both_b] - tb[both_b]) / np.abs(tb[both_b])
    log(f"(c) nearest kernel vs brute on {idx.size} lanes: miss agree "
        f"{(np.isfinite(tks) == hit).mean():.7f}, id agree "
        f"{same_b.mean():.7f} ({int((~same_b).sum())} differ, "
        f"{int(tie_b.sum())} of them equal-t ties), max rel t "
        f"{rel_b.max() if rel_b.size else 0.0:.3e}")
    assert (np.isfinite(tks) == hit).all()
    assert (same_b | tie_b).mean() >= 0.99999
    assert rel_b.size == 0 or rel_b.max() <= 1e-5
    return st, pk


def render_frames(r, frames):
    r.reset()
    r.run(frames)
    return r.image()


def phase_d(rk, rw, frames=4):
    ik = render_frames(rk, frames)
    iw = render_frames(rw, frames)
    assert np.isfinite(ik).all() and np.isfinite(iw).all()
    diff = rel_diff(ik, iw)
    log(f"(d) {frames}-frame image kernel vs walker: mean rel diff {diff:.3e}, "
        f"max abs {np.abs(ik - iw).max():.3e}, bitwise equal "
        f"{np.array_equal(ik, iw)}, mean {ik.mean():.6f}")
    assert diff <= 1e-4


def phase_e(spp=256):
    from pathtracer.config import RenderConfig
    from pathtracer.io.exr import read_exr
    from pathtracer.renderer import Renderer
    from pathtracer.scene import golden_path
    from pathtracer.utils.compare import downsample, metrics

    h, w = 75, 100  # the goldens' 600x800 / 8, as in tests/test_render_golden
    r = Renderer("cornellbox", width=w, height=h, builder="sah",
                 cfg=RenderConfig(samples_per_frame=spp, max_path_length=8))
    r.run(1)
    img = r.image()
    gold, _ = read_exr(golden_path("cornellbox", 8))
    m = metrics(img, downsample(gold, h, w))
    log(f"(e) cornellbox depth 8, {spp} spp vs Mitsuba golden: {m}")
    assert np.isfinite(img).all()
    assert m["rel_mse"] < 0.05, m
    assert 0.95 < m["mean_ratio"] < 1.05, m


def phase_f():
    from pathtracer import cli
    from pathtracer.io.exr import read_exr

    os.makedirs(OUT_DIR, exist_ok=True)
    exr = os.path.join(OUT_DIR, "cli.exr")
    png = os.path.join(OUT_DIR, "cli.png")
    diff = os.path.join(OUT_DIR, "cli_diff.png")
    argv = ["--scene", "cornellbox", "--width", "128", "--height", "96",
            "--depth", "8", "--frames", "4", "-o", exr, "--png", png,
            "--compare-mode", "1", "--compare-out", diff]
    rc = cli.main(argv)
    assert rc == 0, rc
    img, _ = read_exr(exr)
    assert img.shape[:2] == (96, 128) and np.isfinite(img).all()
    for p in (png, diff):
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n", p
    log(f"(f) CLI wrote {exr}, {png}, {diff}")


def timed_frames(r, frames):
    r.reset()
    r.run(1)  # warm: first frame of a fresh state
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        r.step()
        r.sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def phase_g(rk, rw, frames=5):
    turns = [("kernel", rk), ("walker", rw), ("walker", rw), ("kernel", rk)]
    got = {"kernel": [], "walker": []}
    for name, r in turns:
        got[name] += timed_frames(r, frames)
    size = f"{rk.state.width}x{rk.state.height}"
    for name, ts in got.items():
        log(f"(g) {name} ms/frame at {size}: median "
            f"{np.median(ts):.3f}, min {min(ts):.3f}, max {max(ts):.3f}, "
            f"all {[round(t, 3) for t in ts]}")
    faster = min(got, key=lambda k: np.median(got[k]))
    log(f"(g) faster end to end: {faster} "
        f"({np.median(got['walker']) / np.median(got['kernel']):.2f}x "
        "walker/kernel)")


def phase_g_traversal(r, wave, reps=3):
    """ms of one traversal call (no payload resolve) on the bounce-1
    wavefront at the renderer's leaf sizes: nearest hit on the path rays,
    capped occlusion on the shadow rays."""
    from pathtracer.ops.bvh_kernel import intersect_bvh_kernel
    from pathtracer.ops.traverse import intersect_bvh

    st, pk = wave
    lay = r.layout
    lay_occl = r.layout_occl if r.layout_occl is not None else lay
    queries = {
        f"nearest, leaf {r.cfg.leaf_size}": (
            lay, (st.origin, st.direction, st.alive, None)),
        f"occlusion, leaf {r.cfg.occlusion_leaf_size}": (
            lay_occl, (st.origin, pk.to_light, pk.ok, pk.cap)),
    }
    walks = {"kernel": intersect_bvh_kernel, "walker": intersect_bvh}
    for query, (L, args) in queries.items():
        fns = {name: jax.jit(lambda o, d, a, c, walk=walk, L=L: walk(
            o, d, L, active=a, t_max=c)) for name, walk in walks.items()}
        got = {name: [] for name in fns}
        for name in fns:  # compile and warm outside the timed turns
            jax.block_until_ready(fns[name](*args))
        for name in ("kernel", "walker", "walker", "kernel"):
            for _ in range(reps):
                t0 = time.perf_counter()
                jax.block_until_ready(fns[name](*args))
                got[name].append((time.perf_counter() - t0) * 1e3)
        for name, ts in got.items():
            log(f"(g) traversal {query}, {name} ms/call: median "
                f"{np.median(ts):.3f}, min {min(ts):.3f}, max {max(ts):.3f}")


def phase_h(width, height, frames=4):
    from pathtracer.parallel.tiles import make_mesh

    one = headline_renderer(width, height, samples_per_frame=2)
    ref = render_frames(one, frames)
    log(f"(h) 1-card reference: {frames} frames at 2 spp, mean "
        f"{ref.mean():.6f}")
    for tiles, spp in ((4, 1), (2, 2)):
        r = headline_renderer(width, height, mesh=make_mesh(tiles, spp),
                              samples_per_frame=2)
        img = render_frames(r, frames)
        diff = rel_diff(img, ref)
        log(f"(h) mesh {tiles}x{spp} vs 1 card: mean rel diff {diff:.3e}, "
            f"max abs {np.abs(img - ref).max():.3e}, bitwise equal "
            f"{np.array_equal(img, ref)}")
        assert np.isfinite(img).all()
        assert diff <= 1e-5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card mesh phase (needs 4 GPUs)")
    args = ap.parse_args(argv)

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke.py needs a GPU; JAX found {dev.platform!r}")
    from pathtracer.utils.compile_cache import enable_compile_cache

    log(f"(a) platform {dev.platform}, device_kind {dev.device_kind}, "
        f"count {len(devices)}")
    log(f"(a) nvidia-smi: {nvidia_smi()}")
    log(f"(a) compile cache: {enable_compile_cache()}")
    t_start = time.perf_counter()
    if args.four_cards:
        assert len(devices) >= 4, "--four-cards needs 4 GPUs"
        phase_h(WIDTH, HEIGHT)
    else:
        from pathtracer.ops.traverse import intersect_bvh

        rk = phase_b(WIDTH, HEIGHT)
        wave = phase_c(rk, WIDTH, HEIGHT)
        rw = headline_renderer(traverse=intersect_bvh)
        phase_d(rk, rw)
        phase_e()
        phase_f()
        phase_g(rk, rw)
        phase_g_traversal(rk, wave)
    log(f"total_s {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
