"""Live progressive viewer: a dependency-free HTTP server over the renderer.

The reference is a GUI app whose MTKView redraws the accumulating image at
up to 120 Hz (reference: renderer/Renderer.mm:587, macos/GameViewController.m:19-34).
A GPU server is headless, so the equivalent here is a tiny built-in HTTP server:
the render loop steps progressive frames on the device while any browser
polls ``/frame.png`` (current tonemapped accumulation) and ``/stats.json``
(the reference's window-title HUD, renderer/Renderer.mm:631-637).

Usage:
    python -m pathtracer.cli --scene cornellbox --serve 8787
    # then open http://localhost:8787/

No external dependencies: http.server + the in-tree PNG encoder.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .io.png import png_bytes

_PAGE = """<!doctype html>
<html><head><title>pathtracer</title><style>
  body { background: #111; color: #ddd; font: 13px monospace; margin: 1em; }
  img { image-rendering: pixelated; border: 1px solid #333; max-width: 95vw; }
  #hud { margin: 0.6em 0; white-space: pre; }
</style></head><body>
<div id="hud">connecting...</div>
<div id="bar"></div>
<img id="view" alt="render">
<script>
  const img = document.getElementById('view');
  const hud = document.getElementById('hud');
  const bar = document.getElementById('bar');
  // compare modes mirror the reference's blit shader (Shaders.metal:53-66);
  // the selector only appears when the server has a golden loaded
  let mode = 0;
  async function tick() {
    try {
      const s = await (await fetch('stats.json')).json();
      hud.textContent = `${s.scene}  ${s.width}x${s.height}  frame ${s.frame}` +
        `  [${s.mrays_per_s.toFixed(2)} Mrays/s, ${s.ms_per_frame.toFixed(1)} ms/frame]`;
      if (s.has_golden && !bar.firstChild) {
        const sel = document.createElement('select');
        ['render', 'abs diff', 'ref-color', 'color-ref', 'luminance']
          .forEach((t, i) => sel.add(new Option(t, i)));
        sel.onchange = () => { mode = sel.value; };
        bar.appendChild(sel);
      }
      img.src = (mode > 0 ? `compare.png?mode=${mode}&` : 'frame.png?')
        + 't=' + Date.now();
    } catch (e) { hud.textContent = 'renderer offline: ' + e; }
  }
  img.onload = () => setTimeout(tick, 250);
  img.onerror = () => setTimeout(tick, 1000);
  tick();
</script></body></html>"""


class ViewerServer:
    """Serve a renderer's progressive state while the caller steps it.

    The HTTP handlers only touch ``renderer`` under ``self.lock``; callers
    must hold the same lock while stepping (``serve_while_rendering`` does).
    """

    def __init__(self, renderer, scene_name: str = "scene",
                 host: str = "127.0.0.1", port: int = 8787,
                 golden=None):
        # loopback by default: the endpoints are unauthenticated; pass
        # host="0.0.0.0" (CLI --serve-host) to expose them deliberately
        self.renderer = renderer
        self.scene_name = scene_name
        # optional (H, W, 3) linear golden at render resolution: enables the
        # live /compare.png diff view (the reference blits this every frame,
        # reference: renderer/Shaders.metal:53-66, Renderer.mm:611-622)
        self.golden = golden
        self.lock = threading.Lock()
        # last encoded frame: (frame_count, png bytes).  Polls for a frame
        # that is already encoded are served without touching the renderer,
        # so concurrent viewers cannot pile sync+transfer stalls onto the
        # render loop — at most one image grab happens per finished frame.
        self._png_cache: tuple[int, bytes] | None = None
        # last encoded comparison frame: ((frame, mode, scale), png bytes)
        self._cmp_cache: tuple[tuple, bytes] | None = None
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence request logging
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                try:
                    if path in ("/", "/index.html"):
                        self._send(200, "text/html", _PAGE.encode())
                    elif path == "/frame.png":
                        cached = viewer._png_cache
                        count = viewer.renderer._frame_count
                        if cached is not None and cached[0] == count:
                            self._send(200, "image/png", cached[1])
                        else:
                            # grab + encode + cache-fill under ONE lock hold
                            # (a racing poller could otherwise overwrite the
                            # cache with an OLDER frame and force re-grabs)
                            with viewer.lock:
                                count = viewer.renderer._frame_count
                                cached = viewer._png_cache
                                if cached is not None and cached[0] == count:
                                    body = cached[1]
                                else:
                                    img = viewer.renderer.image(
                                        tonemapped=True, rgb=True
                                    )
                                    body = png_bytes(img)
                                    viewer._png_cache = (count, body)
                            self._send(200, "image/png", body)
                    elif path == "/compare.png" and viewer.golden is not None:
                        from urllib.parse import parse_qs, urlparse

                        from .config import ComparisonMode
                        from .utils.compare import blit_display

                        q = parse_qs(urlparse(self.path).query)
                        mode = ComparisonMode(int(q.get("mode", ["1"])[0]))
                        scale = float(q.get("scale", ["10"])[0])
                        key = (viewer.renderer._frame_count, int(mode), scale)
                        cached = viewer._cmp_cache
                        if cached is not None and cached[0] == key:
                            self._send(200, "image/png", cached[1])
                        else:
                            with viewer.lock:
                                key = (viewer.renderer._frame_count,
                                       int(mode), scale)
                                cached = viewer._cmp_cache
                                if cached is not None and cached[0] == key:
                                    body = cached[1]
                                else:
                                    r = viewer.renderer
                                    img = r.image(rgb=True)
                                    body = png_bytes(blit_display(
                                        img, viewer.golden, mode, scale,
                                        tonemap=r.cfg.enable_tone_mapping,
                                        manual_srgb=r.cfg.manual_srgb,
                                    ))
                                    viewer._cmp_cache = (key, body)
                            self._send(200, "image/png", body)
                    elif path == "/stats.json":
                        with viewer.lock:
                            r = viewer.renderer
                            stats = {
                                "scene": viewer.scene_name,
                                "frame": r.frame_index,
                                "width": r.state.width,
                                "height": r.state.height,
                                "mrays_per_s": r._avg_rays_per_sec / 1e6,
                                "ms_per_frame": r._avg_frame_time * 1e3,
                                "has_golden": viewer.golden is not None,
                            }
                        self._send(200, "application/json",
                                   json.dumps(stats).encode())
                    else:
                        self._send(404, "text/plain", b"not found")
                except BrokenPipeError:
                    pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._stop = threading.Event()

    def start(self) -> None:
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()
        self._started = True

    def stop(self) -> None:
        """Stop both the render loop and the HTTP server (idempotent)."""
        self._stop.set()
        if getattr(self, "_started", False):
            # shutdown() deadlocks unless serve_forever() is running
            # (stdlib contract) — only call it after start()
            self._started = False
            self._httpd.shutdown()
        self._httpd.server_close()

    def serve_while_rendering(self, frames: int = 0) -> None:
        """Step the renderer (until ``stop()`` if frames == 0) while serving.

        The device keeps rendering between HTTP polls; the lock only
        serializes state reads against steps.
        """
        self.start()
        try:
            i = 0
            max_frames = self.renderer.cfg.max_frames
            while not self._stop.is_set() and (frames == 0 or i < frames):
                if max_frames and self.renderer._frame_count >= max_frames:
                    break  # step() would no-op: don't busy-spin; keep serving
                with self.lock:
                    self.renderer.step()
                i += 1
            while frames == 0 and not self._stop.wait(0.25):
                pass  # frame cap reached: stay up for viewers until stop()
        except KeyboardInterrupt:
            pass
        finally:
            if not self._stop.is_set():
                self.stop()
