"""Live HTTP viewer: serve a real renderer, poll page/stats/frame."""

import json
import threading
import urllib.request

import numpy as np

from pathtracer.config import RenderConfig
from pathtracer.renderer import Renderer
from pathtracer.viewer import ViewerServer


def _get(port, path):
    # 60 s, not 10: the first GET races the renderer's first-frame compile,
    # and on a loaded box (full suite + concurrent tiers) 10 s flakes.
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_viewer_serves_progressive_render():
    cfg = RenderConfig(samples_per_frame=1, max_path_length=2, intersector="brute")
    r = Renderer("cornellbox", cfg=cfg, width=32, height=24)
    server = ViewerServer(r, scene_name="cornellbox", host="127.0.0.1", port=0)

    t = threading.Thread(
        target=server.serve_while_rendering, kwargs={"frames": 0}, daemon=True
    )
    t.start()
    try:
        status, ctype, body = _get(server.port, "/")
        assert status == 200 and "text/html" in ctype and b"frame.png" in body

        status, ctype, body = _get(server.port, "/frame.png")
        assert status == 200 and ctype == "image/png"
        assert body[:8] == b"\x89PNG\r\n\x1a\n"

        status, ctype, body = _get(server.port, "/stats.json")
        stats = json.loads(body)
        assert stats["width"] == 32 and stats["height"] == 24
        assert stats["frame"] >= 0 and stats["scene"] == "cornellbox"

        import urllib.error

        try:
            _get(server.port, "/nope")
            raise AssertionError("expected 404")
        except urllib.error.HTTPError as e:
            assert e.code == 404
    finally:
        server.stop()
        t.join(timeout=60)
    assert not t.is_alive()
    assert r.frame_index >= 1
    assert np.isfinite(r.image()).all()


def test_viewer_compare_endpoint():
    """/compare.png serves the live golden diff; 404 without a golden."""
    # max_frames=1: serve_while_rendering(frames=0) renders UNTIL stop(), so
    # an uncapped renderer advances _frame_count between the two GETs below
    # and the cache key legitimately changes (the test was flaky without it)
    cfg = RenderConfig(samples_per_frame=1, max_path_length=2,
                       intersector="brute", max_frames=1)
    r = Renderer("cornellbox", cfg=cfg, width=32, height=24)
    r.run(1)  # reach the frame cap BEFORE serving: the GETs see one stable frame
    golden = np.full((24, 32, 3), 0.25, np.float32)
    server = ViewerServer(r, scene_name="cornellbox", host="127.0.0.1",
                          port=0, golden=golden)
    t = threading.Thread(
        target=server.serve_while_rendering, kwargs={"frames": 0}, daemon=True
    )
    t.start()
    try:
        status, ctype, body = _get(server.port, "/compare.png?mode=1&scale=4")
        assert status == 200 and ctype == "image/png"
        assert body[:8] == b"\x89PNG\r\n\x1a\n"
        # same frame + same params must come from the cache (identical bytes)
        _, _, body2 = _get(server.port, "/compare.png?mode=1&scale=4")
        assert body2 == body
        # different mode must NOT serve the cached mode-1 image
        _, _, body3 = _get(server.port, "/compare.png?mode=4&scale=4")
        assert body3[:8] == b"\x89PNG\r\n\x1a\n"
        stats = json.loads(_get(server.port, "/stats.json")[2])
        assert stats["has_golden"] is True
    finally:
        server.stop()
        t.join(timeout=60)
    assert not t.is_alive()

    # without a golden the endpoint is a 404, and stats says so
    server2 = ViewerServer(r, scene_name="cornellbox", host="127.0.0.1", port=0)
    server2.start()
    try:
        import urllib.error

        try:
            _get(server2.port, "/compare.png?mode=1")
            raise AssertionError("expected 404")
        except urllib.error.HTTPError as e:
            assert e.code == 404
        stats = json.loads(_get(server2.port, "/stats.json")[2])
        assert stats["has_golden"] is False
    finally:
        server2.stop()
