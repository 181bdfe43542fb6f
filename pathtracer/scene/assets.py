"""Bundled scene/golden-image registry.

The reference ships five OBJ scenes and nine Mitsuba-rendered golden EXRs
(reference: renderer/Media/), selected by editing a hardcoded string
(reference: renderer/Renderer.mm:17-21).  Here scenes are looked up by name at
runtime from ``assets/`` at the repo root (copied scene *data*, not code; the
meshes are public-domain Cornell-box data from graphics.cs.williams.edu).
"""

from __future__ import annotations

import os

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ASSETS_DIR = os.environ.get("PATHTRACER_ASSETS", os.path.join(_REPO_ROOT, "assets"))

SCENE_NAMES = (
    "cornellbox",
    "white-box",
    "CornellBox-Water",
    "CornellBox-Water-mirror",
    "CornellBox-Water-plastic",
)

DEFAULT_SCENE = "CornellBox-Water-plastic"  # reference: renderer/Renderer.mm:18


def scene_path(name: str) -> str:
    path = os.path.join(ASSETS_DIR, "scenes", f"{name}.obj")
    if not os.path.exists(path):
        raise FileNotFoundError(f"unknown scene {name!r}: {path} not found")
    return path


def golden_path(name: str, max_path_length: int) -> str:
    """Golden EXR for a scene at a given path depth
    (filename scheme per reference: renderer/Renderer.mm:165)."""
    return os.path.join(ASSETS_DIR, "reference", f"{name}-{max_path_length}.exr")
