"""pathtracer: a progressive spectral path tracer in JAX, with a Pallas
(Triton) BVH traversal kernel for NVIDIA GPUs.

Built from scratch with the capabilities of the Metal reference renderer
(serhii-rieznik/metal-renderer); see SURVEY.md at the repo root for the layer
map this framework mirrors.
"""

__version__ = "0.1.0"

from .config import ComparisonMode, NoiseMode, RenderConfig  # noqa: F401
