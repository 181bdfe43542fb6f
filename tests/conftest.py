"""Test harness config: force CPU with 8 virtual devices.

Multi-device sharding tests run on a virtual CPU mesh
(``--xla_force_host_platform_device_count``), the JAX equivalent of a fake
backend.  What only the GPU can show (the traversal kernel compiled by
Triton, 1080p frames, the 4-card mesh) is checked by ``chip_smoke.py``.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from pathtracer.utils.compile_cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
enable_compile_cache()
