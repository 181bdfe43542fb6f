"""ctypes bridge to the native (C++) SAH BVH builder.

The host-runtime counterpart of the reference's closed MPS build call
(reference: renderer/Renderer.mm:456-462), but open: native/sah_bvh.cc is a
16-bin surface-area-heuristic builder whose trees measurably beat the LBVH's
(fewer node visits per ray).  Compiled from native/sah_bvh.cc with g++ on
first use into native/build/; with builder="auto" a missing toolchain falls
back to the JAX LBVH (logged), builder="sah" raises instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess

import jax.numpy as jnp
import numpy as np

from .lbvh import BVH

log = logging.getLogger(__name__)

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_SRC_PATH = os.path.join(_NATIVE_DIR, "sah_bvh.cc")
_BUILD_DIR = os.path.join(_NATIVE_DIR, "build")
_lib = None  # None = untried; False = known-unavailable; CDLL = loaded


def lib_path() -> str:
    """The library built from the CURRENT source: its name carries the
    source's hash, so an edited sah_bvh.cc can never load a stale binary."""
    with open(_SRC_PATH, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libsahbvh-{digest}.so")


def _compile(path: str) -> None:
    """g++ -O3 -shared into native/build/ (gitignored); written under a
    private name and renamed, so concurrent processes never load a
    half-written library."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    subprocess.run(
        [os.environ.get("CXX", "g++"), "-O3", "-fPIC", "-std=c++17",
         "-shared", "-o", tmp, _SRC_PATH],
        check=True, capture_output=True, timeout=120,
    )
    os.replace(tmp, path)


def _load() -> ctypes.CDLL | None:
    global _lib
    if _lib is not None:
        return _lib or None  # False (cached failure) -> None
    path = lib_path()
    try:
        if not os.path.exists(path):
            _compile(path)
        lib = ctypes.CDLL(path)
    except Exception as exc:  # no toolchain / build failure -> LBVH
        log.warning("native SAH builder unavailable (%s); using LBVH", exc)
        # cache the failure: a sweep must not pay a fresh failed compile
        # (up to the 120 s timeout) per build_layout
        _lib = False
        return None
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.pt_build_sah.restype = ctypes.c_int32
    lib.pt_build_sah.argtypes = (
        [f32p] * 9
        + [ctypes.c_int32, ctypes.c_int32]
        + [i32p, i32p, i32p, i32p, u8p, f32p, f32p, i32p]
    )
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def build_sah(p0, p1, p2, leaf_size: int = 4) -> BVH:
    """Native SAH build -> the same BVH arrays the LBVH produces.

    p0/p1/p2: (3, T) component-major triangle vertices (host or device).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native builder unavailable")
    p0 = np.ascontiguousarray(np.asarray(p0), np.float32)
    p1 = np.ascontiguousarray(np.asarray(p1), np.float32)
    p2 = np.ascontiguousarray(np.asarray(p2), np.float32)
    num_tris = p0.shape[1]
    max_nodes = max(2 * num_tris - 1, 1)

    left = np.empty(max_nodes, np.int32)
    right = np.empty(max_nodes, np.int32)
    first = np.empty(max_nodes, np.int32)
    count = np.empty(max_nodes, np.int32)
    leaf = np.empty(max_nodes, np.uint8)
    bmin = np.empty(3 * max_nodes, np.float32)
    bmax = np.empty(3 * max_nodes, np.float32)
    order = np.empty(num_tris, np.int32)

    args = [np.ascontiguousarray(a[c]) for a in (p0, p1, p2) for c in range(3)]
    m = lib.pt_build_sah(
        *args, num_tris, leaf_size,
        left, right, first, count, leaf, bmin, bmax, order,
    )
    if m <= 0:
        raise RuntimeError(f"native SAH build failed (rc={m})")

    p0s, p1s, p2s = p0[:, order], p1[:, order], p2[:, order]
    return BVH(
        p0=jnp.asarray(p0s), p1=jnp.asarray(p1s), p2=jnp.asarray(p2s),
        sorted_to_orig=jnp.asarray(order),
        bmin=jnp.asarray(bmin[: 3 * m].reshape(3, -1)[:, :m].copy()),
        bmax=jnp.asarray(bmax[: 3 * m].reshape(3, -1)[:, :m].copy()),
        left=jnp.asarray(left[:m]),
        right=jnp.asarray(right[:m]),
        miss=jnp.zeros(m, jnp.int32),  # recomputed by the DFS layout pass
        is_leaf=jnp.asarray(leaf[:m].astype(bool)),
        first_tri=jnp.asarray(first[:m]),
        tri_count=jnp.asarray(count[:m]),
    )
