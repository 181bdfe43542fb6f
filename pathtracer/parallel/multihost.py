"""Multi-host meshes: tiles across hosts, samples within a host, gather at
the edge.

SURVEY.md §5 names the communication layering for scaling past one host:
row-tiles are embarrassingly parallel (no hot-loop traffic), so the 'tiles'
mesh axis is laid out ACROSS processes — the only data that ever crosses the
host network is the final image gather at display/save time.  The 'spp'
axis (the one per-frame ``psum``) is laid out WITHIN each process, so the
collective rides NVLink between a host's own cards.

Everything here degrades gracefully to a single process: ``make_multihost_mesh``
is then just ``make_mesh`` over the local devices, and ``gather_image`` a
device fetch — which is how CI exercises it on the virtual CPU mesh.
"""

from __future__ import annotations

import jax
import numpy as np

from ..render.state import RenderState
from .tiles import make_mesh


def make_multihost_mesh(n_spp: int = 1, devices=None):
    """('tiles', 'spp') mesh whose 'tiles' axis spans processes.

    Device order: process-major (``jax.devices()`` already enumerates every
    process's chips grouped by process id), so reshaping to
    (n_tiles, n_spp) puts each process's ``local_device_count`` cards on
    contiguous tile rows and keeps every 'spp' group (the psum participants)
    within one process -- the collective stays on NVLink, never on the host
    network.
    """
    devices = list(devices if devices is not None else jax.devices())
    # The NVLink-only guarantee needs (a) the device list grouped by process so
    # reshape rows never straddle hosts, and (b) EVERY process's count
    # divisible by n_spp (a max-only check would let a host with a
    # non-divisible count leak its spp group onto the host network, or idle
    # its tail).
    counts: dict[int, int] = {}
    last = None
    for d in devices:
        p = d.process_index
        if p != last and p in counts:
            raise ValueError(
                "device list must be process-contiguous (grouped by "
                "process_index) for the spp psum to stay on NVLink")
        counts[p] = counts.get(p, 0) + 1
        last = p
    if n_spp > 1:
        bad = {p: c for p, c in counts.items() if c % n_spp}
        if bad:
            raise ValueError(
                f"n_spp={n_spp} must divide EVERY process's device count "
                f"(violated by process:count {bad}) so the sample psum "
                "stays on NVLink; use a smaller n_spp or shard samples "
                "across hosts explicitly")
    return make_mesh(len(devices) // n_spp, n_spp, devices=devices)


def gather_image(state: RenderState) -> np.ndarray:
    """Fetch the full (H, W, S) accumulator to THIS host.

    Single process (CI, one host): a plain device fetch.  Multi-host: each
    process only holds its addressable row-tiles, so the full image is
    assembled over the host network with a process allgather -- the one
    cross-host transfer in the system, at display/save frequency, matching
    SURVEY §5's "data-center network only for multi-host image gather".
    """
    if jax.process_count() == 1:
        return np.asarray(state.accum)
    from jax.experimental import multihost_utils

    return np.asarray(
        multihost_utils.process_allgather(state.accum, tiled=True)
    )
