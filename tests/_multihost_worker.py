"""Worker process for the 2-process DCN smoke test (test_multihost_dcn.py).

Each process owns 4 virtual CPU devices; the ('tiles', 'spp') multihost mesh
lays tiles across the two processes and spp within each, so ``gather_image``
must assemble the full image over the (loopback) DCN via
``multihost_utils.process_allgather`` — the exact branch single-process CI
can never reach.

Run: python tests/_multihost_worker.py <process_id> <coordinator_port>
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    pid = int(sys.argv[1])
    port = sys.argv[2]
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=2,
        process_id=pid,
    )
    assert jax.process_count() == 2
    assert len(jax.devices()) == 8

    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pathtracer.config import RenderConfig
    from pathtracer.parallel.multihost import (
        gather_image,
        make_multihost_mesh,
    )
    from pathtracer.parallel.tiles import (
        render_frame_distributed_jit,
        shard_state,
    )
    from pathtracer.render import init_state, render_frame
    from pathtracer.render.state import RenderState
    from pathtracer.scene import load_scene, scene_path

    mesh = make_multihost_mesh(n_spp=2)
    assert mesh.shape == {"tiles": 4, "spp": 2}
    # every 'spp' psum group must sit within one process (NVLink, not the
    # host network)
    for row in mesh.devices:
        assert len({d.process_index for d in row}) == 1

    scene = load_scene(scene_path("cornellbox"))
    cfg = RenderConfig(
        samples_per_frame=2, max_path_length=2, intersector="brute"
    )
    h, w = 8, 16

    # host-side numpy values device_put cleanly onto cross-process shardings
    rep = NamedSharding(mesh, P())
    scene = jax.tree.map(lambda x: jax.device_put(np.asarray(x), rep), scene)
    s0 = init_state(h, w)
    s0 = RenderState(*(np.asarray(x) for x in s0))
    state = shard_state(s0, mesh)

    step = render_frame_distributed_jit(mesh, cfg)
    state = step(state, scene)
    state = step(state, scene)
    img = gather_image(state)  # <- the process_allgather DCN branch
    assert img.shape == (h, w, 3)

    # bit-comparable to the single-process render (counter-based RNG):
    # every process independently checks the gathered image
    ref = init_state(h, w)
    ref = render_frame(ref, scene, cfg)
    ref = render_frame(ref, scene, cfg)
    np.testing.assert_allclose(img, np.asarray(ref.accum), atol=2e-6)

    print(f"MULTIHOST_OK {pid}", flush=True)


if __name__ == "__main__":
    main()
