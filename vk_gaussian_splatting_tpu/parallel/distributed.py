"""Multi-process (multi-host) entry points.

The reference is a single-GPU app (SURVEY.md §2.4); scaling across hosts is
new scope here: ``jax.distributed`` + the shard_map policies of
parallel/sharded_render.py. This module holds the one-line init wrapper,
global-array plumbing, and a runnable multi-process training demo that the
2-process CPU test (tests/test_multihost.py) exercises end-to-end over the
distributed runtime (cross-process collectives), so the same entry point
runs unchanged across several GPU hosts (NCCL between processes).

Usage, one command per process:

    python -m vk_gaussian_splatting_tpu.parallel.distributed \
        --coordinator <host0>:8476 --num-processes N --process-id i

No cluster is detected automatically: pass the coordinator address, the
process count and this process's id.
"""

from __future__ import annotations

import dataclasses
import time

import jax
import numpy as np


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               platform: str | None = None) -> None:
    """jax.distributed bring-up: pass the coordinator address, process count
    and process id; for the CPU test harness also pass platform="cpu" (set
    BEFORE touching any jax API)."""
    if platform:
        jax.config.update("jax_platforms", platform)
        if platform == "cpu":
            # cross-process CPU collectives ride gloo over TCP (the DCN
            # stand-in for the test harness)
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh(axis: str = "data"):
    """1-D mesh over every device of every process."""
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()), (axis,))


def shard_leading(tree, mesh, axis: str = "data"):
    """device_put a host pytree as global arrays sharded on the leading dim.

    Every process must hold the identical host copy (same seed / same file);
    each contributes only its addressable shards."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    sh = NamedSharding(mesh, P(axis))

    def put(x):
        x = np.asarray(x)
        assert x.shape[0] % mesh.size == 0, (
            f"leading dim {x.shape[0]} must divide the mesh size {mesh.size}")
        return jax.device_put(x, sh)

    return jax.tree.map(put, tree)


def replicate(tree, mesh):
    from jax.sharding import NamedSharding, PartitionSpec as P
    sh = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(np.asarray(x), sh), tree)


def multiprocess_train_demo(n_splats: int = 256, width: int = 64,
                            height_tiles_per_dev: int = 1, steps: int = 3,
                            sh_degree: int = 1):
    """Run `steps` sharded train steps over the global mesh; returns a dict
    with losses, throughput, and the collective-traffic estimate. All
    processes compute the identical result (same-seed host data)."""
    from vk_gaussian_splatting_tpu.config import RenderConfig
    from vk_gaussian_splatting_tpu.parallel.sharded_render import (
        train_step_sharded,
    )
    from vk_gaussian_splatting_tpu.scene.cameras import look_at
    from vk_gaussian_splatting_tpu.scene.splat_set import random_splats
    import jax.numpy as jnp

    mesh = global_mesh()
    nd = mesh.size
    cfg = RenderConfig(width=width, height=16 * height_tiles_per_dev * nd,
                       sh_degree=sh_degree)
    n = -(-n_splats // nd) * nd
    splats_h = random_splats(jax.random.key(0), n, sh_degree=sh_degree,
                             scale_range=(-3.0, -1.0))
    cam = look_at([0, 0, -9], [0, 0, 0], [0, 1, 0], cfg.width, cfg.height)
    target_h = np.zeros((cfg.height, cfg.width, 3), np.float32)

    splats = shard_leading(splats_h, mesh)
    cam = replicate(cam, mesh)
    target = shard_leading(target_h, mesh)

    losses = []
    t0 = None
    for step in range(steps):
        splats, loss = train_step_sharded(splats, cam, target, cfg,
                                          max_pairs=4096, mesh=mesh,
                                          lr=1e-4)
        losses.append(float(loss))
        if step == 0:
            jax.block_until_ready(loss)
            t0 = time.perf_counter()
    jax.block_until_ready(loss)
    dt = (time.perf_counter() - t0) / max(steps - 1, 1)

    # collective traffic: the all_gather of projected attributes (~15 f32 per
    # splat per device) + the psum_scatter of their gradients in the backward
    proj_floats = 15
    gather_bytes = n * proj_floats * 4 * (nd - 1) // nd * 2  # fwd + bwd
    return {
        "num_processes": jax.process_count(),
        "num_devices": nd,
        "losses": losses,
        "step_time_s": dt,
        "pixels_per_s": cfg.width * cfg.height / dt,
        "collective_bytes_per_step": gather_bytes,
    }


def main(argv=None):
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--platform", default=None,
                    help="force a platform (the CPU test harness uses cpu)")
    ap.add_argument("--splats", type=int, default=256)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)

    initialize(args.coordinator, args.num_processes, args.process_id,
               platform=args.platform)
    stats = multiprocess_train_demo(n_splats=args.splats, steps=args.steps)
    ok = all(np.isfinite(v) for v in stats["losses"])
    print(f"MULTIHOST_{'OK' if ok else 'FAIL'} "
          f"process={jax.process_index()} {json.dumps(stats)}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
