"""rays/s scaling of trace_mesh over face count (VERDICT r4 next #9).

The AABB chunk-skip + Morton face ordering should make coherent-ray cost
grow with the geometry a bundle approaches, not the scene total: sub-linear
growth from 1k -> 10k -> 50k faces. A camera-style coherent bundle traces a
tessellated sphere scene of increasing density.

Usage, from the repository root on the GPU:
    python scripts/bench_mesh_trace.py
"""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from vk_gaussian_splatting_tpu.ops.raytrace import trace_mesh  # noqa: E402


def sphere_mesh(n_faces):
    """UV-sphere triangle soup with ~n_faces faces, radius 1."""
    rows = max(int(np.sqrt(n_faces / 2)), 3)
    cols = 2 * rows
    th = np.linspace(0, np.pi, rows + 1)
    ph = np.linspace(0, 2 * np.pi, cols + 1)[:-1]
    t, p = np.meshgrid(th, ph, indexing="ij")
    pts = np.stack([np.sin(t) * np.cos(p), np.cos(t),
                    np.sin(t) * np.sin(p)], -1).reshape(-1, 3)
    idx = []
    for i in range(rows):
        for j in range(cols):
            a = i * cols + j
            b = i * cols + (j + 1) % cols
            c = (i + 1) * cols + j
            d = (i + 1) * cols + (j + 1) % cols
            idx += [[a, b, c], [b, d, c]]
    return (jnp.asarray(pts, jnp.float32),
            jnp.asarray(np.asarray(idx, np.int32)))


def camera_rays(n=65536):
    s = int(np.sqrt(n))
    u, v = np.meshgrid(np.linspace(-0.6, 0.6, s), np.linspace(-0.6, 0.6, s))
    d = np.stack([u.ravel(), v.ravel(), np.ones(s * s)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.tile(np.asarray([[0.0, 0.0, -3.0]]), (s * s, 1))
    return (jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32),
            jnp.zeros((s * s,), jnp.float32))


def t_best(fn, *a, n=5):
    for _ in range(2):
        jax.block_until_ready(fn(*a))
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*a))
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    o, d, tmin = camera_rays()
    r = o.shape[0]
    prev = None
    for nf in (1000, 10000, 50000):
        pos, idx = sphere_mesh(nf)
        f = int(idx.shape[0])
        fn = jax.jit(lambda p, i: trace_mesh(p, i, o, d, tmin))
        dt = t_best(fn, pos, idx)
        hits = int(jnp.sum(trace_mesh(pos, idx, o, d, tmin).hit))
        rate = r / dt / 1e6
        growth = "" if prev is None else \
            f"  (x{dt / prev:.2f} time for x{f / prev_f:.1f} faces)"
        print(f"faces={f:6d}: {dt * 1e3:7.2f} ms  {rate:7.2f} Mrays/s  "
              f"hits={hits}{growth}", flush=True)
        prev, prev_f = dt, f


if __name__ == "__main__":
    main()
