"""The golden-tiled scene: the checked-in trained corpus (assets/golden,
made by scripts/make_golden_scene.py) replicated on a grid to any size, so
that local screen statistics come from an actual optimization run rather
than from random_splats."""

from __future__ import annotations

import dataclasses
import os

import jax.numpy as jnp

GOLDEN_PLY = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "assets", "golden", "golden_scene.ply")


def golden_tiled(n_splats: int, spacing: float = 7.5):
    """About n_splats splats as a reps x reps grid of copies of the golden
    scene. Returns (SplatSet, camera eye, look-at target) for a view that
    frames the whole grid."""
    from vk_gaussian_splatting_tpu.io.ply import load_ply

    base = load_ply(GOLDEN_PLY)
    n0 = base.means.shape[0]
    reps = max(1, round((n_splats / n0) ** 0.5))
    offs = jnp.asarray(
        [[(i - (reps - 1) / 2) * spacing, 0.0, (j - (reps - 1) / 2) * spacing]
         for i in range(reps) for j in range(reps)], jnp.float32)
    means = (jnp.asarray(base.means)[None] + offs[:, None, :]).reshape(-1, 3)

    def tile(x):
        x = jnp.asarray(x)
        return jnp.tile(x, (reps * reps,) + (1,) * (x.ndim - 1))

    scene = dataclasses.replace(
        base, means=means, scales=tile(base.scales), quats=tile(base.quats),
        opacities=tile(base.opacities), sh_dc=tile(base.sh_dc),
        sh_rest=tile(base.sh_rest))
    eye = [0.0, -0.55 * reps * spacing, -0.8 * reps * spacing]
    return scene, eye, [0.0, 0.5, 0.0]
