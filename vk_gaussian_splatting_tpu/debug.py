"""Per-pixel debug traces (H19 shader-feedback analog).

The reference instruments the integrator with a 200-entry per-pixel trace
(hit distance, alpha, transmittance, integrated radiance —
shaderio.h:332-399, rgen:128-150) read back for plotting. The equivalent here
evaluates the same quantities for one pixel analytically from the projected
splats — a numeric oracle for any pixel without touching the kernels.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from vk_gaussian_splatting_tpu.config import RenderConfig
from vk_gaussian_splatting_tpu.ops.projection import ProjectedSplats


@dataclasses.dataclass
class PixelTrace:
    """Sorted per-splat contributions at one pixel."""

    splat_id: np.ndarray       # (K,)
    depth: np.ndarray          # (K,)
    alpha: np.ndarray          # (K,)
    transmittance: np.ndarray  # (K,) T before each splat
    weight: np.ndarray         # (K,) alpha * T
    radiance: np.ndarray       # (K,3) cumulative integrated radiance
    final_color: np.ndarray    # (3,)
    final_transmittance: float


def pixel_trace(proj: ProjectedSplats, x: int, y: int,
                cfg: RenderConfig, max_entries: int = 200) -> PixelTrace:
    """Contribution trace for pixel (x, y) under the gs2d model."""
    rc = cfg.raster
    px, py = x + 0.5, y + 0.5
    xy = np.asarray(proj.xy)
    conic = np.asarray(proj.conic)
    dx = px - xy[:, 0]
    dy = py - xy[:, 1]
    d = conic[:, 0] * dx * dx + 2 * conic[:, 1] * dx * dy + conic[:, 2] * dy * dy
    g = np.exp(-0.5 * d)
    a_raw = np.asarray(proj.alpha) * g
    mask = ((d <= rc.alpha_cull_qmax) & (a_raw >= rc.alpha_min)
            & np.asarray(proj.valid))
    ids = np.nonzero(mask)[0]
    depth = np.asarray(proj.depth)[ids]
    order = np.argsort(depth, kind="stable")
    ids = ids[order][:max_entries]

    alpha = np.minimum(a_raw[ids], rc.alpha_clamp)
    t = np.concatenate([[1.0], np.cumprod(1.0 - alpha)[:-1]])
    w = alpha * t
    colors = np.asarray(proj.color)[ids]
    radiance = np.cumsum(w[:, None] * colors, axis=0)
    return PixelTrace(
        splat_id=ids,
        depth=np.asarray(proj.depth)[ids],
        alpha=alpha,
        transmittance=t,
        weight=w,
        radiance=radiance,
        final_color=radiance[-1] if len(ids) else np.zeros(3),
        final_transmittance=float(np.prod(1.0 - alpha)),
    )


def format_trace(trace: PixelTrace, limit: int = 20) -> str:
    """Human-readable dump (the ShaderFeedbackUI table analog)."""
    lines = [f"{'#':>4} {'splat':>8} {'depth':>9} {'alpha':>7} {'T':>7} "
             f"{'weight':>7}"]
    for i in range(min(len(trace.splat_id), limit)):
        lines.append(
            f"{i:>4} {trace.splat_id[i]:>8} {trace.depth[i]:>9.4f} "
            f"{trace.alpha[i]:>7.4f} {trace.transmittance[i]:>7.4f} "
            f"{trace.weight[i]:>7.4f}")
    lines.append(f"final color {trace.final_color}, "
                 f"T {trace.final_transmittance:.5f}, "
                 f"{len(trace.splat_id)} contributors")
    return "\n".join(lines)


def _pixel_ray(cam, x: int, y: int, cfg: RenderConfig):
    """World-space ray through pixel center (pinhole or equidistant fisheye —
    cameras.h.slang:27-105)."""
    from vk_gaussian_splatting_tpu.config import CameraType
    px, py = x + 0.5, y + 0.5
    u = (px - float(cam.cx)) / float(cam.fx)
    v = (py - float(cam.cy)) / float(cam.fy)
    if cfg.camera_type == CameraType.FISHEYE:
        r = np.sqrt(u * u + v * v)
        theta = r  # equidistant: angle proportional to radius
        s = np.sin(theta) / max(r, 1e-12)
        d_cam = np.asarray([u * s, v * s, np.cos(theta)])
    else:
        d_cam = np.asarray([u, v, 1.0])
    d_cam = d_cam / np.linalg.norm(d_cam)
    rot = np.asarray(cam.viewmat)[:3, :3]
    origin = np.asarray(cam.position)
    return origin, rot.T @ d_cam


def pixel_trace_gut(prepared, cam, x: int, y: int, cfg: RenderConfig,
                    order: str = "depth",
                    max_entries: int = 200) -> PixelTrace:
    """Contribution trace for pixel (x, y) under the exact 3D ray response —
    the gut3d (order="depth": UT view-depth blend order of the 3DGUT raster)
    and 3DGRT (order="radial": shared-origin per-ray-t order of the RT
    pipeline) oracle. Evaluates particleProcessHit along the pixel's actual
    camera ray (threedgrt.h.slang:57-223), so it covers the pipelines the
    round-1 analytic gs2d-only trace could not (shaderio.h:332-399)."""
    import jax.numpy as jnp

    from vk_gaussian_splatting_tpu.ops.raytrace import (
        _chunk_alpha_t,
        _splat_rows,
        splat_view_colors,
    )
    from vk_gaussian_splatting_tpu.scene.cameras import view_transform_points

    origin, direction = _pixel_ray(cam, x, y, cfg)
    colors, opac = splat_view_colors(prepared, jnp.asarray(origin), cfg)
    n = prepared.num_splats
    ids0 = jnp.arange(n, dtype=jnp.float32)
    rows = _splat_rows(prepared, colors, opac, ids0)  # identity order
    alpha, t_hit = _chunk_alpha_t(
        rows, jnp.asarray(origin, jnp.float32)[None, :],
        jnp.asarray(direction, jnp.float32)[None, :],
        cfg.rt.kernel_degree, cfg.rt.alpha_min, cfg.rt.alpha_clamp,
        cfg.splat_scale)
    alpha = np.asarray(alpha)[0]
    t_hit = np.asarray(t_hit)[0]

    if order == "radial":
        key = np.linalg.norm(np.asarray(prepared.means) - origin, axis=-1)
    else:
        p_view = np.asarray(view_transform_points(cam.viewmat,
                                                  prepared.means))
        key = p_view[:, 2]
    mask = (alpha > 0.0) & (t_hit > 0.0)
    ids = np.nonzero(mask)[0]
    ids = ids[np.argsort(key[ids], kind="stable")][:max_entries]

    a = alpha[ids]
    t = np.concatenate([[1.0], np.cumprod(1.0 - a)[:-1]])
    w = a * t
    cols = np.asarray(rows)[10:13, ids].T
    radiance = np.cumsum(w[:, None] * cols, axis=0)
    return PixelTrace(
        splat_id=ids,
        depth=t_hit[ids],
        alpha=a,
        transmittance=t,
        weight=w,
        radiance=radiance,
        final_color=(radiance[-1] if len(ids) else np.zeros(3)),
        final_transmittance=float(np.prod(1.0 - a)) if len(ids) else 1.0,
    )
