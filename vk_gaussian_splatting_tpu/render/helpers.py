"""Visual helpers: infinite ground grid + transform gizmo overlays (H16 —
grid_helper_vk.{h,cpp} + transform_helper_vk.{h,cpp} + visual_helpers.slang).

The reference rasterizes helper geometry into a separate GBuffer and
composites it over the scene using scene depth (VisualHelpers::render,
visual_helpers_vk.h:74-80). The equivalent here evaluates the helpers
analytically per pixel — one vectorized jnp pass, no geometry:

- grid: camera-ray / y=0-plane intersection, adaptive 1/10/100 LOD line
  pattern with distance fade, colored X/Z axes (grid_helper_vk.h:36-41),
  checkerboard see-through where occluded by scene depth;
- gizmo: anti-aliased distance fields to the projected axis segments
  (translate/scale) or axis rings (rotate), X=red Y=green Z=blue.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from vk_gaussian_splatting_tpu.config import RenderConfig
from vk_gaussian_splatting_tpu.scene.cameras import Camera

AXIS_COLORS = jnp.array([[0.9, 0.2, 0.2],   # X red
                         [0.2, 0.8, 0.2],   # Y green
                         [0.25, 0.4, 0.95]])  # Z blue


def _pixel_rays(cam: Camera, cfg: RenderConfig):
    ys, xs = jnp.meshgrid(
        jnp.arange(cfg.height, dtype=jnp.float32) + 0.5,
        jnp.arange(cfg.width, dtype=jnp.float32) + 0.5,
        indexing="ij")
    d_cam = jnp.stack([(xs - cam.cx) / cam.fx, (ys - cam.cy) / cam.fy,
                       jnp.ones_like(xs)], -1)
    d_cam = d_cam / jnp.linalg.norm(d_cam, axis=-1, keepdims=True)
    dirs = jnp.matmul(d_cam, cam.viewmat[:3, :3],
                      precision=jax.lax.Precision.HIGHEST)
    return dirs, cam.position


def _line_mask(coord: jax.Array, spacing: float, width_w: jax.Array):
    """1 on grid lines of the given spacing, anti-aliased by the world-space
    per-pixel footprint width_w (screen-constant line thickness)."""
    d = jnp.abs(coord - jnp.round(coord / spacing) * spacing)
    return jnp.clip(1.5 - d / jnp.maximum(width_w, 1e-8), 0.0, 1.0)


def render_grid_overlay(
    image: jax.Array,          # (H, W, 3)
    depth: jax.Array,          # (H, W) scene view-z (0 = background)
    cam: Camera,
    cfg: RenderConfig,
    plane_y: float = 0.0,
    base_spacing: float = 1.0,
    opacity: float = 0.55,
    fade_distance: float = 80.0,
) -> jax.Array:
    """Composite the infinite X/Z grid under/over the scene."""
    dirs, origin = _pixel_rays(cam, cfg)
    dy = dirs[..., 1]
    t = (plane_y - origin[1]) / jnp.where(jnp.abs(dy) < 1e-8, 1e-8, dy)
    hit = t > 0
    px = origin[0] + t * dirs[..., 0]
    pz = origin[2] + t * dirs[..., 2]

    # world-space footprint of one pixel at the hit point (for constant
    # screen-space thickness, grid_helper_vk.h:37)
    foot = t / cam.fx * 1.5

    # adaptive LOD: minor lines at base, major at 10x, fade minor as the
    # footprint approaches the spacing (grid_helper_vk.h:36)
    lod = jnp.maximum(jnp.floor(jnp.log10(jnp.maximum(
        foot * 10.0 / base_spacing, 1e-6))), 0.0)
    s_minor = base_spacing * 10.0 ** lod
    s_major = s_minor * 10.0

    m_minor = jnp.maximum(_line_mask(px, s_minor, foot),
                          _line_mask(pz, s_minor, foot))
    m_major = jnp.maximum(_line_mask(px, s_major, foot),
                          _line_mask(pz, s_major, foot))
    line = jnp.maximum(0.45 * m_minor, m_major)

    # colored axes: x-axis line (z=0) blue-ish Z color... axis X lies along
    # z=0, axis Z along x=0 (X=red, Z=blue — grid_helper_vk.h:38)
    ax_x = _line_mask(pz, 1e30, foot * 1.2)   # z == 0 line
    ax_z = _line_mask(px, 1e30, foot * 1.2)   # x == 0 line
    color = jnp.full(image.shape, 0.62)
    color = jnp.where((ax_x > 0)[..., None],
                      AXIS_COLORS[0] * ax_x[..., None]
                      + color * (1 - ax_x[..., None]), color)
    color = jnp.where((ax_z > 0)[..., None],
                      AXIS_COLORS[2] * ax_z[..., None]
                      + color * (1 - ax_z[..., None]), color)
    line = jnp.maximum(line, jnp.maximum(ax_x, ax_z))

    # distance fade
    fade = jnp.clip(1.0 - t / fade_distance, 0.0, 1.0)
    alpha = opacity * line * fade * hit

    # occlusion: scene covers the grid where scene depth < grid t; occluded
    # grid shows as a sparse checkerboard (grid_helper_vk.h:40)
    ys, xs = jnp.meshgrid(jnp.arange(cfg.height), jnp.arange(cfg.width),
                          indexing="ij")
    checker = ((xs // 2 + ys // 2) % 2).astype(jnp.float32)
    occluded = (depth > 0) & (depth < t)
    alpha = jnp.where(occluded, alpha * 0.15 * checker, alpha)

    return image * (1 - alpha[..., None]) + color * alpha[..., None]


def _segment_distance(px, py, a, b):
    """(H,W) pixel distance to the 2D segment a->b (both (2,))."""
    ab = b - a
    denom = jnp.maximum(jnp.sum(ab * ab), 1e-8)
    t = jnp.clip(((px - a[0]) * ab[0] + (py - a[1]) * ab[1]) / denom, 0., 1.)
    qx = a[0] + t * ab[0]
    qy = a[1] + t * ab[1]
    return jnp.sqrt((px - qx) ** 2 + (py - qy) ** 2)


def _project(cam: Camera, p: jax.Array):
    """(..., 3) world -> (u, v, z)."""
    pc = jnp.matmul(p, cam.viewmat[:3, :3].T,
                    precision=jax.lax.Precision.HIGHEST) + cam.viewmat[:3, 3]
    z = jnp.maximum(pc[..., 2], 1e-6)
    return (cam.fx * pc[..., 0] / z + cam.cx,
            cam.fy * pc[..., 1] / z + cam.cy, z)


def render_gizmo_overlay(
    image: jax.Array,
    depth: jax.Array,
    cam: Camera,
    cfg: RenderConfig,
    origin,                    # (3,) gizmo anchor (selected instance origin)
    size: float = 1.0,
    mode: str = "translate",   # translate | scale | rotate
    thickness_px: float = 2.0,
    ring_segments: int = 48,
) -> jax.Array:
    """Composite a translate/scale axis triad or rotate rings at `origin`
    (TransformHelperVk modes). Helpers draw on top with dithered
    see-through when occluded (visual_helpers.slang:112-121)."""
    ys, xs = jnp.meshgrid(
        jnp.arange(cfg.height, dtype=jnp.float32) + 0.5,
        jnp.arange(cfg.width, dtype=jnp.float32) + 0.5, indexing="ij")
    origin = jnp.asarray(origin, jnp.float32)
    out = image
    checker = (((xs // 2 + ys // 2) % 2)).astype(jnp.float32)

    for ax in range(3):
        col = AXIS_COLORS[ax]
        if mode in ("translate", "scale"):
            tip = origin + size * jnp.eye(3)[ax]
            ua, va, za = _project(cam, origin)
            ub, vb, zb = _project(cam, tip)
            dist = _segment_distance(xs, ys, jnp.stack([ua, va]),
                                     jnp.stack([ub, vb]))
            zmid = 0.5 * (za + zb)
            alpha = jnp.clip(1.5 - dist / thickness_px, 0.0, 1.0)
            if mode == "scale":   # cube end caps read as scale handles
                tipd = jnp.sqrt((xs - ub) ** 2 + (ys - vb) ** 2)
                alpha = jnp.maximum(alpha,
                                    (tipd < 3 * thickness_px).astype(
                                        jnp.float32))
            occ = (depth > 0) & (depth < zmid)
        else:  # rotate: ring in the plane orthogonal to the axis
            theta = jnp.linspace(0, 2 * jnp.pi, ring_segments + 1)
            e1 = jnp.eye(3)[(ax + 1) % 3]
            e2 = jnp.eye(3)[(ax + 2) % 3]
            pts = (origin[None] + size * (jnp.cos(theta)[:, None] * e1
                                          + jnp.sin(theta)[:, None] * e2))
            u, v, z = _project(cam, pts)
            dist = jnp.full_like(xs, 1e30)
            for i in range(ring_segments):
                dist = jnp.minimum(dist, _segment_distance(
                    xs, ys, jnp.stack([u[i], v[i]]),
                    jnp.stack([u[i + 1], v[i + 1]])))
            alpha = jnp.clip(1.5 - dist / thickness_px, 0.0, 1.0)
            occ = (depth > 0) & (depth < jnp.mean(z))
        alpha = jnp.where(occ, alpha * 0.35 * checker, alpha)
        out = out * (1 - alpha[..., None]) + col * alpha[..., None]
    return out
