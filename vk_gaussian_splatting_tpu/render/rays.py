"""Per-pixel camera rays packed into per-tile blocks for the gut3d blender.

Re-expresses the fragment-shader ray generation of
threedgut_raster.frag.slang:92-109 (generatePinholeRay / generateFisheyeRay +
thin-lens depthOfField, cameras.h.slang:27-105) as one vectorized jnp pass
over the padded tile grid, emitting the (T, 8, 256) pixel-context array the
tile blender reads per tile (rows RAY_* of ops/response.py).

DoF sampling uses counter-based jax.random keyed on (frame sample id) — the
deterministic replacement for the fragment shader's xxhash32 seed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from vk_gaussian_splatting_tpu.config import CameraType, RenderConfig, tiles_x, tiles_y
from vk_gaussian_splatting_tpu.ops.projection import fisheye_max_angle
from vk_gaussian_splatting_tpu.ops.tile_blend import OUT_COLS, PIX, TILE
from vk_gaussian_splatting_tpu.scene.cameras import Camera


def build_tile_rays(cam: Camera, cfg: RenderConfig,
                    sample_id: int | jax.Array = 0) -> jax.Array:
    """(T, 8, 256): rows 0-2 unit ray direction, 3-5 ray origin (world/model
    space). Applies thin-lens DoF when cam.aperture > 0."""
    tx, ty = tiles_x(cfg), tiles_y(cfg)
    w_pad, h_pad = tx * TILE, ty * TILE
    ys, xs = jnp.meshgrid(
        jnp.arange(h_pad, dtype=jnp.float32) + 0.5,
        jnp.arange(w_pad, dtype=jnp.float32) + 0.5,
        indexing="ij",
    )
    if cfg.camera_type == CameraType.PINHOLE:
        d_cam = jnp.stack(
            [(xs - cam.cx) / cam.fx, (ys - cam.cy) / cam.fy, jnp.ones_like(xs)],
            -1,
        )
        d_cam = d_cam / jnp.linalg.norm(d_cam, axis=-1, keepdims=True)
    else:
        # inverse equidistant fisheye: theta = r / f
        mx = (xs - cam.cx) / cam.fx
        my = (ys - cam.cy) / cam.fy
        theta = jnp.sqrt(mx * mx + my * my)
        max_angle = fisheye_max_angle(cfg.width, cfg.height, cam.cx, cam.cy,
                                      cam.fx, cam.fy)
        safe = jnp.maximum(theta, 1e-8)
        sin_t = jnp.sin(theta)
        d_cam = jnp.stack(
            [sin_t * mx / safe, sin_t * my / safe, jnp.cos(theta)], -1)
        # out-of-FOV pixels get a degenerate backward ray that never hits
        d_cam = jnp.where((theta < max_angle)[..., None], d_cam,
                          jnp.array([0.0, 0.0, -1.0]))

    from vk_gaussian_splatting_tpu.config import ShutterType
    r_wc = cam.viewmat[:3, :3].T    # DoF lens basis uses the start pose
    if cfg.shutter == ShutterType.GLOBAL:
        dirs = jnp.matmul(d_cam, r_wc.T,
                          precision=jax.lax.Precision.HIGHEST)  # (H,W,3)
        origin = jnp.broadcast_to(cam.position, dirs.shape)
    else:
        # rolling shutter: each pixel's ray uses the pose at its exact scan
        # time (the per-pixel analog of projectPointWithShutter)
        from vk_gaussian_splatting_tpu.scene.cameras import (
            quat_slerp,
            shutter_poses,
            shutter_time,
        )
        t = shutter_time(cfg.shutter, xs, ys, cfg.width, cfg.height)
        (q0, t0), (q1, t1) = shutter_poses(cam)
        q = quat_slerp(q0, q1, t)                             # (H,W,4)
        # world vectors via the conjugate (camera->world) rotation
        w, x, y, z = -q[..., 0], q[..., 1], q[..., 2], q[..., 3]

        def rot(vx, vy, vz):
            ox = ((1 - 2 * (y * y + z * z)) * vx + 2 * (x * y - w * z) * vy
                  + 2 * (x * z + w * y) * vz)
            oy = (2 * (x * y + w * z) * vx + (1 - 2 * (x * x + z * z)) * vy
                  + 2 * (y * z - w * x) * vz)
            oz = (2 * (x * z - w * y) * vx + 2 * (y * z + w * x) * vy
                  + (1 - 2 * (x * x + y * y)) * vz)
            return ox, oy, oz

        dx, dy, dz = rot(d_cam[..., 0], d_cam[..., 1], d_cam[..., 2])
        dirs = jnp.stack([dx, dy, dz], -1)
        tt = t0 + t[..., None] * (t1 - t0)                    # (H,W,3)
        ox, oy, oz = rot(tt[..., 0], tt[..., 1], tt[..., 2])
        origin = -jnp.stack([ox, oy, oz], -1)

    def with_dof(args):
        dirs, origin = args
        # thin-lens perturbation (cameras.h.slang:85-105)
        key = jax.random.fold_in(jax.random.key(0x3D6F), jnp.asarray(sample_id, jnp.int32))
        k1, k2 = jax.random.split(key)
        r1 = jax.random.uniform(k1, dirs.shape[:2]) * (2.0 * jnp.pi)
        r2 = jax.random.uniform(k2, dirs.shape[:2]) * cam.aperture
        cam_right = r_wc[:, 0]
        cam_up = r_wc[:, 1]
        lens = (jnp.cos(r1)[..., None] * cam_right
                + jnp.sin(r1)[..., None] * cam_up) * jnp.sqrt(r2)[..., None]
        focal_pt = dirs * cam.focus_dist
        new_dir = focal_pt - lens
        new_dir = new_dir / jnp.linalg.norm(new_dir, axis=-1, keepdims=True)
        return new_dir, origin + lens

    dirs, origin = jax.lax.cond(
        cam.aperture > 0.0, with_dof, lambda a: a, (dirs, origin))

    # pack (H,W,3)+(H,W,3) -> (T, 8, 256)
    full = jnp.concatenate(
        [dirs, origin, jnp.zeros(dirs.shape[:2] + (OUT_COLS - 6,), jnp.float32)],
        axis=-1,
    )                                                        # (H,W,8)
    blocks = full.reshape(ty, TILE, tx, TILE, OUT_COLS)
    return blocks.transpose(0, 2, 4, 1, 3).reshape(ty * tx, OUT_COLS, PIX)
