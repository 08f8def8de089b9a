"""Cameras.

Clean OpenCV-convention re-design of the reference camera stack
(camera_set.h:1-273, shaders/cameras.h.slang:27-105, FrameInfo math in
gaussian_splatting.cpp:1150-1295):

- view matrix maps world -> camera with +x right, +y down, +z forward
  (COLMAP / OpenCV). The reference uses Vulkan clip space; we never build a
  projection matrix — the tile rasterizer works directly in pixel space with
  (fx, fy, cx, cy).
- pinhole and equidistant ("perfect") fisheye models, thin-lens depth of field
  (focus distance + aperture), matching cameras.h.slang ray generation.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Camera:
    """Dynamic camera parameters (all jax scalars/arrays; shapes stay static).

    viewmat: (4,4) world->camera, OpenCV axes.
    fx, fy, cx, cy: pixel-space intrinsics.
    near, far: clip distances (depth culling only; no projective clip).
    focus_dist, aperture: thin-lens DoF (camera_set.h dofMode/focusDist/aperture).
    """

    viewmat: jax.Array
    fx: jax.Array
    fy: jax.Array
    cx: jax.Array
    cy: jax.Array
    near: jax.Array
    far: jax.Array
    focus_dist: jax.Array
    aperture: jax.Array
    # OpenCV distortion pack (threedgut_camera_models.h.slang:26-42), all
    # zeros = ideal lens: [0:6] rational radial k1..k6, [6:8] tangential
    # p1 p2, [8:12] thin-prism s1..s4, [12:16] fisheye theta-poly k1..k4,
    # [16] fisheye max angle override (0 = auto), [17] pad.
    distortion: jax.Array
    # rolling-shutter end pose (SensorState.endPose, threedgut_sensors
    # .h.slang:28-50); equals viewmat for a global shutter
    viewmat_end: jax.Array

    @property
    def world_from_camera(self) -> jax.Array:
        r = self.viewmat[:3, :3]
        t = self.viewmat[:3, 3]
        inv = jnp.eye(4, dtype=self.viewmat.dtype)
        inv = inv.at[:3, :3].set(r.T)
        inv = inv.at[:3, 3].set(-r.T @ t)
        return inv

    @property
    def position(self) -> jax.Array:
        r = self.viewmat[:3, :3]
        return -jnp.matmul(r.T, self.viewmat[:3, 3],
                           precision=jax.lax.Precision.HIGHEST)


def make_camera(
    viewmat,
    fx,
    fy,
    cx,
    cy,
    near=0.01,
    far=1e4,
    focus_dist=1.0,
    aperture=0.0,
    distortion=None,
    viewmat_end=None,
) -> Camera:
    f32 = lambda v: jnp.asarray(v, jnp.float32)
    if distortion is None:
        distortion = jnp.zeros((18,), jnp.float32)
    if viewmat_end is None:
        viewmat_end = viewmat
    return Camera(
        viewmat=f32(viewmat),
        fx=f32(fx), fy=f32(fy), cx=f32(cx), cy=f32(cy),
        near=f32(near), far=f32(far),
        focus_dist=f32(focus_dist), aperture=f32(aperture),
        distortion=f32(distortion),
        viewmat_end=f32(viewmat_end),
    )


def look_at(eye, center, up, width: int, height: int, fov_y_rad: float = 0.8,
            near: float = 0.01, far: float = 1e4) -> Camera:
    """Build a pinhole camera looking from eye at center (OpenCV axes: y down)."""
    eye = np.asarray(eye, np.float64)
    center = np.asarray(center, np.float64)
    up = np.asarray(up, np.float64)
    fwd = center - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)  # y-down completes right-handed (x, y, z)=(right, down, fwd)
    r = np.stack([right, down, fwd], axis=0)  # world->camera rotation rows
    t = -r @ eye
    viewmat = np.eye(4, dtype=np.float32)
    viewmat[:3, :3] = r
    viewmat[:3, 3] = t
    fy = 0.5 * height / np.tan(0.5 * fov_y_rad)
    return make_camera(viewmat, fy, fy, width * 0.5, height * 0.5, near, far)


def view_transform_points(viewmat: jax.Array, points: jax.Array) -> jax.Array:
    """(N,3) world points -> camera space via (4,4) viewmat.

    precision=highest: on the GPU a default f32 matmul may run in TF32
    (about three decimal digits), which visibly shifts projected positions;
    geometry math must stay full f32."""
    return jnp.matmul(points, viewmat[:3, :3].T,
                      precision=jax.lax.Precision.HIGHEST) + viewmat[:3, 3]


def project_pinhole(cam: Camera, p_cam: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Camera-space (N,3) -> pixel (N,2), depth (N,). No clipping (caller masks z)."""
    z = p_cam[..., 2]
    zs = jnp.where(jnp.abs(z) < 1e-8, 1e-8, z)
    u = cam.fx * p_cam[..., 0] / zs + cam.cx
    v = cam.fy * p_cam[..., 1] / zs + cam.cy
    return jnp.stack([u, v], -1), z


def project_fisheye_equidistant(cam: Camera, p_cam: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Equidistant fisheye r = f * theta (the reference's "perfect fisheye",
    threedgut_camera_projections.h.slang + initPerfectFisheyeCamera in dist.comp.slang:78).
    Returns pixel coords (N,2) and view depth (N,) = |p| * sign(z)·cos? — we
    return the euclidean range along the optical axis direction (z) for sorting.
    """
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    rxy = jnp.sqrt(x * x + y * y)
    theta = jnp.arctan2(rxy, z)
    scale = jnp.where(rxy > 1e-8, theta / jnp.maximum(rxy, 1e-8), 1.0 / jnp.maximum(z, 1e-8))
    u = cam.fx * x * scale + cam.cx
    v = cam.fy * y * scale + cam.cy
    return jnp.stack([u, v], -1), z


def camera_rays_pinhole(cam: Camera, width: int, height: int):
    """Per-pixel world-space rays (origin (3,), dirs (H,W,3)) — cameras.h.slang:27-60."""
    ys, xs = jnp.meshgrid(
        jnp.arange(height, dtype=jnp.float32) + 0.5,
        jnp.arange(width, dtype=jnp.float32) + 0.5,
        indexing="ij",
    )
    d_cam = jnp.stack(
        [(xs - cam.cx) / cam.fx, (ys - cam.cy) / cam.fy, jnp.ones_like(xs)], -1
    )
    r_wc = cam.viewmat[:3, :3].T
    dirs = jnp.matmul(d_cam, r_wc.T, precision=jax.lax.Precision.HIGHEST)
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    return cam.position, dirs


def camera_rays_fisheye(cam: Camera, width: int, height: int):
    """Equidistant fisheye ray generation (cameras.h.slang fisheye path)."""
    ys, xs = jnp.meshgrid(
        jnp.arange(height, dtype=jnp.float32) + 0.5,
        jnp.arange(width, dtype=jnp.float32) + 0.5,
        indexing="ij",
    )
    mx = (xs - cam.cx) / cam.fx
    my = (ys - cam.cy) / cam.fy
    theta = jnp.sqrt(mx * mx + my * my)
    valid = theta < jnp.pi
    sin_t = jnp.sin(theta)
    safe = jnp.maximum(theta, 1e-8)
    d_cam = jnp.stack(
        [sin_t * mx / safe, sin_t * my / safe, jnp.cos(theta)], -1
    )
    r_wc = cam.viewmat[:3, :3].T
    dirs = d_cam @ r_wc.T
    return cam.position, jnp.where(valid[..., None], dirs, 0.0)


# ---------------------------------------------------------------------------
# Rolling shutter (threedgut_sensors.h.slang + projectPointWithShutter,
# threedgut_camera_projections.h.slang:189-238): the camera pose slerps
# between viewmat (shutter start) and viewmat_end (shutter end) per pixel
# row/column scan time.
# ---------------------------------------------------------------------------


def rotmat_to_quat(r: jax.Array) -> jax.Array:
    """(3,3) rotation -> (w, x, y, z) unit quaternion (branchless via the
    four Shepperd candidates, normalized pick of the largest)."""
    m00, m01, m02 = r[0, 0], r[0, 1], r[0, 2]
    m10, m11, m12 = r[1, 0], r[1, 1], r[1, 2]
    m20, m21, m22 = r[2, 0], r[2, 1], r[2, 2]
    qw = jnp.sqrt(jnp.maximum(0.0, 1 + m00 + m11 + m22)) / 2
    qx = jnp.sqrt(jnp.maximum(0.0, 1 + m00 - m11 - m22)) / 2
    qy = jnp.sqrt(jnp.maximum(0.0, 1 - m00 + m11 - m22)) / 2
    qz = jnp.sqrt(jnp.maximum(0.0, 1 - m00 - m11 + m22)) / 2
    qx = qx * jnp.sign(jnp.where(m21 - m12 == 0, 1.0, m21 - m12))
    qy = qy * jnp.sign(jnp.where(m02 - m20 == 0, 1.0, m02 - m20))
    qz = qz * jnp.sign(jnp.where(m10 - m01 == 0, 1.0, m10 - m01))
    q = jnp.stack([qw, qx, qy, qz])
    return q / jnp.linalg.norm(q).clip(1e-12)


def quat_slerp(q0: jax.Array, q1: jax.Array, t: jax.Array) -> jax.Array:
    """Slerp between (4,) quaternions at (...,) parameters -> (..., 4)."""
    d = jnp.sum(q0 * q1)
    q1 = jnp.where(d < 0, -q1, q1)
    d = jnp.abs(jnp.clip(d, -1.0, 1.0))
    theta = jnp.arccos(d)
    sin_t = jnp.sin(theta)
    use_lerp = sin_t < 1e-5
    w0 = jnp.where(use_lerp, 1.0 - t, jnp.sin((1.0 - t) * theta)
                   / jnp.where(use_lerp, 1.0, sin_t))
    w1 = jnp.where(use_lerp, t, jnp.sin(t * theta)
                   / jnp.where(use_lerp, 1.0, sin_t))
    q = w0[..., None] * q0 + w1[..., None] * q1
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True).clip(1e-12)


def shutter_time(shutter: int, u: jax.Array, v: jax.Array,
                 width: int, height: int) -> jax.Array:
    """relativeShutterTime (threedgut_camera_projections.h.slang:61-76)."""
    from vk_gaussian_splatting_tpu.config import ShutterType
    if shutter == ShutterType.ROLLING_TOP_TO_BOTTOM:
        return jnp.clip(jnp.floor(v) / (height - 1.0), 0.0, 1.0)
    if shutter == ShutterType.ROLLING_LEFT_TO_RIGHT:
        return jnp.clip(jnp.floor(u) / (width - 1.0), 0.0, 1.0)
    if shutter == ShutterType.ROLLING_BOTTOM_TO_TOP:
        return jnp.clip((height - jnp.ceil(v)) / (height - 1.0), 0.0, 1.0)
    if shutter == ShutterType.ROLLING_RIGHT_TO_LEFT:
        return jnp.clip((width - jnp.ceil(u)) / (width - 1.0), 0.0, 1.0)
    return jnp.full_like(u, 0.5)


def shutter_poses(cam: Camera):
    """((q0, t0), (q1, t1)) world->camera quaternion+translation pair for the
    shutter start/end viewmats."""
    return ((rotmat_to_quat(cam.viewmat[:3, :3]), cam.viewmat[:3, 3]),
            (rotmat_to_quat(cam.viewmat_end[:3, :3]), cam.viewmat_end[:3, 3]))


def shutter_transform_cols(cam: Camera, alpha: jax.Array, px, py, pz):
    """World -> camera at per-element shutter times: rotate by the slerped
    world->camera quaternion, add the lerped translation. Column inputs of
    any broadcastable shape."""
    (q0, t0), (q1, t1) = shutter_poses(cam)
    q = quat_slerp(q0, q1, alpha)                     # (..., 4)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    # q * p * q^-1 expanded (rows of R(q)) — SoA, no (..., 3, 3) stacks
    cxx = ((1 - 2 * (y * y + z * z)) * px + 2 * (x * y - w * z) * py
           + 2 * (x * z + w * y) * pz)
    cyy = (2 * (x * y + w * z) * px + (1 - 2 * (x * x + z * z)) * py
           + 2 * (y * z - w * x) * pz)
    czz = (2 * (x * z - w * y) * px + 2 * (y * z + w * x) * py
           + (1 - 2 * (x * x + y * y)) * pz)
    tt = t0 + alpha[..., None] * (t1 - t0)            # (..., 3)
    return (cxx + tt[..., 0], cyy + tt[..., 1], czz + tt[..., 2])


class CameraSet:
    """Host-side camera presets (camera_set.h:116-216): active camera + named list."""

    def __init__(self):
        self.cameras: list[Camera] = []
        self.names: list[str] = []
        self.active: int = -1

    def add(self, cam: Camera, name: str = "") -> int:
        self.cameras.append(cam)
        self.names.append(name or f"camera {len(self.cameras) - 1}")
        if self.active < 0:
            self.active = 0
        return len(self.cameras) - 1

    def get(self) -> Camera:
        return self.cameras[self.active]
