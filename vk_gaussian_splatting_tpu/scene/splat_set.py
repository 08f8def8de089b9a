"""Splat-set data model.

Re-design of the reference's RAM/VRAM splat storage:

- ``SplatSet`` mirrors the *raw* PLY parameterization (splat_set.h:33-47):
  log-space scales, logit opacities, (w,x,y,z) quaternions, SH coefficients.
  This is the differentiable parameter pytree used for training.
- ``PreparedSplats`` mirrors the device-resident form the reference precomputes
  at upload time (splat_set_vk.cpp:265-345): 3D covariances from (scale, quat),
  sigmoid-activated opacity, SH0 folded into a base RGB color, and the SH rest
  coefficients repacked degree-major / RGB-interleaved with optional
  fp16 / uint8 quantization (splat_set_vk.cpp:396-447).

Coordinate-system conversion follows the spz convention tables
(3rdparty/spz/src/cc/splat-types.h:24-80, used via splat_set.h:78-114).
"""

from __future__ import annotations

import dataclasses
import enum

import jax
import jax.numpy as jnp
import numpy as np

from vk_gaussian_splatting_tpu.config import ShFormat

SH_C0 = 0.28209479177387814


class CoordinateSystem(enum.IntEnum):
    """Axis conventions (spz splat-types.h:24-33). Letters = direction of +x,+y,+z."""

    UNSPECIFIED = 0
    LDB = 1
    RDB = 2
    LUB = 3
    RUB = 4  # Three.js
    LDF = 5
    RDF = 6  # PLY / INRIA 3DGS
    LUF = 7  # GLB
    RUF = 8  # Unity


def _axes_match(a: CoordinateSystem, b: CoordinateSystem) -> tuple[bool, bool, bool]:
    an, bn = int(a) - 1, int(b) - 1
    if an < 0 or bn < 0:
        return True, True, True
    return tuple(((an >> i) & 1) == ((bn >> i) & 1) for i in range(3))


def coordinate_flips(from_cs: CoordinateSystem, to_cs: CoordinateSystem):
    """Returns (flip_p[3], flip_q[3], flip_sh[15]) sign arrays (splat-types.h:55-80)."""
    xm, ym, zm = _axes_match(from_cs, to_cs)
    x, y, z = (1.0 if m else -1.0 for m in (xm, ym, zm))
    flip_p = np.array([x, y, z], np.float32)
    flip_q = np.array([y * z, x * z, x * y], np.float32)
    flip_sh = np.array(
        [y, z, x, x * y, y * z, 1.0, x * z, 1.0, y, x * y * z, y, z, x, z, x],
        np.float32,
    )
    return flip_p, flip_q, flip_sh


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SplatSet:
    """Raw (trainable) splat parameters, SoA. All arrays share leading dim N.

    Fields keep the PLY parameterization exactly (splat_set.h:33-47):
      means      (N, 3)  world positions
      scales     (N, 3)  log-space axis scales
      quats      (N, 4)  rotation quaternions (w, x, y, z), not necessarily unit
      opacities  (N,)    logit-space opacity
      sh_dc      (N, 3)  degree-0 SH (f_dc)
      sh_rest    (N, M, 3)  higher-degree SH, coefficient-major with RGB per
                 coefficient; M in {0, 3, 8, 15}
    """

    means: jax.Array
    scales: jax.Array
    quats: jax.Array
    opacities: jax.Array
    sh_dc: jax.Array
    sh_rest: jax.Array

    @property
    def num_splats(self) -> int:
        return self.means.shape[0]

    @property
    def max_sh_degree(self) -> int:
        """SH degree stored (splat_set.h:52-74)."""
        m = self.sh_rest.shape[1]
        if m >= 15:
            return 3
        if m >= 8:
            return 2
        if m >= 3:
            return 1
        return 0

    def convert_coordinates(self, from_cs: CoordinateSystem, to_cs: CoordinateSystem) -> "SplatSet":
        """Axis-flip conversion incl. quaternion & SH sign flips (splat_set.h:78-114)."""
        flip_p, flip_q, flip_sh = coordinate_flips(from_cs, to_cs)
        m = self.sh_rest.shape[1]
        quats = self.quats * jnp.concatenate([jnp.ones((1,), jnp.float32), jnp.asarray(flip_q)])
        return dataclasses.replace(
            self,
            means=self.means * flip_p,
            quats=quats,
            sh_rest=self.sh_rest * jnp.asarray(flip_sh[:m])[None, :, None],
        )

    def prepare(self, sh_format: ShFormat = ShFormat.FLOAT32) -> "PreparedSplats":
        return prepare_splats(self, sh_format)


def quat_to_rotmat(quats: jax.Array) -> jax.Array:
    """(N,4) (w,x,y,z) quaternions -> (N,3,3) rotation matrices. Normalizes first."""
    q = quats / jnp.linalg.norm(quats, axis=-1, keepdims=True).clip(1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        axis=-2,
    )


def covariance_from_scale_rot(scales_log: jax.Array, quats: jax.Array,
                              scale_multiplier: float | jax.Array = 1.0) -> jax.Array:
    """3D covariance Σ = R S Sᵀ Rᵀ packed as (N,6): xx,xy,xz,yy,yz,zz.

    Matches the reference upload-time precompute (splat_set_vk.cpp:265-288):
    scales exponentiate from log space, quaternion normalized.

    Column arithmetic, not an (N,3,3) einsum: the columns fuse into
    elementwise kernels with no (N,3,3) temporaries, and plain f32 FMA never
    runs in TF32.
    """
    s = jnp.exp(scales_log) * scale_multiplier          # (N,3)
    q = quats / jnp.linalg.norm(quats, axis=-1, keepdims=True).clip(1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    # rows of M = R @ diag(s): m[i][j] = R[i][j] * s[j]
    r = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    s0, s1, s2 = s[..., 0], s[..., 1], s[..., 2]
    m = [[r[i][0] * s0, r[i][1] * s1, r[i][2] * s2] for i in range(3)]

    def dot(i, j):
        return m[i][0] * m[j][0] + m[i][1] * m[j][1] + m[i][2] * m[j][2]

    return jnp.stack(
        [dot(0, 0), dot(0, 1), dot(0, 2), dot(1, 1), dot(1, 2), dot(2, 2)],
        axis=-1,
    )


def activate_color_opacity(sh_dc: jax.Array, opacities_logit: jax.Array) -> jax.Array:
    """(N,4) RGBA: SH0 folded to base color + sigmoid opacity (splat_set_vk.cpp:313-345)."""
    rgb = jnp.clip(0.5 + SH_C0 * sh_dc, 0.0, 1.0)
    a = jax.nn.sigmoid(opacities_logit).clip(0.0, 1.0)
    return jnp.concatenate([rgb, a[:, None]], axis=-1)


def quantize_sh(sh_rest: jax.Array, sh_format: ShFormat) -> jax.Array:
    """Quantize SH rest coefficients like storeSh (splat_set_vk.cpp:104-112).

    uint8 maps [-1, 1] onto [0, 255]; fp16 is a straight cast. Returned array
    keeps quantized *values* in its storage dtype; dequantization happens in
    :func:`dequantize_sh`.
    """
    if sh_format == ShFormat.FLOAT32:
        return sh_rest.astype(jnp.float32)
    if sh_format == ShFormat.FLOAT16:
        return sh_rest.astype(jnp.float16)
    if sh_format == ShFormat.UINT8:
        norm = (sh_rest.clip(-1.0, 1.0) + 1.0) * 0.5
        return jnp.round(norm * 255.0).astype(jnp.uint8)
    raise ValueError(f"unknown sh format {sh_format}")


def dequantize_sh(sh: jax.Array) -> jax.Array:
    if sh.dtype == jnp.uint8:
        return sh.astype(jnp.float32) / 255.0 * 2.0 - 1.0
    return sh.astype(jnp.float32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PreparedSplats:
    """Device-resident render form (the reference's VRAM layout, splat_set_vk.cpp:117-170).

      means   (N, 3) f32
      cov3d   (N, 6) f32 packed symmetric covariance (xx,xy,xz,yy,yz,zz)
      color   (N, 4) f32 activated base RGBA
      sh      (N, M, 3) in sh_format dtype (deg-major, RGB-interleaved)
      scales_log / quats retained for RT proxy sizing + size culling
    """

    means: jax.Array
    cov3d: jax.Array
    color: jax.Array
    sh: jax.Array
    scales_log: jax.Array
    quats: jax.Array

    @property
    def num_splats(self) -> int:
        return self.means.shape[0]

    @property
    def max_sh_degree(self) -> int:
        m = self.sh.shape[1]
        return 3 if m >= 15 else 2 if m >= 8 else 1 if m >= 3 else 0


def prepare_splats(splats: SplatSet, sh_format: ShFormat = ShFormat.FLOAT32,
                   scale_multiplier: float | jax.Array = 1.0) -> PreparedSplats:
    """The upload-time transform (SplatSetVk::initDataStorage, splat_set_vk.cpp:117-170)."""
    return PreparedSplats(
        means=splats.means.astype(jnp.float32),
        cov3d=covariance_from_scale_rot(splats.scales, splats.quats, scale_multiplier),
        color=activate_color_opacity(splats.sh_dc, splats.opacities),
        sh=quantize_sh(splats.sh_rest, sh_format),
        scales_log=splats.scales.astype(jnp.float32),
        quats=splats.quats.astype(jnp.float32),
    )


def random_splats(key: jax.Array, n: int, sh_degree: int = 3,
                  extent: float = 3.0, scale_range=(-5.0, -3.0)) -> SplatSet:
    """Synthetic splat set for tests and benchmarks."""
    m = {0: 0, 1: 3, 2: 8, 3: 15}[sh_degree]
    ks = jax.random.split(key, 6)
    return SplatSet(
        means=jax.random.uniform(ks[0], (n, 3), jnp.float32, -extent, extent),
        scales=jax.random.uniform(ks[1], (n, 3), jnp.float32, *scale_range),
        quats=jax.random.normal(ks[2], (n, 4), jnp.float32),
        opacities=jax.random.uniform(ks[3], (n,), jnp.float32, -2.0, 4.0),
        sh_dc=jax.random.normal(ks[4], (n, 3), jnp.float32) * 0.8,
        sh_rest=(jax.random.normal(ks[5], (n, m, 3), jnp.float32) * 0.1
                 if m else jnp.zeros((n, 0, 3), jnp.float32)),
    )
