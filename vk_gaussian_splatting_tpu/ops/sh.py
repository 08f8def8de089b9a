"""Spherical-harmonics radiance evaluation.

Matches the reference polynomial and sign conventions exactly
(shaders/threedgs_particle_storage.h.slang:48-159, fetchViewDependentRadiance):
degree-0 is folded into the base color at prepare time (splat_set.py), so this
module only evaluates degrees 1..3 as an additive radiance term. The view
direction is normalize(splat_center - camera_position) in model space
(threedgs_raster.mesh.slang:238-243).

Fully vectorized jnp — XLA fuses this into the projection pass; differentiable
w.r.t. both coefficients and direction.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484, -1.0925484, 0.3153916, -1.0925484, 0.5462742)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def sh_basis(dirs: jax.Array, degree: int) -> jax.Array:
    """Basis values for degrees 1..degree. dirs (...,3) unit vectors -> (...,M)
    where M = {1:3, 2:8, 3:15}[degree]. Coefficient order matches the prepared
    SH layout (deg-major: 3 deg-1, 5 deg-2, 7 deg-3)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    cols = []
    if degree >= 1:
        cols += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        cols += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if degree >= 3:
        xx, yy, zz = x * x, y * y, z * z
        cols += [
            SH_C3[0] * (3.0 * xx - yy) * y,
            SH_C3[1] * x * y * z,
            SH_C3[2] * (4.0 * zz - xx - yy) * y,
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * (xx - yy) * z,
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    if not cols:
        return jnp.zeros(dirs.shape[:-1] + (0,), dirs.dtype)
    return jnp.stack(cols, axis=-1)


def _band_slices(stored_m: int):
    """[(start, count, degree)] band blocks present in an (N, M, 3) layout."""
    out = []
    if stored_m >= 3:
        out.append((0, 3, 1))
    if stored_m >= 8:
        out.append((3, 5, 2))
    if stored_m >= 15:
        out.append((8, 7, 3))
    return out


def band_rotation(rotmat, degree: int):
    """(2l+1, 2l+1) rotation of band-l coefficients for a world rotation R.

    Sampling construction (basis-order agnostic, exact up to fp): pick 2l+1
    generic unit directions d_i; with A[i,j] = Y_j(d_i) and
    At[i,j] = Y_j(R^-1 d_i), the rotated function f'(d) = f(R^-1 d)
    satisfies A c' = At c, so M = A^-1 At. A band rotated this way renders
    identically to evaluating the original coefficients at inverse-rotated
    view directions — the exact SH rotation rotated instances need."""
    import numpy as np

    n = 2 * degree + 1
    rng = np.random.default_rng(degree * 7919 + 11)
    d = rng.normal(size=(4 * n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = np.asarray(rotmat, np.float64)
    lo, cnt, _ = {1: (0, 3, 1), 2: (3, 5, 2), 3: (8, 7, 3)}[degree]
    basis_all = np.asarray(sh_basis(jnp.asarray(d), degree), np.float64)
    a = basis_all[:, lo:lo + cnt]
    basis_rot = np.asarray(sh_basis(jnp.asarray(d @ r), degree), np.float64)
    at = basis_rot[:, lo:lo + cnt]
    # least squares over 4n samples keeps it robust to unlucky direction sets
    m, *_ = np.linalg.lstsq(a, at, rcond=None)
    return m


def rotate_sh_rest(sh_rest: jax.Array, rotmat) -> jax.Array:
    """(N, M, 3) model-space SH coefficients -> world space under the
    instance rotation R (model->world): block-diagonal per-band rotation."""
    stored_m = sh_rest.shape[1]
    parts = []
    for lo, cnt, deg in _band_slices(stored_m):
        m = jnp.asarray(band_rotation(rotmat, deg), jnp.float32)
        # HIGHEST: full f32 (a default f32 product may run in TF32 on GPUs)
        parts.append(jnp.einsum("km,nmc->nkc", m,
                                sh_rest[:, lo:lo + cnt, :].astype(jnp.float32),
                                precision=jax.lax.Precision.HIGHEST))
    if not parts:
        return sh_rest
    return jnp.concatenate(parts, axis=1)


def eval_sh_radiance(sh_rest: jax.Array, dirs: jax.Array, degree: int) -> jax.Array:
    """Additive view-dependent radiance.

    sh_rest: (N, M, 3) float coefficients (already dequantized).
    dirs:    (N, 3) unit view directions.
    degree:  requested degree, clamped to what sh_rest stores.
    Returns (N, 3) rgb to add to the base color.
    """
    stored_m = sh_rest.shape[1]
    stored_degree = 3 if stored_m >= 15 else 2 if stored_m >= 8 else 1 if stored_m >= 3 else 0
    degree = min(degree, stored_degree)
    if degree < 1:
        return jnp.zeros(sh_rest.shape[:1] + (3,), jnp.float32)
    m = {1: 3, 2: 8, 3: 15}[degree]
    basis = sh_basis(dirs, degree)  # (N, m)
    # HIGHEST: full f32 (a default f32 product may run in TF32 on GPUs)
    return jnp.einsum("nm,nmc->nc", basis,
                      sh_rest[:, :m, :].astype(jnp.float32),
                      precision=jax.lax.Precision.HIGHEST)
