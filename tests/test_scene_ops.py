"""Unit tests for scene core + device math ops against independent references."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vk_gaussian_splatting_tpu.config import RenderConfig, ShFormat
from vk_gaussian_splatting_tpu.ops.binning import bin_splats
from vk_gaussian_splatting_tpu.ops.projection import project_splats, unpack_cov3d
from vk_gaussian_splatting_tpu.ops.sh import eval_sh_radiance
from vk_gaussian_splatting_tpu.ops.sort import decode_minmax_f32, encode_minmax_f32
from vk_gaussian_splatting_tpu.scene.cameras import look_at, view_transform_points
from vk_gaussian_splatting_tpu.scene.splat_set import (
    CoordinateSystem,
    covariance_from_scale_rot,
    dequantize_sh,
    quantize_sh,
    quat_to_rotmat,
    random_splats,
)


def test_covariance_psd_and_reference():
    n = 50
    s = random_splats(jax.random.key(0), n, sh_degree=0)
    cov6 = covariance_from_scale_rot(s.scales, s.quats)
    cov = np.asarray(unpack_cov3d(cov6))
    # symmetric PSD with det = prod(exp(scale))^2
    np.testing.assert_allclose(cov, cov.transpose(0, 2, 1), atol=1e-6)
    evals = np.linalg.eigvalsh(cov)
    assert (evals > -1e-7).all()
    det_expected = np.exp(2 * np.asarray(s.scales).sum(axis=1))
    np.testing.assert_allclose(np.linalg.det(cov), det_expected, rtol=1e-4)
    # eigenvalues = exp(scale)^2 (sorted)
    np.testing.assert_allclose(
        np.sort(evals, axis=1), np.sort(np.exp(2 * np.asarray(s.scales)), axis=1),
        rtol=1e-4)


def test_quat_rotmat_orthonormal():
    q = jax.random.normal(jax.random.key(1), (20, 4))
    r = np.asarray(quat_to_rotmat(q))
    eye = np.einsum("nij,nkj->nik", r, r)
    np.testing.assert_allclose(eye, np.tile(np.eye(3), (20, 1, 1)), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(r), 1.0, atol=1e-5)


def test_coordinate_conversion_involution():
    s = random_splats(jax.random.key(2), 10, sh_degree=3)
    s2 = s.convert_coordinates(CoordinateSystem.RDF, CoordinateSystem.RUB)
    s3 = s2.convert_coordinates(CoordinateSystem.RUB, CoordinateSystem.RDF)
    for f in ("means", "quats", "sh_rest"):
        np.testing.assert_allclose(np.asarray(getattr(s3, f)),
                                   np.asarray(getattr(s, f)), atol=1e-6)
    # conversion preserves rendered geometry: covariance eigenvalues unchanged
    c1 = np.linalg.eigvalsh(np.asarray(unpack_cov3d(
        covariance_from_scale_rot(s.scales, s.quats))))
    c2 = np.linalg.eigvalsh(np.asarray(unpack_cov3d(
        covariance_from_scale_rot(s2.scales, s2.quats))))
    np.testing.assert_allclose(c1, c2, rtol=1e-4)


@pytest.mark.parametrize("fmt,atol", [(ShFormat.FLOAT32, 0),
                                      (ShFormat.FLOAT16, 1e-3),
                                      (ShFormat.UINT8, 1 / 127.0)])
def test_sh_quantization(fmt, atol):
    x = jax.random.uniform(jax.random.key(3), (40, 15, 3), minval=-0.99, maxval=0.99)
    q = quantize_sh(x, fmt)
    d = np.asarray(dequantize_sh(q))
    np.testing.assert_allclose(d, np.asarray(x), atol=max(atol, 1e-7))


def test_sh_matches_scalar_reference():
    """Evaluate SH against a literal transcription of the Slang polynomial
    (threedgs_particle_storage.h.slang:104-158)."""
    SH_C1 = 0.4886025119029199
    SH_C2 = [1.0925484, -1.0925484, 0.3153916, -1.0925484, 0.5462742]
    SH_C3 = [-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
             0.3731763325901154, -0.4570457994644658, 1.445305721320277,
             -0.5900435899266435]

    rng = np.random.RandomState(0)
    n = 16
    sh = rng.randn(n, 15, 3).astype(np.float32)
    dirs = rng.randn(n, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)

    expected = np.zeros((n, 3), np.float32)
    for i in range(n):
        x, y, z = dirs[i]
        shd1, shd2, shd3 = sh[i, 0:3], sh[i, 3:8], sh[i, 8:15]
        rgb = SH_C1 * (-shd1[0] * y + shd1[1] * z - shd1[2] * x)
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        rgb = rgb + (SH_C2[0] * xy) * shd2[0] + (SH_C2[1] * yz) * shd2[1] \
            + (SH_C2[2] * (2 * zz - xx - yy)) * shd2[2] + (SH_C2[3] * xz) * shd2[3] \
            + (SH_C2[4] * (xx - yy)) * shd2[4]
        rgb = rgb + SH_C3[0] * shd3[0] * (3 * xx - yy) * y + SH_C3[1] * shd3[1] * xy * z \
            + SH_C3[2] * shd3[2] * (4 * zz - xx - yy) * y \
            + SH_C3[3] * shd3[3] * z * (2 * zz - 3 * xx - 3 * yy) \
            + SH_C3[4] * shd3[4] * x * (4 * zz - xx - yy) \
            + SH_C3[5] * shd3[5] * (xx - yy) * z + SH_C3[6] * shd3[6] * x * (xx - 3 * yy)
        expected[i] = rgb

    got = np.asarray(eval_sh_radiance(jnp.asarray(sh), jnp.asarray(dirs), 3))
    np.testing.assert_allclose(got, expected, atol=1e-5)


def test_depth_key_encoding_order():
    vals = jnp.asarray([-100.0, -1.5, -0.0, 0.0, 1e-20, 3.0, 1e20], jnp.float32)
    keys = np.asarray(encode_minmax_f32(vals), np.uint32)
    assert (np.diff(keys.astype(np.uint64)) >= 0).all()
    dec = np.asarray(decode_minmax_f32(encode_minmax_f32(vals)))
    np.testing.assert_array_equal(dec, np.asarray(vals))


def test_ewa_projection_against_numpy():
    cfg = RenderConfig(width=128, height=96)
    splats = random_splats(jax.random.key(4), 64, sh_degree=0)
    prepared = splats.prepare()
    cam = look_at([0, 0, -8], [0, 0, 0], [0, 1, 0], cfg.width, cfg.height)
    proj = project_splats(prepared, cam, cfg)

    # independent dense-matrix reference
    vm = np.asarray(cam.viewmat, np.float64)
    means = np.asarray(prepared.means, np.float64)
    cov3 = np.asarray(unpack_cov3d(prepared.cov3d), np.float64)
    fx, fy = float(cam.fx), float(cam.fy)
    pv = means @ vm[:3, :3].T + vm[:3, 3]
    for i in range(0, 64, 7):
        x, y, z = pv[i]
        if z < 0.2:
            continue
        J = np.array([[fx / z, 0, -fx * x / z**2],
                      [0, fy / z, -fy * y / z**2]])
        T = J @ vm[:3, :3]
        c2 = T @ cov3[i] @ T.T
        c2[0, 0] += 0.3
        c2[1, 1] += 0.3
        conic = np.linalg.inv(c2)
        got = np.asarray(proj.conic)[i]
        np.testing.assert_allclose(
            got, [conic[0, 0], conic[0, 1], conic[1, 1]], rtol=1e-3, atol=1e-5)
        uv = np.asarray(proj.xy)[i]
        np.testing.assert_allclose(
            uv, [fx * x / z + float(cam.cx), fy * y / z + float(cam.cy)], rtol=1e-4)


def test_binning_pairs_against_numpy():
    from vk_gaussian_splatting_tpu.render.pipelines import gs_attr_rows

    cfg = RenderConfig(width=64, height=64)
    splats = random_splats(jax.random.key(5), 100, sh_degree=0,
                           scale_range=(-2.5, -1.0))
    prepared = splats.prepare()
    cam = look_at([0, 0, -8], [0, 0, 0], [0, 1, 0], cfg.width, cfg.height)
    proj = project_splats(prepared, cam, cfg)
    bins = bin_splats(proj, gs_attr_rows(proj), wide_id=True,
                      tile_size=16, tiles_x=4,
                      tiles_y=4, chunk=128, slots_k=16)
    assert not bool(bins.overflow)

    # numpy reference pair set
    xy = np.asarray(proj.xy)
    r = np.asarray(proj.radius)
    valid = np.asarray(proj.valid)
    expected = set()
    for i in range(100):
        if not valid[i] or r[i].max() <= 0:
            continue
        x0 = max(0, int(np.floor((xy[i, 0] - r[i, 0]) / 16)))
        y0 = max(0, int(np.floor((xy[i, 1] - r[i, 1]) / 16)))
        x1 = min(3, int(np.floor((xy[i, 0] + r[i, 0]) / 16)))
        y1 = min(3, int(np.floor((xy[i, 1] + r[i, 1]) / 16)))
        for ty in range(y0, y1 + 1):
            for tx in range(x0, x1 + 1):
                expected.add((ty * 4 + tx, i))

    got = set()
    ps = np.asarray(bins.pair_splat)
    starts = np.asarray(bins.seg_starts)
    counts = np.asarray(bins.seg_counts)
    for t in range(16):
        for p_ in range(starts[t], starts[t] + counts[t]):
            got.add((t, int(ps[p_])))
    assert got == expected
    assert int(bins.num_pairs) == len(expected)

    # per-tile depth ordering
    depth = np.asarray(proj.depth)
    for t in range(16):
        seg = ps[starts[t]:starts[t] + counts[t]]
        d = depth[seg]
        assert (np.diff(d) >= -1e-6).all()

    # attrs rows carry the right values in sorted pair order (spot check)
    attrs = np.asarray(bins.attrs)
    for t in (0, 5, 15):
        for p_ in range(starts[t], min(starts[t] + counts[t],
                                       starts[t] + 5)):
            i = int(ps[p_])
            np.testing.assert_allclose(attrs[0, p_], xy[i, 0], rtol=1e-6)
            np.testing.assert_allclose(attrs[9, p_], depth[i], rtol=1e-6)

    # segments tile the live pairs contiguously, and at least one chunk of
    # padding follows the last one (the blenders load whole chunks)
    assert starts[0] == 0
    assert (starts[1:] == starts[:-1] + counts[:-1]).all()
    end = starts[-1] + counts[-1]
    assert end == int(bins.num_pairs)
    assert bins.attrs.shape[1] - end >= 128


def test_sh_band_rotation_exact():
    """rotate_sh_rest(c, R) evaluated at d == original evaluated at R^-1 d."""
    import numpy as np

    from vk_gaussian_splatting_tpu.ops.sh import (
        eval_sh_radiance,
        rotate_sh_rest,
    )

    rng = np.random.default_rng(0)
    sh = jnp.asarray(rng.normal(size=(32, 15, 3)).astype(np.float32))
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    r = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                  [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                  [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    sh_rot = rotate_sh_rest(sh, r)
    d = rng.normal(size=(32, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d.astype(np.float32))
    lhs = eval_sh_radiance(sh_rot, d, 3)
    rhs = eval_sh_radiance(sh, d @ jnp.asarray(r, jnp.float32), 3)
    np.testing.assert_allclose(np.asarray(lhs), np.asarray(rhs), atol=5e-6)
