"""EXTERNAL correctness oracle (VERDICT r4 missing #5 / next #6).

Every other oracle in this repo shares math with the library (rasterize_ref,
the two tile blenders, the golden corpus trained by this same code). This file
breaks that loop: ``emulate_render`` below is a literal float64 NumPy
transcription of the reference's ACTUAL shader code paths —

  - color/opacity activation        splat_set_vk.cpp:313-345
  - covariance from (scale, quat)   splat_set_vk.cpp:265-288
  - EWA covariance projection       threedgs.h.slang:26-56
  - dilation + eigen extent basis   threedgs.h.slang:60-121
  - SH radiance                     threedgs_particle_storage.h.slang:48-159
  - per-fragment response + blend   threedgs_raster.frag.slang:236-309

and deliberately shares NO code with vk_gaussian_splatting_tpu.ops: the
emulator renders through the reference's eigen-BASIS formulation (fragPos =
sqrt8 * B^-1 (pixel - center), A = |fragPos|^2), while the library renders
through the INRIA CONIC formulation (A = d' Sigma^-1 d). The two agree only
if our projection/SH/blend math matches the reference's shader math — a
divergence in either formulation, the SH polynomial signs, the activation,
or the FTB ordering fails the test.

Scene constraint: splats are built anisotropic enough that the reference's
eigenvalue floor ``sqrt(max(0.1, ...))`` (threedgs.h.slang:100) never
engages (the floor genuinely distorts near-isotropic splats in the
reference; the conic path has no such floor). The test asserts this
precondition on every visible splat.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vk_gaussian_splatting_tpu.config import RenderConfig
from vk_gaussian_splatting_tpu.render.pipelines import render_3dgs
from vk_gaussian_splatting_tpu.scene.cameras import look_at
from vk_gaussian_splatting_tpu.scene.splat_set import SplatSet

# ---------------------------------------------------------------------------
# the emulator — standalone NumPy, float64, scalar-per-splat loops
# ---------------------------------------------------------------------------

SH_C0 = 0.28209479177387814          # splat_set_vk.cpp:318
SH_C1 = 0.4886025119029199           # threedgs_particle_storage.h.slang:49
SH_C2 = [1.0925484, -1.0925484, 0.3153916, -1.0925484, 0.5462742]
SH_C3 = [-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435]
SQRT8 = np.sqrt(8.0)


def _quat_rotmat(q):
    """glm::mat3_cast of a normalized (w, x, y, z) quaternion."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _sh_radiance(coefs, degree, d):
    """fetchViewDependentRadiance (threedgs_particle_storage.h.slang:105-159).

    coefs: (15, 3) sh_rest rows; d: unit view direction (splat - camera)."""
    x, y, z = d
    rgb = np.zeros(3)
    if degree >= 1:
        rgb += SH_C1 * (-coefs[0] * y + coefs[1] * z - coefs[2] * x)
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        rgb += (SH_C2[0] * xy * coefs[3] + SH_C2[1] * yz * coefs[4]
                + SH_C2[2] * (2.0 * zz - xx - yy) * coefs[5]
                + SH_C2[3] * xz * coefs[6] + SH_C2[4] * (xx - yy) * coefs[7])
    if degree >= 3:
        rgb += (SH_C3[0] * coefs[8] * (3.0 * x * x - y * y) * y
                + SH_C3[1] * coefs[9] * x * y * z
                + SH_C3[2] * coefs[10] * (4.0 * z * z - x * x - y * y) * y
                + SH_C3[3] * coefs[11] * z
                * (2.0 * z * z - 3.0 * x * x - 3.0 * y * y)
                + SH_C3[4] * coefs[12] * x * (4.0 * z * z - x * x - y * y)
                + SH_C3[5] * coefs[13] * (x * x - y * y) * z
                + SH_C3[6] * coefs[14] * x * (x * x - 3.0 * y * y))
    return rgb


def emulate_render(splats, viewmat, fx, fy, cx, cy, width, height,
                   sh_degree, min_eigen_gap=0.5):
    """Reference-shader emulation: returns (H, W, 3) image, (H, W) T.

    Per splat: activation -> covariance -> view transform -> EWA projection
    -> dilation + eigen basis; per pixel: fragPos via the basis inverse,
    A-discard, exp response, 1/255 discard, FTB under-blend in view-depth
    order. All float64."""
    n = splats.means.shape[0]
    means = np.asarray(splats.means, np.float64)
    scales = np.exp(np.asarray(splats.scales, np.float64))
    quats = np.asarray(splats.quats, np.float64)
    f_dc = np.asarray(splats.sh_dc, np.float64)
    sh_rest = np.asarray(splats.sh_rest, np.float64)
    opa = 1.0 / (1.0 + np.exp(-np.asarray(splats.opacities, np.float64)))
    vm = np.asarray(viewmat, np.float64)
    cam_pos = -vm[:3, :3].T @ vm[:3, 3]

    prims = []  # (depth, center_px, Binv, color, alpha)
    for i in range(n):
        # covariance precompute (splat_set_vk.cpp:270-288): M = R*S, Sigma = M M^T
        m = _quat_rotmat(quats[i]) @ np.diag(scales[i])
        cov3d = m @ m.T
        p_view = vm[:3, :3] @ means[i] + vm[:3, 3]
        z = p_view[2]
        if z <= 1e-4:
            continue
        # EWA projection (threedgs.h.slang:26-56): J rows (fx/z, 0, -fx x/z^2)
        j = np.array([[fx / z, 0.0, -fx * p_view[0] / (z * z)],
                      [0.0, fy / z, -fy * p_view[1] / (z * z)],
                      [0.0, 0.0, 0.0]])
        t = j @ vm[:3, :3]
        cov2d = t @ cov3d @ t.T
        a, b, d = cov2d[0, 0] + 0.3, cov2d[0, 1], cov2d[1, 1] + 0.3
        det = a * d - b * b
        trace_over2 = 0.5 * (a + d)
        gap = trace_over2 * trace_over2 - det
        ev1 = trace_over2 + np.sqrt(max(0.1, gap))
        ev2 = trace_over2 - np.sqrt(max(0.1, gap))
        if ev2 <= 0.0:
            continue
        assert gap > min_eigen_gap, (
            f"splat {i}: eigen gap {gap:.3f} under the reference floor "
            "(pre-filter the scene with projected_eigen_gaps)")
        evec1 = np.array([1.0 if abs(b) < 0.001 else b, ev1 - a])
        evec1 /= np.linalg.norm(evec1)
        evec2 = np.array([evec1[1], -evec1[0]])
        basis = np.stack([evec1 * min(SQRT8 * np.sqrt(ev1), 2048.0),
                          evec2 * min(SQRT8 * np.sqrt(ev2), 2048.0)], axis=1)
        center = np.array([fx * p_view[0] / z + cx, fy * p_view[1] / z + cy])
        view_dir = means[i] - cam_pos
        view_dir /= np.linalg.norm(view_dir)
        color = np.clip(0.5 + SH_C0 * f_dc[i], 0.0, 1.0)
        color = color + _sh_radiance(sh_rest[i], sh_degree, view_dir)
        color = np.clip(color, 0.0, None)
        prims.append((z, center, np.linalg.inv(basis), color, opa[i]))

    prims.sort(key=lambda p: p[0])  # FTB view-depth order
    img = np.zeros((height, width, 3))
    trans = np.ones((height, width))
    for _z, center, binv, color, alpha in prims:
        ys, xs = np.mgrid[0:height, 0:width]
        dpix = np.stack([xs + 0.5 - center[0], ys + 0.5 - center[1]], -1)
        frag = dpix @ binv.T * SQRT8          # fragPos (frag.slang:228-236)
        a_sq = np.sum(frag * frag, axis=-1)
        op = np.exp(-0.5 * a_sq) * alpha      # frag.slang:255
        op = np.where((a_sq > 8.0) | (op <= 1.0 / 255.0), 0.0, op)
        op = np.minimum(op, 0.999)
        img += trans[..., None] * op[..., None] * color  # FTB under blend
        trans *= 1.0 - op
    return img, trans


def projected_eigen_gaps(splats, viewmat, fx, fy):
    """Per-splat (traceOver2^2 - D) of the dilated projected covariance —
    the quantity the reference floors at 0.1 (threedgs.h.slang:100). Same
    standalone math as emulate_render; used to pre-filter test scenes so
    the floor (which distorts the basis formulation) never engages."""
    vm = np.asarray(viewmat, np.float64)
    means = np.asarray(splats.means, np.float64)
    scales = np.exp(np.asarray(splats.scales, np.float64))
    quats = np.asarray(splats.quats, np.float64)
    gaps = np.full(means.shape[0], np.inf)
    for i in range(means.shape[0]):
        m = _quat_rotmat(quats[i]) @ np.diag(scales[i])
        p_view = vm[:3, :3] @ means[i] + vm[:3, 3]
        z = p_view[2]
        if z <= 1e-4:
            continue
        j = np.array([[fx / z, 0.0, -fx * p_view[0] / (z * z)],
                      [0.0, fy / z, -fy * p_view[1] / (z * z)],
                      [0.0, 0.0, 0.0]])
        t = j @ vm[:3, :3]
        cov2d = t @ (m @ m.T) @ t.T
        a, b, d = cov2d[0, 0] + 0.3, cov2d[0, 1], cov2d[1, 1] + 0.3
        gaps[i] = (0.5 * (a + d)) ** 2 - (a * d - b * b)
    return gaps


# ---------------------------------------------------------------------------
# the test scene: anisotropic, on-screen, in front of the camera
# ---------------------------------------------------------------------------

def _oracle_scene(n=120, seed=3):
    rng = np.random.default_rng(seed)
    means = rng.uniform([-1.6, -1.6, -0.8], [1.6, 1.6, 0.8],
                        (n, 3)).astype(np.float32)
    # elongated: one axis 3-5x the others so the projected eigen gap
    # clears the reference's 0.1 floor at almost every orientation
    base = rng.uniform(np.log(0.06), np.log(0.12), (n, 1))
    ratio = rng.uniform(np.log(3.0), np.log(5.0), (n, 1))
    which = rng.integers(0, 3, n)
    scales = np.repeat(base, 3, axis=1)
    scales[np.arange(n), which] += ratio[:, 0]
    quats = rng.normal(size=(n, 4))
    opac = rng.uniform(-1.0, 2.5, n)
    sh_dc = rng.uniform(-1.2, 1.2, (n, 3))
    sh_rest = rng.uniform(-0.12, 0.12, (n, 15, 3))
    return SplatSet(
        means=jnp.asarray(means), scales=jnp.asarray(scales, jnp.float32),
        quats=jnp.asarray(quats, jnp.float32),
        opacities=jnp.asarray(opac, jnp.float32),
        sh_dc=jnp.asarray(sh_dc, jnp.float32),
        sh_rest=jnp.asarray(sh_rest, jnp.float32))


@pytest.mark.parametrize("method", ["pairs"])
def test_render_matches_reference_shader_emulation(method):
    w = h = 64
    cfg = RenderConfig(width=w, height=h, sh_degree=3)
    splats = _oracle_scene()
    cam = look_at([0.1, -0.2, -4.0], [0, 0, 0], [0, 1, 0], w, h,
                  fov_y_rad=0.9)
    # drop splats whose projection lands near the reference's eigen floor
    # (the basis formulation distorts them; the conic one does not)
    keep = projected_eigen_gaps(splats, cam.viewmat, float(cam.fx),
                                float(cam.fy)) > 1.0
    assert keep.sum() > 100  # the filter must stay a rare-case trim
    splats = jax.tree.map(lambda x: x[np.where(keep)[0]], splats)
    out = render_3dgs(splats.prepare(), cam, cfg, max_pairs=1 << 15)
    assert not bool(out.overflow)
    img = np.asarray(out.image, np.float64)
    trans = np.asarray(out.transmittance, np.float64)

    ref_img, ref_trans = emulate_render(
        splats, cam.viewmat, float(cam.fx), float(cam.fy), float(cam.cx),
        float(cam.cy), w, h, sh_degree=3)

    # f32 pipeline vs f64 emulator: roundoff accumulates over ~100 blended
    # splats; the blender's stop once a tile is opaque (T<1e-4) truncates
    # contributions bounded by 1e-4. Anything structural (SH signs, eigen/conic mismatch,
    # blend order) produces errors orders of magnitude above this bar.
    assert np.max(np.abs(img - ref_img)) < 2e-3, np.max(np.abs(img - ref_img))
    assert np.mean(np.abs(img - ref_img)) < 1e-4
    assert np.max(np.abs(trans - ref_trans)) < 2e-3
    mse = np.mean((img - ref_img) ** 2)
    psnr = 10 * np.log10(max(ref_img.max(), 1.0) ** 2 / max(mse, 1e-20))
    assert psnr > 60.0, psnr


def test_emulator_is_independent():
    """The oracle must not silently start importing library math."""
    import ast
    import inspect
    import sys

    src = inspect.getsource(sys.modules[__name__])
    tree = ast.parse(src)
    lib_imports = [
        n.module for n in ast.walk(tree)
        if isinstance(n, ast.ImportFrom) and n.module
        and n.module.startswith("vk_gaussian_splatting_tpu.ops")]
    assert lib_imports == [], lib_imports
