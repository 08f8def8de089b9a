"""The two tile blenders: the Triton kernel (in the Pallas interpreter here)
against the XLA blender, the XLA blender against the naive oracles, edge
cases for both, the backend selector, and the compile-cache helper."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vk_gaussian_splatting_tpu.config import RenderConfig, StochasticMode
from vk_gaussian_splatting_tpu.io.obj import ObjMaterial, ObjMesh
from vk_gaussian_splatting_tpu.ops import rasterize_triton, rasterize_xla
from vk_gaussian_splatting_tpu.ops.projection import (
    project_splats,
    ut_project_splats,
)
from vk_gaussian_splatting_tpu.ops.rasterize_ref import rasterize_naive
from vk_gaussian_splatting_tpu.ops.tile_blend import (
    assemble_image,
    exact_prefix,
    hash_uniform,
    log_prefix,
    rasterize_bins,
    select_blender,
)
from vk_gaussian_splatting_tpu.render import pipelines as pl
from vk_gaussian_splatting_tpu.render.mesh_raster import (
    depth_limit_pix_ctx,
    mesh_bins,
    mesh_buffers_from_obj,
)
from vk_gaussian_splatting_tpu.render.rays import build_tile_rays
from vk_gaussian_splatting_tpu.render.shadows import ISO_LEVELS
from vk_gaussian_splatting_tpu.scene.cameras import look_at
from vk_gaussian_splatting_tpu.scene.splat_set import random_splats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 48, 32
KERNEL = rasterize_triton.blender(interpret=True)
XLA = rasterize_xla.rasterize_tiles
SEED = jnp.full((1,), 1, jnp.int32)


def _scene(n=80, seed=0, w=W, h=H, sh_degree=1, scale_range=(-2.6, -1.2)):
    cfg = RenderConfig(width=w, height=h, sh_degree=sh_degree)
    prep = random_splats(jax.random.key(seed), n, sh_degree=sh_degree,
                         extent=3.0, scale_range=scale_range).prepare()
    cam = look_at([0, 0, -10], [0, 0, 0], [0, 1, 0], w, h, fov_y_rad=0.9)
    return prep, cam, cfg


def _gs(prep, cam, cfg, packed=False, **st_kw):
    proj = project_splats(prep, cam, cfg)
    rows = (pl.gs_attr_rows_packed if packed else pl.gs_attr_rows)(proj)
    st = dataclasses.replace(pl.raster_statics(cfg), **st_kw)
    if packed:
        st = dataclasses.replace(st, model="gs2dp")
    return pl.bin_for_cfg(proj, rows, cfg, 0), None, st


def _gut(prep, cam, cfg, packed=False):
    proj = ut_project_splats(prep, cam, cfg)
    rows = (pl.gut_attr_rows_packed if packed else pl.gut_attr_rows)(
        prep, proj, cfg)
    st = pl._gut_statics(pl.raster_statics(cfg), cfg, packed)
    return pl.bin_for_cfg(proj, rows, cfg, 0), build_tile_rays(cam, cfg), st


def _mesh():
    pos = np.asarray([[-2, -2, 1], [2, -2, 1], [2, 2, 1], [-2, 2, 1],
                      [-1, -3, -0.5], [3, -1, 0.5], [1, 3, 0.5]], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3], [4, 5, 6]], np.int32)
    return mesh_buffers_from_obj(ObjMesh(
        positions=pos, normals=np.tile([0, 0, -1.0], (7, 1)).astype(
            np.float32),
        indices=idx, mat_indices=np.asarray([0, 0, 1], np.int32),
        materials=[ObjMaterial(diffuse=(1.0, 0.2, 0.2)),
                   ObjMaterial(diffuse=(0.2, 0.4, 1.0))]))


def _case(name):
    prep, cam, cfg = _scene()
    if name == "gs2d":
        return _gs(prep, cam, cfg)
    if name == "gs2dp":
        return _gs(prep, cam, cfg, packed=True)
    if name == "gs2d_clip":
        bins, _, st = _gs(prep, cam, cfg, model="gs2d_clip")
        xs = jnp.arange(W, dtype=jnp.float32)[None, :]
        limit = jnp.broadcast_to(9.0 + 2.0 * xs / W, (H, W))
        return bins, depth_limit_pix_ctx(limit, cfg), st
    if name == "gut3d":
        return _gut(prep, cam, cfg)
    if name == "gut3dp":
        return _gut(prep, cam, cfg, packed=True)
    if name in ("tri2d", "tri2d_smooth"):
        shading = "smooth" if name == "tri2d_smooth" else "flat"
        c = cfg.replace(raster=dataclasses.replace(cfg.raster,
                                                   mesh_shading=shading))
        bins, st = mesh_bins(_mesh(), cam, c, 0)
        return bins, None, st
    if name == "multi_iso":
        return _gs(prep, cam, cfg, multi_iso=True,
                   iso_thresholds=ISO_LEVELS)
    if name == "stochastic":
        return _gs(prep, cam, cfg.replace(stochastic=StochasticMode.SPLAT))
    raise ValueError(name)


def _blend(bins, pix, st, blender, attrs=None):
    if attrs is not None:
        bins = dataclasses.replace(bins, attrs=attrs)
    return rasterize_bins(bins, pix, SEED, st, blender=blender)


@pytest.mark.parametrize("name", [
    "gs2d", "gs2d_clip", "gs2dp", "gut3d", "gut3dp", "tri2d",
    "tri2d_smooth", "multi_iso", "stochastic"])
def test_kernel_matches_xla_blender(name):
    bins, pix, st = _case(name)
    ok = np.asarray(_blend(bins, pix, st, KERNEL))
    ox = np.asarray(_blend(bins, pix, st, XLA))
    assert ok.shape == ox.shape == (st.tiles_x * st.tiles_y, 8, 256)
    # transmittance products: exp(cumsum(log q)) in the kernel vs exact
    # cumprod (<= ~1e-5 relative); an opaque pair leaves 1e-30, not 0
    np.testing.assert_allclose(ok[:, :4], ox[:, :4], atol=2e-5)
    # aux picks (depths, ids) agree exactly
    np.testing.assert_allclose(ok[:, 4:], ox[:, 4:], atol=1e-5)
    assert float(ox[:, 3].min()) < 0.9  # something was blended


@pytest.mark.parametrize("name", ["gs2d", "gs2d_clip", "gut3d"])
def test_kernel_gradients_match_xla_blender(name):
    bins, pix, st = _case(name)
    g = jax.random.normal(jax.random.key(3), (st.tiles_x * st.tiles_y, 8,
                                              256)).at[:, 4:].set(0.0)

    def grad(blender):
        return jax.grad(lambda a: jnp.sum(
            _blend(bins, pix, st, blender, a) * g))(bins.attrs)

    gk, gx = np.asarray(grad(KERNEL)), np.asarray(grad(XLA))
    scale = np.abs(gx).max()
    assert scale > 0
    np.testing.assert_allclose(gk / scale, gx / scale, atol=2e-5)


@pytest.mark.parametrize("blender", ["xla", "kernel"])
def test_empty_scene(blender):
    """Every splat behind the camera: background, T = 1, no picks, zero
    gradients, and both ends write every tile."""
    prep, cam, cfg = _scene()
    cam = look_at([0, 0, 10], [0, 0, 20], [0, 1, 0], W, H, fov_y_rad=0.9)
    bins, pix, st = _gs(prep, cam, cfg)
    assert int(bins.num_pairs) == 0
    b = KERNEL if blender == "kernel" else XLA
    out = _blend(bins, pix, st, b)
    img, trans, depth, sid = assemble_image(out, st.tiles_x, st.tiles_y, W,
                                            H, with_aux=True)
    assert float(jnp.abs(img).max()) == 0.0
    assert float(trans.min()) == 1.0
    assert int(sid.max()) == -1 and float(depth.max()) == 0.0
    d = jax.grad(lambda a: jnp.sum(_blend(bins, pix, st, b, a)))(bins.attrs)
    assert float(jnp.abs(d).max()) == 0.0


def _iso_cov(n, var):
    """(n, 6) packed isotropic covariances (xx, xy, xz, yy, yz, zz)."""
    return jnp.broadcast_to(jnp.asarray([var, 0, 0, var, 0, var],
                                        jnp.float32), (n, 6))


def _stack(n_front=90):
    """A column of near-opaque splats stacked on one tile: its segment spans
    many chunks and its pixels go opaque within the first few."""
    prep, cam, cfg = _scene(n=n_front, sh_degree=0)
    k = jax.random.key(1)
    means = jnp.stack([jnp.zeros(n_front) - 0.05, jnp.zeros(n_front),
                       jnp.linspace(-2.0, 2.0, n_front)], axis=1)
    rgba = jnp.concatenate([jax.random.uniform(k, (n_front, 3)),
                            jnp.full((n_front, 1), 0.98)], axis=1)
    # sigma ~16 px at depth 10: every pixel of the 48x32 image is covered
    prep = dataclasses.replace(prep, means=means, cov3d=_iso_cov(
        n_front, 25.0), color=rgba)
    return prep, cam, cfg


@pytest.mark.parametrize("blender", ["xla", "kernel"])
def test_many_chunks_early_termination(blender):
    prep, cam, cfg = _stack()
    bins, pix, st = _gs(prep, cam, cfg)
    counts = np.asarray(bins.seg_counts)
    assert counts.max() > 4 * st.chunk          # several chunks per tile
    b = KERNEL if blender == "kernel" else XLA
    out = np.asarray(_blend(bins, pix, st, b))
    busy = counts > 4 * st.chunk
    # those tiles terminated: every pixel at or below min_transmittance
    assert (out[busy, 3].max(axis=1) <= st.min_transmittance).all()
    np.testing.assert_allclose(out, np.asarray(_blend(bins, pix, st, XLA)),
                               atol=2e-5)
    # pairs behind the opaque front get exactly zero gradient
    d = np.asarray(jax.grad(lambda a: jnp.sum(
        _blend(bins, pix, st, b, a)[:, :3]))(bins.attrs))
    t = int(np.argmax(counts))
    start = int(np.asarray(bins.seg_starts)[t])
    tail = d[:, start + 3 * st.chunk:start + counts[t]]
    assert tail.size and float(np.abs(tail).max()) == 0.0
    assert float(np.abs(d[:, start:start + st.chunk]).max()) > 0.0


@pytest.mark.parametrize("blender", ["xla", "kernel"])
def test_resolution_not_multiple_of_16(blender):
    prep, cam, cfg = _scene(w=37, h=29)
    bins, pix, st = _gs(prep, cam, cfg)
    assert (st.tiles_x, st.tiles_y) == (3, 2)
    out = _blend(bins, pix, st, KERNEL if blender == "kernel" else XLA)
    img, trans = assemble_image(out, st.tiles_x, st.tiles_y, 37, 29)
    assert img.shape == (29, 37, 3) and trans.shape == (29, 37)
    ref, t_ref = rasterize_naive(project_splats(prep, cam, cfg), 37, 29,
                                 cfg.raster)
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref), atol=1.5e-4)
    np.testing.assert_allclose(np.asarray(trans), np.asarray(t_ref),
                               atol=1.5e-4)


@pytest.mark.parametrize("blender", ["xla", "kernel"])
def test_single_pair_tiles(blender):
    """One small splat at the centre of each tile: every segment holds one
    pair, the chunk is mostly masked lanes."""
    cfg = RenderConfig(width=W, height=H, sh_degree=0)
    cam = look_at([0, 0, -10], [0, 0, 0], [0, 1, 0], W, H, fov_y_rad=0.9)
    # view-space points at the pixel centres of the six tiles, depth 10
    cx = (jnp.arange(6) % 3) * 16.0 + 8.0
    cy = (jnp.arange(6) // 3) * 16.0 + 8.0
    z = 10.0
    view = jnp.stack([(cx - cam.cx) / cam.fx * z, (cy - cam.cy) / cam.fy * z,
                      jnp.full((6,), z)], axis=1)
    rot, t = cam.viewmat[:3, :3], cam.viewmat[:3, 3]
    splats = random_splats(jax.random.key(4), 6, sh_degree=0)
    splats = dataclasses.replace(
        splats, means=(view - t) @ rot,          # view -> world
        scales=jnp.full((6, 3), -2.5), opacities=jnp.full((6,), 1.0))
    prep = splats.prepare()
    bins, pix, st = _gs(prep, cam, cfg)
    assert (np.asarray(bins.seg_counts) == 1).all()
    out = _blend(bins, pix, st, KERNEL if blender == "kernel" else XLA)
    img, trans, _, sid = assemble_image(out, st.tiles_x, st.tiles_y, W, H,
                                        with_aux=True)
    ref, t_ref = rasterize_naive(project_splats(prep, cam, cfg), W, H,
                                 cfg.raster)
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(np.asarray(trans), np.asarray(t_ref),
                               atol=1e-5)


def test_xla_blender_gradients_match_naive_autodiff():
    """The shared custom VJP (XLA end) against plain autodiff of the naive
    oracle, through projection and binning."""
    prep, cam, cfg = _scene(n=60)
    wimg = jax.random.normal(jax.random.key(2), (H, W, 3))

    def loss_blend(p):
        bins, pix, st = _gs(p, cam, cfg)
        img = assemble_image(_blend(bins, pix, st, XLA), st.tiles_x,
                             st.tiles_y, W, H)[0]
        return jnp.sum(img * wimg)

    def loss_naive(p):
        img, _ = rasterize_naive(project_splats(p, cam, cfg), W, H,
                                 cfg.raster)
        return jnp.sum(img * wimg)

    ga, gb = jax.grad(loss_blend)(prep), jax.grad(loss_naive)(prep)
    for name in ("means", "cov3d", "color"):
        a = np.asarray(getattr(ga, name))
        b = np.asarray(getattr(gb, name))
        scale = np.abs(b).max()
        assert scale > 0
        np.testing.assert_allclose(a / scale, b / scale, atol=5e-4,
                                   err_msg=name)


def test_prefix_products_agree():
    q = jax.random.uniform(jax.random.key(0), (256, 16), minval=0.001,
                           maxval=1.0)
    e1, i1 = exact_prefix(q)
    e2, i2 = log_prefix(q)
    np.testing.assert_allclose(np.asarray(e2), np.asarray(e1), rtol=2e-5)
    np.testing.assert_allclose(np.asarray(i2), np.asarray(i1), rtol=2e-5)
    np.testing.assert_allclose(np.asarray(e1[:, 0]), 1.0)
    # an opaque factor leaves the floor instead of an exact zero
    e3, i3 = log_prefix(q.at[:, 3].set(0.0))
    assert float(i3[:, 3:].max()) <= 1e-29 and np.isfinite(e3).all()


def test_hash_uniform_stream():
    """In [0, 1), decorrelated, and a function of (seed, pixel, pair
    position) only — so any chunk size draws the same samples."""
    pos = jnp.arange(64, dtype=jnp.int32)
    u = np.asarray(hash_uniform(jnp.int32(7), pos[None, :]))
    assert u.shape == (256, 64) and u.min() >= 0.0 and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 0.01
    halves = np.concatenate([
        np.asarray(hash_uniform(jnp.int32(7), pos[None, :32])),
        np.asarray(hash_uniform(jnp.int32(7), pos[None, 32:]))], axis=1)
    np.testing.assert_array_equal(u, halves)
    assert (np.asarray(hash_uniform(jnp.int32(8), pos[None, :])) != u).mean() \
        > 0.99


@pytest.mark.parametrize("backend,expected", [
    ("cpu", "xla"), ("gpu", "kernel"), ("rocm", None)])
def test_select_blender(backend, expected):
    if expected is None:
        with pytest.raises(ValueError):
            select_blender(backend)
        return
    want = (rasterize_triton.blender() if expected == "kernel" else XLA)
    assert select_blender(backend) is want
    if backend == "cpu":
        assert select_blender() is XLA  # the test backend


def test_compile_cache_default_dir():
    """Without the variable the cache goes to <repo>/.jax_cache (checked
    in a subprocess that compiles nothing, so this process and the
    repository stay untouched)."""
    code = (
        "import jax\n"
        "from vk_gaussian_splatting_tpu.utils.compile_cache import "
        "enable_compile_cache\n"
        "print(enable_compile_cache())\n"
        "print(jax.config.jax_compilation_cache_dir)\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    want = os.path.join(REPO, ".jax_cache")
    assert r.stdout.split() == [want, want]


def test_compile_cache_env_dir(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set the helper sets nothing and the
    compiled program lands in that directory."""
    code = (
        "import jax, jax.numpy as jnp\n"
        "from vk_gaussian_splatting_tpu.utils.compile_cache import "
        "enable_compile_cache\n"
        "print(enable_compile_cache())\n"
        "jax.jit(lambda x: jnp.sin(x) * 2)(jnp.ones(8)).block_until_ready()\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == str(tmp_path)
    assert any(tmp_path.iterdir()), "no compiled program in the cache dir"


def _run_smoke(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    r = _run_smoke(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    r = _run_smoke(str(alone), str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: the Triton kernel compiles only there")


@pytest.mark.gpu
def test_kernel_compiled_for_the_card(gpu):
    """Run by chip_smoke's path too; here as the one marked test of the
    compiled kernel (not the interpreter)."""
    bins, pix, st = _case("gs2d")
    ok = _blend(bins, pix, st, rasterize_triton.blender())
    np.testing.assert_allclose(np.asarray(ok),
                               np.asarray(_blend(bins, pix, st, XLA)),
                               atol=2e-5)
