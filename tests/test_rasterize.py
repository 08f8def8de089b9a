"""Tile rasterizer vs the naive per-pixel oracle — images and gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vk_gaussian_splatting_tpu.config import RenderConfig
from vk_gaussian_splatting_tpu.ops.projection import project_splats
from vk_gaussian_splatting_tpu.ops.rasterize_ref import rasterize_naive
from vk_gaussian_splatting_tpu.render.pipelines import render_3dgs
from vk_gaussian_splatting_tpu.scene.cameras import look_at
from vk_gaussian_splatting_tpu.scene.splat_set import random_splats


def make_scene(seed=0, n=400, w=96, h=64, sh_degree=1):
    cfg = RenderConfig(width=w, height=h, sh_degree=sh_degree)
    splats = random_splats(jax.random.key(seed), n, sh_degree=sh_degree,
                           extent=3.0, scale_range=(-3.0, -1.0))
    cam = look_at([0, 0, -10], [0, 0, 0], [0, 1, 0], w, h, fov_y_rad=0.9)
    return cfg, splats, cam


@pytest.mark.parametrize("seed,n", [(0, 400), (1, 1000), (2, 50)])
def test_pallas_matches_naive(seed, n):
    cfg, splats, cam = make_scene(seed=seed, n=n)
    prepared = splats.prepare()
    out = render_3dgs(prepared, cam, cfg, max_pairs=65536)
    assert not bool(out.overflow)

    proj = project_splats(prepared, cam, cfg)
    img_ref, t_ref = rasterize_naive(proj, cfg.width, cfg.height, cfg.raster)

    # atol 1.5e-4: the blender stops a tile once every pixel's T <=
    # min_transmittance (1e-4) at a chunk boundary, truncating residual
    # contributions bounded by min_transmittance; the naive reference blends
    # to the end
    img = np.asarray(out.image)
    np.testing.assert_allclose(img, np.asarray(img_ref), atol=1.5e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(
        np.asarray(out.transmittance), np.asarray(t_ref), atol=1.5e-4,
        rtol=1e-4
    )
    # scene must actually cover pixels for the test to mean anything
    assert float(t_ref.min()) < 0.9


def test_overflow_flag():
    import dataclasses as dc
    # slots mode: overflow = some splat's rect truncated by the slot budget
    cfg, splats, cam = make_scene(n=50)
    big = dc.replace(splats, scales=splats.scales + 2.0)  # huge splats
    cfg_small = cfg.replace(raster=dc.replace(cfg.raster, slots_k=4))
    out = render_3dgs(big.prepare(), cam, cfg_small, max_pairs=0)
    assert bool(out.overflow)
    # exact mode: overflow = pair budget exceeded
    cfg2, splats2, cam2 = make_scene(n=2000)
    cfg_exact = cfg2.replace(raster=dc.replace(cfg2.raster, expansion="exact"))
    out2 = render_3dgs(splats2.prepare(), cam2, cfg_exact, max_pairs=256)
    assert bool(out2.overflow)


def test_gradients_match_naive():
    cfg, splats, cam = make_scene(n=200, w=64, h=48)
    prepared = splats.prepare()

    key = jax.random.key(7)
    wimg = jax.random.normal(key, (cfg.height, cfg.width, 3))
    wt = jax.random.normal(jax.random.key(8), (cfg.height, cfg.width))

    def loss_pallas(pp):
        o = render_3dgs(pp, cam, cfg, max_pairs=65536)
        return jnp.sum(o.image * wimg) + jnp.sum(o.transmittance * wt)

    def loss_naive(pp):
        proj = project_splats(pp, cam, cfg)
        img, t = rasterize_naive(proj, cfg.width, cfg.height, cfg.raster)
        return jnp.sum(img * wimg) + jnp.sum(t * wt)

    g_p = jax.grad(loss_pallas)(prepared)
    g_n = jax.grad(loss_naive)(prepared)

    for name in ("means", "cov3d", "color", "sh"):
        a = np.asarray(getattr(g_p, name), np.float64)
        b = np.asarray(getattr(g_n, name), np.float64)
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=5e-4,
                                   err_msg=f"grad mismatch: {name}")
        assert np.abs(b).max() > 0, f"oracle grad for {name} is zero — vacuous test"


def test_gradients_finite_difference():
    cfg, splats, cam = make_scene(n=40, w=48, h=32)
    prepared = splats.prepare()

    def loss(means):
        import dataclasses
        pp = dataclasses.replace(prepared, means=means)
        o = render_3dgs(pp, cam, cfg, max_pairs=16384)
        return jnp.sum(o.image ** 2)

    g = np.asarray(jax.grad(loss)(prepared.means))
    # spot-check a few coordinates with central differences
    rng = np.random.RandomState(0)
    base = np.asarray(prepared.means)
    f = lambda m: float(loss(jnp.asarray(m)))
    checked = 0
    for _ in range(6):
        i, j = rng.randint(0, base.shape[0]), rng.randint(0, 3)
        # eps must sit above the f32 loss-rounding noise floor (smaller eps
        # makes the central difference dominated by sum-order rounding)
        eps = 4e-3
        mp, mm = base.copy(), base.copy()
        mp[i, j] += eps
        mm[i, j] -= eps
        fd = (f(mp) - f(mm)) / (2 * eps)
        if abs(fd) < 3e-3 and abs(g[i, j]) < 3e-3:
            continue  # below the f32 central-difference noise floor
        np.testing.assert_allclose(g[i, j], fd, rtol=5e-2, atol=2e-3)
        checked += 1
    assert checked >= 2


def test_packed_pair_format_matches_f32():
    """gs2dp packed rows (bf16/u16 pairs, exact xy) must stay visually
    indistinguishable from the f32 path (gate well above the reference's own
    52.8 dB conic-vs-eigen acceptance, doc/rasterization_of_3dgut.md:45)."""
    import dataclasses

    cfg = RenderConfig(width=160, height=120, sh_degree=2)
    splats = random_splats(jax.random.key(0), 2000, sh_degree=2).prepare()
    cam = look_at([0.4, -0.8, -7], [0, 0, 0], [0, 1, 0],
                  cfg.width, cfg.height)
    o1 = render_3dgs(splats, cam, cfg, max_pairs=1 << 18)
    cfgp = cfg.replace(raster=dataclasses.replace(cfg.raster,
                                                  pair_format="packed"))
    o2 = render_3dgs(splats, cam, cfgp, max_pairs=1 << 18)
    i1, i2 = np.asarray(o1.image), np.asarray(o2.image)
    mse = float(np.mean((i1 - i2) ** 2))
    psnr = 10 * np.log10(max(float(i1.max()), 1.0) ** 2 / max(mse, 1e-12))
    assert psnr > 55.0, psnr
    # id picks stay consistent except at quantization-flipped iso crossings
    assert (np.asarray(o1.splat_id) == np.asarray(o2.splat_id)).mean() > 0.99


def test_packed_pair_format_no_backward():
    import dataclasses

    cfg = RenderConfig(width=32, height=32, sh_degree=0)
    cfgp = cfg.replace(raster=dataclasses.replace(cfg.raster,
                                                  pair_format="packed"))
    splats = random_splats(jax.random.key(1), 100, sh_degree=0).prepare()
    cam = look_at([0, 0, -7], [0, 0, 0], [0, 1, 0], cfg.width, cfg.height)

    def loss(s):
        return jnp.sum(render_3dgs(s, cam, cfgp, max_pairs=1 << 14).image)

    with pytest.raises(NotImplementedError):
        jax.grad(loss)(splats)


def test_ladder_overflow_graceful():
    """More big splats than the mid-rank budget: overflow flags, image stays
    finite, and the largest splats keep their wide windows (rank ladder)."""
    import dataclasses

    n = 8192
    cfg = RenderConfig(width=256, height=128, sh_degree=0)
    splats = random_splats(jax.random.key(9), n, sh_degree=0,
                           scale_range=(-0.8, -0.3))  # all large on screen
    prepared = splats.prepare()
    cam = look_at([0, 0, -4], [0, 0, 0], [0, 1, 0], cfg.width, cfg.height)
    out = render_3dgs(prepared, cam, cfg)
    assert bool(out.overflow)            # budgets exceeded and reported
    img = np.asarray(out.image)
    assert np.isfinite(img).all()
    assert img.max() > 0.0
