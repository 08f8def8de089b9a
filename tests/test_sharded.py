"""Multi-device sharded render/training on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vk_gaussian_splatting_tpu.config import RenderConfig
from vk_gaussian_splatting_tpu.parallel import (
    make_mesh,
    render_3dgs_sharded,
    train_step_sharded,
)
from vk_gaussian_splatting_tpu.render.pipelines import render_3dgs
from vk_gaussian_splatting_tpu.scene.cameras import look_at
from vk_gaussian_splatting_tpu.scene.splat_set import random_splats


@pytest.fixture(scope="module")
def scene():
    # H=128 -> 8 tile rows, divisible by 8 devices; W=64 -> 4 tile cols
    cfg = RenderConfig(width=64, height=128, sh_degree=1)
    splats = random_splats(jax.random.key(0), 256, sh_degree=1,
                           scale_range=(-3.0, -1.0))
    cam = look_at([0, 0, -9], [0, 0, 0], [0, 1, 0], cfg.width, cfg.height)
    return cfg, splats, cam


def test_sharded_matches_single_device(scene):
    cfg, splats, cam = scene
    assert len(jax.devices()) >= 8
    mesh = make_mesh(8)
    img_sharded, trans, ov = render_3dgs_sharded(splats, cam, cfg, 8192, mesh)
    out = render_3dgs(splats.prepare(), cam, cfg, max_pairs=16384)
    np.testing.assert_allclose(np.asarray(img_sharded), np.asarray(out.image),
                               atol=3e-5, rtol=1e-4)
    assert float(out.transmittance.min()) < 0.9  # non-vacuous
    assert not bool(ov)


def test_sharded_train_step(scene):
    cfg, splats, cam = scene
    mesh = make_mesh(8)
    target = jnp.zeros((cfg.height, cfg.width, 3))
    s1, l1 = train_step_sharded(splats, cam, target, cfg, 8192, mesh, lr=1e-4)
    s2, l2 = train_step_sharded(s1, cam, target, cfg, 8192, mesh, lr=1e-4)
    assert float(l2) < float(l1)
    # gradient actually reached sharded params
    assert float(jnp.abs(s1.opacities - splats.opacities).sum()) > 0


def test_sharded_grads_match_single_device(scene):
    """Band-sharded backward == single-device backward."""
    cfg, splats, cam = scene
    bcfg = cfg
    mesh = make_mesh(8)
    target = jnp.zeros((cfg.height, cfg.width, 3))

    def loss_single(s):
        img = render_3dgs(s.prepare(), cam, bcfg).image
        return jnp.sum((img - target) ** 2)

    g_ref = jax.grad(loss_single)(splats)
    s1, _ = train_step_sharded(splats, cam, target, bcfg, 0, mesh, lr=1.0)
    g_sh = jax.tree.map(lambda a, b: a - b, splats, s1)  # lr=1.0 => grad
    for name in ("means", "opacities", "sh_dc"):
        a = np.asarray(getattr(g_ref, name))
        b = np.asarray(getattr(g_sh, name))
        scale = np.abs(a).max() + 1e-12
        np.testing.assert_allclose(b / scale, a / scale, atol=3e-5,
                                   err_msg=name)


def test_sharded_gut_matches_single_device(scene):
    from vk_gaussian_splatting_tpu.parallel import render_3dgut_sharded
    from vk_gaussian_splatting_tpu.render.pipelines import render_3dgut

    cfg, splats, cam = scene
    mesh = make_mesh(8)
    img_sh, _, _ = render_3dgut_sharded(splats, cam, cfg, max_pairs=1 << 14,
                                        mesh=mesh)
    ref = render_3dgut(splats.prepare(), cam, cfg, max_pairs=1 << 14)
    np.testing.assert_allclose(np.asarray(img_sh), np.asarray(ref.image),
                               atol=2e-3)


def test_sharded_grt_matches_single_device(scene):
    """Sharded 3DGRT primaries (radial blend order) vs the single-device
    pipeline."""
    from vk_gaussian_splatting_tpu.parallel import render_3dgrt_sharded
    from vk_gaussian_splatting_tpu.render.pipelines import render_3dgrt

    cfg, splats, cam = scene
    ref = render_3dgrt(splats.prepare(), cam, cfg, max_pairs=1 << 15)
    mesh = make_mesh(8)
    img, trans, _ = render_3dgrt_sharded(splats, cam, cfg, 1 << 15, mesh)
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref.image),
                               atol=3e-5)
    np.testing.assert_allclose(np.asarray(trans),
                               np.asarray(ref.transmittance), atol=3e-5)


def test_sharded_band_padding_non_divisible():
    """tiles_y (5) not divisible by the mesh (8): bands pad and the result
    crops back to the image height, matching single-device."""
    cfg = RenderConfig(width=64, height=80, sh_degree=1)
    splats = random_splats(jax.random.key(2), 200, sh_degree=1,
                           scale_range=(-3.0, -1.0))
    cam = look_at([0, 0, -9], [0, 0, 0], [0, 1, 0], cfg.width, cfg.height)
    ref = render_3dgs(splats.prepare(), cam, cfg, max_pairs=1 << 15)
    mesh = make_mesh(8)
    img, trans, _ = render_3dgs_sharded(splats, cam, cfg, 1 << 15, mesh)
    assert img.shape == (80, 64, 3)
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref.image),
                               atol=2e-5)


def test_sharded_train_step_non_divisible_height():
    """1080p-style heights: the bands overhang the image (5 tile rows over
    8 devices), so the step pads the target with empty rows."""
    cfg = RenderConfig(width=64, height=80, sh_degree=1)
    splats = random_splats(jax.random.key(3), 200, sh_degree=1,
                           scale_range=(-3.0, -1.0))
    cam = look_at([0, 0, -9], [0, 0, 0], [0, 1, 0], cfg.width, cfg.height)
    mesh = make_mesh(8)
    target = jnp.zeros((cfg.height, cfg.width, 3))
    s1, l1 = train_step_sharded(splats, cam, target, cfg, 0, mesh, lr=1e-4)
    _, l2 = train_step_sharded(s1, cam, target, cfg, 0, mesh, lr=1e-4)
    assert np.isfinite(float(l1)) and float(l2) < float(l1)
