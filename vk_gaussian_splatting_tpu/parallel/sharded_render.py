"""Multi-chip sharding policies (SURVEY.md §2.4, §5 "long-context" analogs).

The reference is a single-GPU app; its scale escape hatches (sparse
LargeBuffers for >4 GB attributes, multi-TLAS chunking past 16.7M instances —
splat_set_vk.h:175, splat_set_manager_vk.cpp:1060) become sharded arrays over
a ``jax.sharding.Mesh`` here:

- **splat sharding** (data axis): each device stores and projects N/D splats —
  the LargeBuffer replacement; attribute memory scales with devices.
- **tile sharding** (output axis): each device rasterizes a horizontal band of
  tile rows; the compact projected attributes (~15 f32/splat, far smaller than
  raw parameters) ride one ``all_gather`` across the mesh (NCCL over NVLink
  on a multi-GPU host) — the boundary-splat gather of BASELINE.json.
- gradients: the all_gather transposes to ``psum_scatter`` automatically under
  ``jax.grad``, so per-splat parameter gradients land sharded exactly like the
  parameters (no replicated-gradient all-reduce needed — splat params are
  per-splat); the scalar loss is ``psum``-reduced.

Everything is expressed with ``shard_map`` so the collective schedule is
explicit and XLA overlaps the gather with projection compute.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from vk_gaussian_splatting_tpu.config import RenderConfig, tiles_y
from vk_gaussian_splatting_tpu.ops.projection import ProjectedSplats, project_splats
from vk_gaussian_splatting_tpu.ops.tile_blend import (
    assemble_image,
    rasterize_bins,
)
from vk_gaussian_splatting_tpu.render.pipelines import (
    bin_for_cfg,
    gs_attr_rows,
    raster_statics,
)
from vk_gaussian_splatting_tpu.scene.cameras import Camera
from vk_gaussian_splatting_tpu.scene.splat_set import SplatSet, prepare_splats


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def _band_rows(cfg: RenderConfig, n_bands: int) -> int:
    """Tile rows per band, padded up: when tiles_y does not divide the mesh
    size, the last band renders rows past the image (empty — the shifted
    projection leaves them uncovered) and the caller crops to height."""
    return -(-tiles_y(cfg) // n_bands)


def _band_raster(shifted: ProjectedSplats, rows, local_cfg: RenderConfig,
                 st, max_pairs: int, pix_ctx=None, depth_override=None):
    """Blend one band (an ordinary short image). Returns
    (img, trans, overflow)."""
    h_local = st.tiles_y * local_cfg.raster.tile_size
    bins = bin_for_cfg(shifted, rows, local_cfg, max_pairs, depth_override)
    out = rasterize_bins(bins, pix_ctx, None, st)
    img, trans = assemble_image(out, st.tiles_x, st.tiles_y,
                                local_cfg.width, h_local,
                                local_cfg.background)
    return img, trans, bins.overflow


def _render_band(proj: ProjectedSplats, cfg: RenderConfig, max_pairs: int,
                 band: int, n_bands: int):
    """Rasterize one horizontal band of tile rows against full projected splats."""
    ty_local = _band_rows(cfg, n_bands)
    y_off = (jnp.asarray(band, jnp.float32)
             * (ty_local * cfg.raster.tile_size))

    shifted = dataclasses.replace(
        proj, xy=proj.xy - jnp.stack([jnp.zeros((), jnp.float32), y_off]))
    local_cfg = cfg.replace(height=ty_local * cfg.raster.tile_size)
    st = dataclasses.replace(raster_statics(cfg), tiles_y=ty_local)
    return _band_raster(shifted, gs_attr_rows(shifted), local_cfg, st,
                        max_pairs)


def _gather_proj(proj: ProjectedSplats, axis: str) -> ProjectedSplats:
    g = lambda x: jax.lax.all_gather(x, axis, axis=0, tiled=True)
    return jax.tree.map(g, proj)


@partial(jax.jit, static_argnames=("cfg", "max_pairs", "mesh"))
def render_3dgs_sharded(splats: SplatSet, cam: Camera, cfg: RenderConfig,
                        max_pairs: int, mesh: Mesh):
    """Forward render with splats sharded over the mesh and the image sharded
    over horizontal bands. Returns (image, transmittance, overflow): the
    band-sharded (H, W, 3) image plus the OR of all bands' coverage-overflow
    flags."""
    axis = mesh.axis_names[0]
    nd = mesh.shape[axis]

    def shard_fn(splats_local: SplatSet, cam: Camera):
        prepared = prepare_splats(splats_local, cfg.sh_format)
        proj = project_splats(prepared, cam, cfg)
        proj = _gather_proj(proj, axis)
        band = jax.lax.axis_index(axis)
        img, trans, ov = _render_band(proj, cfg, max_pairs, band, nd)
        return img, trans, jax.lax.psum(ov.astype(jnp.int32), axis) > 0

    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(axis), P()),
        out_specs=(P(axis), P(axis), P()),
        check_vma=False,  # pallas_call outputs carry no vma info
    )
    img, trans, overflow = fn(splats, cam)
    # crop band padding (last band may extend past the image)
    return img[:cfg.height], trans[:cfg.height], overflow


@partial(jax.jit, static_argnames=("cfg", "max_pairs", "mesh"))
def render_3dgut_sharded(splats: SplatSet, cam: Camera, cfg: RenderConfig,
                         max_pairs: int, mesh: Mesh):
    """3DGUT forward with splat-sharded UT projection and band-sharded
    exact-ray rasterization. Each band blends with rays regenerated for its
    sub-viewport (cy shifted — the pixel context never crosses bands).
    Global shutter only (rolling shutter needs global scan coordinates)."""
    from vk_gaussian_splatting_tpu.ops.projection import ut_project_splats
    from vk_gaussian_splatting_tpu.render.pipelines import (
        _gut_statics,
        gut_attr_rows,
    )
    from vk_gaussian_splatting_tpu.render.rays import build_tile_rays

    axis = mesh.axis_names[0]
    nd = mesh.shape[axis]
    ty_local = _band_rows(cfg, nd)
    h_local = ty_local * cfg.raster.tile_size

    def shard_fn(splats_local: SplatSet, cam: Camera):
        prepared = prepare_splats(splats_local, cfg.sh_format)
        proj = ut_project_splats(prepared, cam, cfg)
        rows = gut_attr_rows(prepared, proj, cfg)
        band = jax.lax.axis_index(axis)
        # the id row (last) is a local arange: offset by the shard base so
        # ids stay globally unique after the gather (splat_id picks)
        n_local = rows.shape[1]
        rows = rows.at[-1].add(jnp.float32(n_local) * band.astype(jnp.float32))
        proj = _gather_proj(proj, axis)
        rows = jax.lax.all_gather(rows, axis, axis=1, tiled=True)

        y_off = (jnp.asarray(band, jnp.float32)
                 * (ty_local * cfg.raster.tile_size))
        shifted = dataclasses.replace(
            proj, xy=proj.xy - jnp.stack([jnp.zeros((), jnp.float32), y_off]))
        local_cfg = cfg.replace(height=h_local)
        band_cam = dataclasses.replace(cam, cy=cam.cy - y_off)
        st = _gut_statics(
            dataclasses.replace(raster_statics(cfg),
                                tiles_y=ty_local),
            cfg, packed=False)
        pix_ctx = build_tile_rays(band_cam, local_cfg)
        img, trans, ov = _band_raster(shifted, rows, local_cfg, st,
                                      max_pairs, pix_ctx=pix_ctx)
        return img, trans, jax.lax.psum(ov.astype(jnp.int32), axis) > 0

    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(axis), P()),
        out_specs=(P(axis), P(axis), P()),
        check_vma=False,
    )
    img, trans, overflow = fn(splats, cam)
    return img[:cfg.height], trans[:cfg.height], overflow


@partial(jax.jit, static_argnames=("cfg", "max_pairs", "mesh"))
def render_3dgrt_sharded(splats: SplatSet, cam: Camera, cfg: RenderConfig,
                         max_pairs: int, mesh: Mesh):
    """3DGRT primary rays over the mesh: splat-sharded UT projection +
    band-sharded exact-ray blending in shared-origin RADIAL order (the
    per-ray-t order of rgen:615-818 for primaries — see render_3dgrt).
    Returns (image, transmittance, overflow) cropped to cfg.height."""
    from vk_gaussian_splatting_tpu.ops.projection import ut_project_splats
    from vk_gaussian_splatting_tpu.render.pipelines import (
        _gut_statics,
        gut_attr_rows,
    )
    from vk_gaussian_splatting_tpu.render.rays import build_tile_rays

    axis = mesh.axis_names[0]
    nd = mesh.shape[axis]
    ty_local = _band_rows(cfg, nd)
    h_local = ty_local * cfg.raster.tile_size

    def shard_fn(splats_local: SplatSet, cam: Camera):
        prepared = prepare_splats(splats_local, cfg.sh_format)
        proj = ut_project_splats(prepared, cam, cfg)
        radial = jnp.linalg.norm(prepared.means - cam.position, axis=-1)
        rows = gut_attr_rows(prepared, proj, cfg, depth=radial)
        band = jax.lax.axis_index(axis)
        n_local = rows.shape[1]
        rows = rows.at[-1].add(jnp.float32(n_local) * band.astype(jnp.float32))
        proj = _gather_proj(proj, axis)
        rows = jax.lax.all_gather(rows, axis, axis=1, tiled=True)
        radial_g = jax.lax.all_gather(radial, axis, axis=0, tiled=True)

        y_off = (jnp.asarray(band, jnp.float32)
                 * (ty_local * cfg.raster.tile_size))
        shifted = dataclasses.replace(
            proj, xy=proj.xy - jnp.stack([jnp.zeros((), jnp.float32), y_off]))
        local_cfg = cfg.replace(height=h_local)
        band_cam = dataclasses.replace(cam, cy=cam.cy - y_off)
        st = _gut_statics(
            dataclasses.replace(raster_statics(cfg),
                                tiles_y=ty_local),
            cfg, packed=False,
            alpha_clamp=cfg.rt.alpha_clamp,
            min_transmittance=cfg.rt.min_transmittance)
        pix_ctx = build_tile_rays(band_cam, local_cfg)
        img, trans, ov = _band_raster(shifted, rows, local_cfg, st,
                                      max_pairs, pix_ctx=pix_ctx,
                                      depth_override=radial_g)
        return img, trans, jax.lax.psum(ov.astype(jnp.int32), axis) > 0

    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(axis), P()),
        out_specs=(P(axis), P(axis), P()),
        check_vma=False,
    )
    img, trans, overflow = fn(splats, cam)
    return img[:cfg.height], trans[:cfg.height], overflow


@partial(jax.jit, static_argnames=("cfg", "max_pairs", "mesh"))
def train_step_sharded(splats: SplatSet, cam: Camera, target: jax.Array,
                       cfg: RenderConfig, max_pairs: int, mesh: Mesh,
                       lr: float = 1e-2):
    """One SGD step of image-supervised splat optimization over the mesh.

    splats: sharded over the mesh axis (leading dim). target: (H, W, 3),
    split over rows into the tile-row bands; when the bands overhang the
    image (e.g. 1080 rows over 4 devices) it pads with zero rows, where the
    render is empty too. Returns (updated splats, loss).
    """
    axis = mesh.axis_names[0]
    nd = mesh.shape[axis]
    pad = nd * _band_rows(cfg, nd) * cfg.raster.tile_size - target.shape[0]
    target = jnp.pad(target, ((0, pad), (0, 0), (0, 0)))

    def shard_loss(splats_local: SplatSet, cam: Camera, target_local: jax.Array):
        prepared = prepare_splats(splats_local, cfg.sh_format)
        proj = project_splats(prepared, cam, cfg)
        proj = _gather_proj(proj, axis)
        band = jax.lax.axis_index(axis)
        img, _, _ = _render_band(proj, cfg, max_pairs, band, nd)
        return jax.lax.psum(jnp.sum((img - target_local) ** 2), axis)

    loss_fn = jax.shard_map(
        shard_loss, mesh=mesh,
        in_specs=(P(axis), P(), P(axis)),
        out_specs=P(),
        check_vma=False,
    )

    loss, grads = jax.value_and_grad(
        lambda s: loss_fn(s, cam, target))(splats)
    new = jax.tree.map(lambda p, g: p - lr * g, splats, grads)
    return new, loss
