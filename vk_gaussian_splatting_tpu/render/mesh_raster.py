"""Mesh rasterization + splat/mesh compositing (H9 MeshManagerVk + S16
threedmesh_raster + the FTB mesh-composited frame of
gaussian_splatting.cpp:705-850).

The design reuses the whole splat machinery: triangles project, bin into
tiles through the same pair expansion (rect extents = 2D bounding boxes), and
"blend" front-to-back with the ``tri2d`` response (alpha 1 inside) — the
first covering triangle wins, i.e. a z-buffer expressed as sorted
compositing. The resulting per-pixel mesh depth rides the pixel-context into
a ``gs2d_clip`` splat pass (the reference's mesh depth prepass clipping the
splat FTB pass), and the mesh color composites under the remaining splat
transmittance.

Shading: flat per-face Lambert+Phong against the scene lights with material
diffuse/emission (wavefront shading subset; reflections/refractions are the
hybrid ray pipeline's job).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from vk_gaussian_splatting_tpu.config import RenderConfig, tiles_x, tiles_y
from vk_gaussian_splatting_tpu.io.obj import ObjMesh
from vk_gaussian_splatting_tpu.ops.binning import bin_splats
from vk_gaussian_splatting_tpu.ops.projection import ProjectedSplats
from vk_gaussian_splatting_tpu.ops.tile_blend import (
    OUT_COLS,
    PIX,
    TILE,
    RasterStatics,
    assemble_image,
    rasterize_bins,
)
from vk_gaussian_splatting_tpu.ops.response import PIX_DEPTH_LIMIT
from vk_gaussian_splatting_tpu.scene.cameras import Camera, view_transform_points
from vk_gaussian_splatting_tpu.scene.lights import compute_light, headlight


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class MeshBuffers:
    """Device triangle soup (MeshVk vertex/index/material buffers) with the
    per-face ObjMaterial fields the wavefront bounce dispatch needs
    (wavefront.h:28-50)."""

    positions: jax.Array    # (V,3)
    normals: jax.Array      # (V,3)
    indices: jax.Array      # (F,3) i32
    face_colors: jax.Array  # (F,3) material diffuse per face
    face_emission: jax.Array  # (F,3)
    face_ambient: jax.Array       # (F,3)
    face_specular: jax.Array      # (F,3)
    face_shininess: jax.Array     # (F,)
    face_transmittance: jax.Array  # (F,3) refractive filter (illum>=2)
    face_ior: jax.Array           # (F,)
    face_illum: jax.Array         # (F,) i32 0 opaque / 1 mirror / >=2 glass


def mesh_buffers_from_obj(mesh: ObjMesh, transform: np.ndarray | None = None
                          ) -> MeshBuffers:
    pos = np.asarray(mesh.positions, np.float32)
    nrm = np.asarray(mesh.normals, np.float32)
    if transform is not None:
        t = np.asarray(transform, np.float64)
        pos = (pos @ t[:3, :3].T + t[:3, 3]).astype(np.float32)
        rinv = np.linalg.inv(t[:3, :3]).T
        nrm = (nrm @ rinv.T).astype(np.float32)
        nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
    mats = mesh.materials
    mi = mesh.mat_indices

    def per_face(attr, width):
        return np.asarray([getattr(mats[i], attr) for i in mi],
                          np.float32).reshape(-1, width)

    return MeshBuffers(
        positions=jnp.asarray(pos), normals=jnp.asarray(nrm),
        indices=jnp.asarray(mesh.indices, jnp.int32),
        face_colors=jnp.asarray(per_face("diffuse", 3)),
        face_emission=jnp.asarray(per_face("emission", 3)),
        face_ambient=jnp.asarray(per_face("ambient", 3)),
        face_specular=jnp.asarray(per_face("specular", 3)),
        face_shininess=jnp.asarray(per_face("shininess", 1)[:, 0]),
        face_transmittance=jnp.asarray(per_face("transmittance", 3)),
        face_ior=jnp.asarray(per_face("ior", 1)[:, 0]),
        face_illum=jnp.asarray(
            np.asarray([mats[i].illum for i in mi], np.int32)),
    )


def _project_triangles(mesh: MeshBuffers, cam: Camera, cfg: RenderConfig,
                       lights):
    """Project + shade triangles; returns (ProjectedSplats adapter for
    binning [xy = centroid, radius = half bbox], per-vertex uv (F,3,2),
    per-vertex view z (F,3), per-vertex shaded colors (F,3,3))."""
    p_view = view_transform_points(cam.viewmat, mesh.positions)   # (V,3)
    z = p_view[:, 2]
    zs = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    u = cam.fx * p_view[:, 0] / zs + cam.cx
    v = cam.fy * p_view[:, 1] / zs + cam.cy
    uv = jnp.stack([u, v], -1)                                    # (V,2)

    tri_uv = uv[mesh.indices]                                     # (F,3,2)
    tri_z = z[mesh.indices]                                       # (F,3)
    depth = tri_z.mean(axis=1)
    valid = (tri_z > cam.near).all(axis=1) & (tri_z < cam.far).all(axis=1)

    lo = tri_uv.min(axis=1)
    hi = tri_uv.max(axis=1)
    center = 0.5 * (lo + hi)
    radius = jnp.ceil(0.5 * (hi - lo)) + 1.0                      # (F,2)

    lights = list(lights) if lights else [headlight(cam.position)]

    # per-vertex Gouraud shading (the vertex-shader stage of
    # threedmesh_raster.vert.slang): each corner lit with ITS normal
    vpos = mesh.positions[mesh.indices]                           # (F,3,3)
    vnrm = mesh.normals[mesh.indices]
    vnrm = vnrm / jnp.maximum(
        jnp.linalg.norm(vnrm, axis=-1, keepdims=True), 1e-12)
    base = (mesh.face_emission + 0.1 * mesh.face_colors)[:, None, :]
    vcol = jnp.broadcast_to(base, vpos.shape)
    for light in lights:
        lit = compute_light(light, vpos.reshape(-1, 3),
                            vnrm.reshape(-1, 3)).reshape(vpos.shape)
        vcol = vcol + mesh.face_colors[:, None, :] * lit

    # flat shading at face centers (the "flat" tier + the face color the
    # wavefront shading reuses)
    fnrm = vnrm.mean(axis=1)
    fnrm = fnrm / jnp.maximum(
        jnp.linalg.norm(fnrm, axis=-1, keepdims=True), 1e-12)
    fpos = vpos.mean(axis=1)
    radiance = mesh.face_emission + 0.1 * mesh.face_colors
    for light in lights:
        radiance = radiance + mesh.face_colors * compute_light(
            light, fpos, fnrm)

    proj = ProjectedSplats(
        xy=center, conic=jnp.zeros((center.shape[0], 3), jnp.float32),
        depth=depth, radius=jnp.where(valid[:, None], radius, 0.0),
        color=radiance, alpha=jnp.ones_like(depth), valid=valid,
    )
    return proj, tri_uv, tri_z, vcol


def _tri_attr_rows(tri_uv: jax.Array, proj: ProjectedSplats) -> jax.Array:
    """(13, F) face-level rows in the tri2d layout; vertices absolute (the
    kernel re-centers on each tile origin)."""
    f = tri_uv.shape[0]
    return jnp.stack([
        tri_uv[:, 0, 0], tri_uv[:, 0, 1],
        tri_uv[:, 1, 0], tri_uv[:, 1, 1],
        tri_uv[:, 2, 0], tri_uv[:, 2, 1],
        proj.color[:, 0], proj.color[:, 1], proj.color[:, 2],
        jnp.zeros((f,), jnp.float32),  # row 9 unused
        jnp.zeros((f,), jnp.float32),  # row 10 unused
        proj.depth,                    # TRI_DEPTH = 11
        jnp.arange(f, dtype=jnp.int32).astype(jnp.float32),  # TRI_ID = 12
    ], axis=0)


def _tri_smooth_attr_rows(tri_uv: jax.Array, tri_z: jax.Array,
                          vcol: jax.Array) -> jax.Array:
    """(15, F) rows in the tri2d_smooth layout (ops/response.py): absolute
    vertex xy, bf16-packed per-vertex shaded colors, f32 per-vertex view z."""
    from vk_gaussian_splatting_tpu.ops.response import pack2bf16
    f = tri_uv.shape[0]
    c = jnp.clip(vcol, 0.0, None)
    return jnp.stack([
        tri_uv[:, 0, 0], tri_uv[:, 0, 1],
        tri_uv[:, 1, 0], tri_uv[:, 1, 1],
        tri_uv[:, 2, 0], tri_uv[:, 2, 1],
        pack2bf16(c[:, 0, 0], c[:, 0, 1]),          # TRIS_C01 (r0, g0)
        pack2bf16(c[:, 0, 2], c[:, 1, 0]),          # TRIS_C23 (b0, r1)
        pack2bf16(c[:, 1, 1], c[:, 1, 2]),          # TRIS_C45 (g1, b1)
        pack2bf16(c[:, 2, 0], c[:, 2, 1]),          # TRIS_C67 (r2, g2)
        pack2bf16(c[:, 2, 2], jnp.zeros((f,))),     # TRIS_C8 (b2, -)
        tri_z[:, 0], tri_z[:, 1], tri_z[:, 2],      # TRIS_Z0..Z2
        jnp.arange(f, dtype=jnp.int32).astype(jnp.float32),  # TRIS_ID
    ], axis=0)


def mesh_bins(mesh: MeshBuffers, cam: Camera, cfg: RenderConfig,
              max_pairs: int, lights=()):
    """Triangles binned for the tile blender: (TileBins, RasterStatics)."""
    proj, tri_uv, tri_z, vcol = _project_triangles(mesh, cam, cfg, lights)
    smooth = cfg.raster.mesh_shading == "smooth"
    # opaque geometry: the depth-iso pick at threshold ~1 records the first
    # covering face
    st = RasterStatics(
        tiles_x=tiles_x(cfg), tiles_y=tiles_y(cfg), chunk=cfg.raster.chunk,
        model="tri2d_smooth" if smooth else "tri2d", depth_iso=0.999,
    )
    rows = (_tri_smooth_attr_rows(tri_uv, tri_z, vcol) if smooth
            else _tri_attr_rows(tri_uv, proj))
    exact = cfg.raster.expansion == "exact"
    bins = bin_splats(
        proj, rows, tile_size=cfg.raster.tile_size, tiles_x=st.tiles_x,
        tiles_y=st.tiles_y,
        slots_k=max(cfg.raster.slots_k, 64),  # triangles often span many tiles
        max_pairs=max_pairs if exact else 0,
        expansion=cfg.raster.expansion,
        classes=False)  # few triangles; class caps (n/8, n/64) are too tight
    return bins, st


def render_mesh(mesh: MeshBuffers, cam: Camera, cfg: RenderConfig,
                max_pairs: int, lights=()):
    """Rasterize a triangle mesh: returns (color (H,W,3), coverage mask
    transmittance (H,W) — 0 where covered, depth (H,W), face id (H,W))."""
    bins, st = mesh_bins(mesh, cam, cfg, max_pairs, lights)
    out = rasterize_bins(bins, None, None, st)
    img, trans, depth, fid = assemble_image(
        out, st.tiles_x, st.tiles_y, cfg.width, cfg.height,
        cfg.background, with_aux=True)
    return img, trans, depth, fid


def depth_limit_pix_ctx(depth: jax.Array, cfg: RenderConfig) -> jax.Array:
    """Pack a (H,W) depth-limit image into the (T,8,256) pixel context
    (row PIX_DEPTH_LIMIT) for the *_clip blender models."""
    tx, ty = tiles_x(cfg), tiles_y(cfg)
    h_pad, w_pad = ty * TILE, tx * TILE
    full = jnp.zeros((h_pad, w_pad, OUT_COLS), jnp.float32)
    full = full.at[:depth.shape[0], :depth.shape[1], PIX_DEPTH_LIMIT].set(depth)
    blocks = full.reshape(ty, TILE, tx, TILE, OUT_COLS)
    return blocks.transpose(0, 2, 4, 1, 3).reshape(ty * tx, OUT_COLS, PIX)
