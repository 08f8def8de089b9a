"""Wavefront secondary bounces: mesh reflections/refractions through splats.

The reference's bounce loop (threedgrt_raytrace.rgen.slang:244-337 +
evaluateLightingAndShadingForBounce :1037-1258) continues a pixel's ray when
the closest mesh hit has a reflective (illum==1) or refractive (illum>=2)
material, scaling the carried transmittance by the material specular /
transmittance and re-tracing meshes (closest hit) + particles (k-buffer
marching) along the new ray (wavefront.h.slang illum dispatch).

Redesign: secondary rays are a dense batch, not per-pixel recursion —
spawn rays at every raster pixel whose mesh face is reflective/refractive
(optionally at a subsampled stride), then run a statically-bounded bounce
loop where each bounce is one ``trace_mesh`` closest-hit sweep + one
``trace_splats`` windowed integration (ops/raytrace.py) over the whole batch,
with masks standing in for per-ray termination.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from vk_gaussian_splatting_tpu.config import RenderConfig, tiles_x, tiles_y
from vk_gaussian_splatting_tpu.ops.tile_blend import OUT_COLS, TILE
from vk_gaussian_splatting_tpu.ops.raytrace import (
    reflect,
    refract_or_reflect,
    trace_mesh,
    trace_splats,
)
from vk_gaussian_splatting_tpu.render.mesh_raster import MeshBuffers
from vk_gaussian_splatting_tpu.scene.cameras import Camera
from vk_gaussian_splatting_tpu.scene.lights import (
    compute_light,
    compute_specular,
    headlight,
    light_direction_to,
)

EPS_T = 1e-3  # self-hit bias (rgen tMin = 0.001)


def tile_ctx_to_image(ctx: jax.Array, cfg: RenderConfig):
    """Unpack the (T, 8, 256) tile-packed pixel context of
    render/rays.py:build_tile_rays back to image layout; returns
    (dirs (H,W,3), origins (H,W,3))."""
    tx, ty = tiles_x(cfg), tiles_y(cfg)
    blocks = ctx.reshape(ty, tx, OUT_COLS, TILE, TILE)
    full = blocks.transpose(0, 3, 1, 4, 2).reshape(ty * TILE, tx * TILE,
                                                   OUT_COLS)
    full = full[:cfg.height, :cfg.width]
    return full[..., 0:3], full[..., 3:6]


def _face_geometric_normals(mesh: MeshBuffers) -> jax.Array:
    v0 = mesh.positions[mesh.indices[:, 0]]
    e1 = mesh.positions[mesh.indices[:, 1]] - v0
    e2 = mesh.positions[mesh.indices[:, 2]] - v0
    n = jnp.cross(e1, e2)
    return n / jnp.linalg.norm(n, axis=-1, keepdims=True).clip(1e-12)


def _shade_mesh_hit(pos, nrm, view_dir, mesh: MeshBuffers, face, lights,
                    cam: Camera, shadow_fn=None):
    """Direct shading at secondary mesh hits: emission + ambient + per-light
    diffuse/specular (wavefrontComputeShadingDirectOnly, wavefront.h.slang).
    pos/nrm/view_dir (R,3); face (R,) i32 (clipped to valid)."""
    diffuse = mesh.face_colors[face]
    ambient = mesh.face_ambient[face]
    specular = mesh.face_specular[face]
    shininess = mesh.face_shininess[face]
    radiance = mesh.face_emission[face] + ambient

    lights = list(lights) if lights else [headlight(cam.position)]
    for light in lights:
        l_vec, _ = light_direction_to(light, pos)
        term = diffuse * compute_light(light, pos, nrm)
        spec = compute_specular(specular, shininess, view_dir, l_vec, nrm) \
            * (light.color * light.intensity)
        vis = shadow_fn(pos, light) if shadow_fn is not None else 1.0
        radiance = radiance + jnp.asarray(vis)[..., None] * (term + spec)
    return radiance


def _bounce_dispatch(d, nrm, mesh: MeshBuffers, face):
    """New direction + throughput factor + alive mask from the hit face's
    illum model (wavefront.h.slang:336-375)."""
    illum = mesh.face_illum[face]
    spec = mesh.face_specular[face]
    tint = mesh.face_transmittance[face]
    ior = mesh.face_ior[face]

    d_refl = reflect(d, nrm)
    d_refr = refract_or_reflect(d, nrm, ior)
    refractive = (illum >= 2)[:, None]
    new_d = jnp.where(refractive, d_refr, d_refl)
    factor = jnp.where(refractive, tint, spec)
    alive = illum >= 1
    return new_d, jnp.where(alive[:, None], factor, 0.0), alive


def trace_secondary(
    prepared,
    cam: Camera,
    cfg: RenderConfig,
    mesh: MeshBuffers,
    origins: jax.Array,      # (R,3) spawn points (on the primary surface)
    dirs: jax.Array,         # (R,3) unit secondary directions
    throughput: jax.Array,   # (R,3) carried transmittance at spawn
    lights=(),
    shadow_fn=None,
    max_bounces: int | None = None,
):
    """Run the bounce loop; returns (R,3) radiance to add under throughput."""
    if max_bounces is None:
        max_bounces = cfg.rt.max_bounces
    face_nrm = _face_geometric_normals(mesh)
    radiance = jnp.zeros_like(throughput)
    o, d, thr = origins, dirs, throughput
    r = o.shape[0]

    for _ in range(max_bounces):
        mh = trace_mesh(mesh.positions, mesh.indices, o, d,
                        jnp.full((r,), EPS_T))
        ts = trace_splats(prepared, o, d, jnp.full((r,), EPS_T), mh.t, cfg)
        radiance = radiance + thr * ts.radiance
        thr = thr * ts.transmittance[:, None]

        face = jnp.maximum(mh.face, 0)
        hit_pos = o + d * jnp.where(mh.hit, mh.t, 0.0)[:, None]
        nrm = face_nrm[face]
        shade = _shade_mesh_hit(hit_pos, nrm, d, mesh, face, lights, cam,
                                shadow_fn)
        radiance = radiance + jnp.where(mh.hit[:, None], thr * shade, 0.0)

        new_d, factor, alive = _bounce_dispatch(d, nrm, mesh, face)
        cont = mh.hit & alive
        thr = jnp.where(cont[:, None], thr * factor, 0.0)
        live = jnp.max(thr, axis=-1) > cfg.rt.min_transmittance
        thr = jnp.where(live[:, None], thr, 0.0)
        o = hit_pos
        d = jnp.where(cont[:, None], new_d, d)
    return radiance


def secondary_spawn(
    cam: Camera,
    cfg: RenderConfig,
    mesh: MeshBuffers,
    face_id: jax.Array,      # (H,W) i32 primary mesh face (-1 = none)
    splat_trans: jax.Array,  # (H,W) splat transmittance in front of the mesh
    stride: int = 1,
):
    """Spawn the secondary batch from the raster primary pass: pixels whose
    mesh face is reflective/refractive get a ray at the exact ray/face-plane
    intersection. Returns (origins, dirs, throughput, mask_lr, shape_lr) with
    R = (H/stride)*(W/stride)."""
    from vk_gaussian_splatting_tpu.render.rays import build_tile_rays

    dirs_img, orig_img = tile_ctx_to_image(build_tile_rays(cam, cfg), cfg)
    fid = face_id[::stride, ::stride]
    d = dirs_img[::stride, ::stride].reshape(-1, 3)
    o = orig_img[::stride, ::stride].reshape(-1, 3)
    tr = splat_trans[::stride, ::stride].reshape(-1)
    shape_lr = fid.shape
    fid = fid.reshape(-1)

    face = jnp.maximum(fid, 0)
    illum = mesh.face_illum[face]
    mask = (fid >= 0) & (illum >= 1)

    # exact ray/face-plane intersection (flat faces): t = ((v0-o).n)/(d.n)
    face_nrm = _face_geometric_normals(mesh)[face]
    v0 = mesh.positions[mesh.indices[face, 0]]
    denom = jnp.sum(d * face_nrm, axis=-1)
    t = jnp.sum((v0 - o) * face_nrm, axis=-1) \
        / jnp.where(jnp.abs(denom) < 1e-12, 1.0, denom)
    t = jnp.where((jnp.abs(denom) >= 1e-12) & (t > 0), t, 0.0)
    hit_pos = o + d * t[:, None]

    new_d, factor, _ = _bounce_dispatch(d, face_nrm, mesh, face)
    throughput = jnp.where(mask[:, None], tr[:, None] * factor, 0.0)
    return hit_pos, new_d, throughput, mask.reshape(shape_lr), shape_lr


def add_secondary_radiance(image: jax.Array, radiance_lr: jax.Array,
                           shape_lr, cfg: RenderConfig) -> jax.Array:
    """Upsample the (R,3) low-res bounce radiance back to (H,W,3) and add."""
    h_lr, w_lr = shape_lr
    rad = radiance_lr.reshape(h_lr, w_lr, 3)
    if (h_lr, w_lr) != (cfg.height, cfg.width):
        rad = jax.image.resize(rad, (cfg.height, cfg.width, 3),
                               method="nearest")
    return image + rad
