"""Surface info + deferred shading (S11, deferred_shading.comp.slang; NEED_SURFACE_INFO
paths of the raster shaders).

Surface reconstruction here:
- per-splat normals via the max-density-plane approximation
  (computeEllipsoidNormalMaxDensityPlane, threedgrt.h.slang:358-418) with the
  thin-particle fallbacks, vectorized over all splats;
- the opacity-weighted normal blend (frag outNormal = n * opacity composited
  FTB) reuses the tile blender with normals riding the color rows — one extra
  blend pass when surface info is requested;
- picked depth / splat id come from the blender's aux outputs.

Deferred shading is a fullscreen jnp pass: reconstruct the world position from
the picked depth along the camera ray, look up the per-instance material, and
accumulate the Phong lights (deferred_shading.comp.slang:39-160; headlight
fallback when the scene has no lights).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from vk_gaussian_splatting_tpu.config import RenderConfig
from vk_gaussian_splatting_tpu.scene.cameras import Camera
from vk_gaussian_splatting_tpu.scene.lights import (
    LightSource,
    compute_light,
    compute_specular,
    headlight,
    light_direction_to,
)
from vk_gaussian_splatting_tpu.scene.splat_set import PreparedSplats, quat_to_rotmat


def compute_splat_normals(prepared: PreparedSplats, cam_position: jax.Array,
                          thin_threshold: float = 1e-3,
                          splat_scale: float = 1.0) -> jax.Array:
    """(N,3) world-space outward normals (threedgrt.h.slang:358-418)."""
    pos = prepared.means
    scl = jnp.exp(prepared.scales_log) * splat_scale       # (N,3)
    rot = quat_to_rotmat(prepared.quats)                   # (N,3,3)
    local = cam_position - pos                             # toward camera

    is_small = scl < thin_threshold
    small_count = jnp.sum(is_small, axis=-1)

    # gradient normal: R diag(1/s^2) R^T (cam - mu)
    hp = jax.lax.Precision.HIGHEST
    canon = jnp.einsum("ni,nij->nj", local, rot, precision=hp)
    scaled = canon / jnp.maximum(scl * scl, 1e-20)
    grad = jnp.einsum("nj,nij->ni", scaled, rot, precision=hp)
    n_grad = grad / jnp.maximum(
        jnp.linalg.norm(grad, axis=-1, keepdims=True), 1e-12)

    # flat particle: normal along the small axis
    axis_idx = jnp.argmax(is_small, axis=-1)
    axis_local = jax.nn.one_hot(axis_idx, 3, dtype=jnp.float32)
    n_flat = jnp.einsum("nj,nij->ni", axis_local, rot)
    n_flat = n_flat / jnp.maximum(
        jnp.linalg.norm(n_flat, axis=-1, keepdims=True), 1e-12)

    # degenerate: face the camera
    n_view = local / jnp.maximum(
        jnp.linalg.norm(local, axis=-1, keepdims=True), 1e-12)

    n = jnp.where((small_count == 0)[:, None], n_grad,
                  jnp.where((small_count == 1)[:, None], n_flat, n_view))
    # outward: flip toward the camera
    flip = jnp.sign(jnp.sum(n * local, axis=-1, keepdims=True))
    return n * jnp.where(flip == 0, 1.0, flip)


def render_normal_buffer(prepared: PreparedSplats, proj, cam: Camera,
                         cfg: RenderConfig, st, max_pairs: int = 0,
                         pix_ctx=None, use_gut_rows: bool = False) -> jax.Array:
    """Opacity-weighted blended normal image (H,W,3) — one extra blender pass
    with normals riding the color rows (frag.slang:320-349 outNormal MRT)."""
    from vk_gaussian_splatting_tpu.ops.tile_blend import (
        assemble_image,
        rasterize_bins,
    )
    from vk_gaussian_splatting_tpu.render.pipelines import (
        bin_for_cfg,
        gs_attr_rows,
        gut_attr_rows,
    )

    normals = compute_splat_normals(prepared, cam.position,
                                    splat_scale=cfg.splat_scale)
    proj_n = dataclasses.replace(proj, color=normals)
    rows = (gut_attr_rows(prepared, proj_n, cfg) if use_gut_rows
            else gs_attr_rows(proj_n))
    bins = bin_for_cfg(proj_n, rows, cfg, max_pairs)
    out = rasterize_bins(bins, pix_ctx, None, st)
    nrm, trans = assemble_image(out, st.tiles_x, st.tiles_y,
                                cfg.width, cfg.height, (0.0, 0.0, 0.0))
    w = jnp.maximum(1.0 - trans, 1e-6)[..., None]
    nrm = nrm / w
    return nrm / jnp.maximum(jnp.linalg.norm(nrm, axis=-1, keepdims=True), 1e-6)


@dataclasses.dataclass(frozen=True)
class DeferredMaterial:
    """Per-set shading material (SplatSetDesc.material analog)."""

    diffuse: tuple = (1.0, 1.0, 1.0)
    ambient: tuple = (0.1, 0.1, 0.1)
    specular: tuple = (0.0, 0.0, 0.0)
    shininess: float = 32.0
    emission: tuple = (0.0, 0.0, 0.0)


def instance_index_image(splat_id_img: jax.Array,
                         instance_base) -> jax.Array:
    """(H,W) i32 instance index per pixel from the picked global splat id
    and the global index table's instance bases — the analog of the
    shader's global-index-table material lookup
    (deferred_shading.comp.slang:107-124). Pixels with no pick get 0 (they
    are masked by `covered` downstream)."""
    bases = jnp.asarray(instance_base, jnp.int32)
    sid = jnp.maximum(splat_id_img, 0)
    return jnp.clip(jnp.searchsorted(bases, sid, side="right") - 1,
                    0, bases.shape[0] - 2).astype(jnp.int32)


def _material_fields(material, set_index_img):
    """Resolve (diffuse, ambient, specular, shininess, emission) as either
    broadcastable constants (single material) or per-pixel gathers from the
    per-set material array (material = tuple of DeferredMaterial +
    set_index_img)."""
    if isinstance(material, DeferredMaterial):
        return (jnp.asarray(material.diffuse), jnp.asarray(material.ambient),
                jnp.asarray(material.specular, jnp.float32),
                material.shininess, jnp.asarray(material.emission))
    mats = tuple(material)
    if set_index_img is None:
        raise ValueError("per-set materials need set_index_img "
                         "(instance_index_image of the splat_id pick)")
    stack = lambda f: jnp.asarray([getattr(m, f) for m in mats], jnp.float32)
    idx = jnp.clip(set_index_img, 0, len(mats) - 1)
    return (stack("diffuse")[idx], stack("ambient")[idx],
            stack("specular")[idx], stack("shininess")[idx],
            stack("emission")[idx])


def deferred_shade(
    image: jax.Array,         # (H,W,3) rasterized radiance
    transmittance: jax.Array,  # (H,W)
    normal_img: jax.Array,    # (H,W,3) blended normals
    depth_img: jax.Array,     # (H,W) picked view depth (0 = no pick)
    cam: Camera,
    cfg: RenderConfig,
    lights: list[LightSource] | None = None,
    material: DeferredMaterial | tuple = DeferredMaterial(),
    shadow_fn=None,
    set_index_img: jax.Array | None = None,
) -> jax.Array:
    """Fullscreen lighting pass (deferred_shading.comp.slang:53-160).

    material: one DeferredMaterial, or a tuple of them (one per instance)
    together with set_index_img (H,W) i32 — the per-set material lookup of
    deferred_shading.comp.slang:107-124 (use instance_index_image to build
    the index from the splat_id pick).
    shadow_fn: optional callable (world_pos (H,W,3), light) -> (H,W)
    transmittance toward the light (1 = unshadowed); used by the hybrid
    pipelines for ray-traced shadows.
    """
    h, w = depth_img.shape
    ys, xs = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32) + 0.5,
                          jnp.arange(w, dtype=jnp.float32) + 0.5,
                          indexing="ij")
    d_cam = jnp.stack([(xs - cam.cx) / cam.fx, (ys - cam.cy) / cam.fy,
                       jnp.ones_like(xs)], -1)
    r_wc = cam.viewmat[:3, :3].T
    # picked depth is view-space z: world position along the pixel ray
    world_pos = cam.position + jnp.matmul(
        d_cam * depth_img[..., None], r_wc.T,
        precision=jax.lax.Precision.HIGHEST)

    covered = (jnp.linalg.norm(normal_img, axis=-1) > 1e-3) & (depth_img > 0)
    normal = normal_img / jnp.maximum(
        jnp.linalg.norm(normal_img, axis=-1, keepdims=True), 1e-6)
    view_dir = world_pos - cam.position
    view_dir = view_dir / jnp.maximum(
        jnp.linalg.norm(view_dir, axis=-1, keepdims=True), 1e-12)

    base = image
    m_diffuse, m_ambient, m_specular, m_shininess, m_emission = \
        _material_fields(material, set_index_img)
    mat_diffuse = base * m_diffuse
    mat_ambient = base * m_ambient
    emission = base * m_emission

    if not lights:
        lights = [headlight(cam.position)]

    color = emission + mat_ambient
    for light in lights:
        shadow_t = (shadow_fn(world_pos, light) if shadow_fn is not None
                    else jnp.ones_like(depth_img))
        # scalar (H, W) mono shadows or (H, W, 3) colored transmittance
        # (render/shadows.shadow_tint / mesh material filters)
        if shadow_t.ndim == world_pos.ndim - 1:
            shadow_t = shadow_t[..., None]
        diffuse = mat_diffuse * compute_light(light, world_pos, normal)
        l_vec, _ = light_direction_to(light, world_pos)
        spec = compute_specular(m_specular, m_shininess, view_dir,
                                l_vec, normal)
        color = color + shadow_t * (
            diffuse + spec * light.color * light.intensity)

    return jnp.where(covered[..., None], color, image)
