"""Splat shadows: per-light deep shadow maps + per-ray traced shadows.

The reference traces per-pixel shadow rays through the particle BVH
(rgen:1261-1464: any-hit transmittance accumulation toward each light with
``particleShadowOffset`` self-shadow bias and a transmittance threshold). The
raster equivalent here renders, per light, a *deep shadow map*: one gs2d pass
from the light's viewpoint with the tile blender's multi-iso depth picks —
the depths at which transmittance crosses (0.75, 0.5, 0.25, 0.05) — giving a
piecewise-constant T(depth) staircase per light pixel. The deferred pass
projects each shade point into the light frustum and reads off its
transmittance level.

Feature parity (VERDICT r4 next #7):

- **Colored shadows** — ``shadow_tint`` is the reference's post-loop
  per-channel tinting (rgen:1446-1460): the scalar transmittance is remapped
  through the ``particleShadowTransmittanceThreshold`` hard cutoff and
  tinted by the shadow ray's accumulated particle radiance with
  ``particleShadowColorStrength`` in [0 = mono, 1 = fully colored]. Both the
  ray path and the map path (which stores a normalized-radiance tint image)
  support it; mesh occluders multiply their material transmittance
  (rgen:1320-1340, glass casts colored shadows).
- **Enclosed point lights** — a light inside the scene bounding sphere gets
  a 6-face CUBE deep shadow map (``render_cube_shadow_map``) instead of the
  single perspective cone; ``make_shadow_fn`` auto-selects. The reference's
  per-ray any-hit shadows work from any origin for free (rgen:1343-1460);
  the cube map is the raster-analog answer.

Exactness: the staircase quantizes transmittance to 5 levels; the ray path
(``make_ray_shadow_fn``, rt.shadows="ray") is continuous and exact. Note
the reference DEFAULTS its threshold to 0.8 (parameters.h:223), which
hard-clips T <= 0.8 to black; our RtConfig defaults keep threshold 0 /
strength 0 (continuous raw transmittance) and expose the reference values
via ``rt.shadow_transmittance_threshold`` / ``rt.shadow_color_strength``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from vk_gaussian_splatting_tpu.config import RenderConfig, tiles_x, tiles_y
from vk_gaussian_splatting_tpu.ops.projection import project_splats
from vk_gaussian_splatting_tpu.ops.tile_blend import (
    OUT_COLS,
    TILE,
    RasterStatics,
    rasterize_bins,
)
from vk_gaussian_splatting_tpu.scene.cameras import Camera, make_camera
from vk_gaussian_splatting_tpu.scene.lights import LightSource, LightType
from vk_gaussian_splatting_tpu.scene.splat_set import PreparedSplats

ISO_LEVELS = (0.75, 0.5, 0.25, 0.05)


def shadow_tint(t, radiance, threshold: float, strength: float):
    """Reference colored-shadow post-process (rgen:1446-1460).

    t (...): scalar shadow-ray transmittance; radiance (..., 3): the ray's
    accumulated particle radiance. T in [0, threshold] -> black; (threshold,
    1) -> color-transmission zone tinted by the normalized radiance with
    `strength`, fading to no tint at scaledT = 1. Returns (..., 3)."""
    t = jnp.clip(t, 0.0, 1.0)
    scaled = jnp.clip((t - threshold) / (1.0 - threshold), 0.0, 1.0)
    max_rad = jnp.max(radiance, axis=-1, keepdims=True)
    norm_color = jnp.where(max_rad > 1e-3,
                           radiance / jnp.maximum(max_rad, 1e-3), 1.0)
    s = scaled[..., None]
    mix = 1.0 + (norm_color - 1.0) * (strength * (1.0 - s))
    return jnp.clip(s * mix, 0.0, 1.0)


def scene_bounds(prepared: PreparedSplats):
    lo = prepared.means.min(axis=0)
    hi = prepared.means.max(axis=0)
    center = 0.5 * (lo + hi)
    radius = jnp.maximum(jnp.linalg.norm(hi - lo) * 0.5, 1e-3)
    return center, radius


def light_camera(light: LightSource, center, radius, res: int) -> Camera:
    """Perspective frustum from the light covering the scene bounding sphere."""
    is_dir = light.type == LightType.DIRECTIONAL
    dirn = light.direction / jnp.maximum(jnp.linalg.norm(light.direction), 1e-9)
    pos = jnp.where(is_dir, center - dirn * (20.0 * radius), light.position)

    fwd = center - pos
    dist = jnp.maximum(jnp.linalg.norm(fwd), 1e-6)
    fwd = fwd / dist
    upw = jnp.where(jnp.abs(fwd[1]) > 0.95,
                    jnp.asarray([1.0, 0.0, 0.0]), jnp.asarray([0.0, 1.0, 0.0]))
    right = jnp.cross(fwd, upw)
    right = right / jnp.maximum(jnp.linalg.norm(right), 1e-9)
    down = jnp.cross(fwd, right)
    r = jnp.stack([right, down, fwd], axis=0)
    viewmat = jnp.eye(4, dtype=jnp.float32)
    viewmat = viewmat.at[:3, :3].set(r)
    viewmat = viewmat.at[:3, 3].set(-r @ pos)

    # focal so the bounding sphere fits with margin (tan fov/2 = r*1.1/dist)
    tan_half = jnp.clip(radius * 1.1 / dist, 0.05, 3.0)
    f = 0.5 * res / tan_half
    near = jnp.maximum(dist - radius * 1.2, 1e-3)
    far = dist + radius * 1.2
    return make_camera(viewmat, f, f, res * 0.5, res * 0.5, near, far)


@dataclasses.dataclass
class DeepShadowMap:
    cam: Camera
    breakpoints: jax.Array   # (res, res, 4) depth at T crossing ISO_LEVELS
    tint: jax.Array | None = None  # (res, res, 3) normalized accumulated
    #                                radiance (colored-shadow tint source)


def render_deep_shadow_map(prepared: PreparedSplats, light: LightSource,
                           cfg: RenderConfig, res: int = 512,
                           max_pairs: int | None = None) -> DeepShadowMap:
    center, radius = scene_bounds(prepared)
    cam = light_camera(light, center, radius, res)
    return _render_dsm_for_camera(prepared, cam, cfg, res, max_pairs)


def _render_dsm_for_camera(prepared: PreparedSplats, cam: Camera,
                           cfg: RenderConfig, res: int,
                           max_pairs: int | None = None) -> DeepShadowMap:
    light_cfg = cfg.replace(width=res, height=res)
    if max_pairs is None:
        max_pairs = max(4 * prepared.num_splats, 1 << 18)

    proj = project_splats(prepared, cam, light_cfg)
    from vk_gaussian_splatting_tpu.render.pipelines import (
        bin_for_cfg,
        gs_attr_rows,
    )
    bins = bin_for_cfg(proj, gs_attr_rows(proj), light_cfg, max_pairs)
    st = RasterStatics(
        tiles_x=tiles_x(light_cfg), tiles_y=tiles_y(light_cfg),
        chunk=cfg.raster.chunk, model="gs2d", multi_iso=True,
        iso_thresholds=ISO_LEVELS)
    out = rasterize_bins(bins, None, None, st)
    # rows 4-7 hold the iso depths (0 = no crossing)
    ty, tx = tiles_y(light_cfg), tiles_x(light_cfg)
    blocks = out.reshape(ty, tx, OUT_COLS, TILE, TILE)
    full = blocks.transpose(0, 3, 1, 4, 2).reshape(ty * TILE, tx * TILE,
                                                   OUT_COLS)
    # rows 0-2 = FTB-accumulated radiance from the light's viewpoint: the
    # colored-shadow tint source (the raster analog of shadowRadiance in
    # rgen:1409-1441); normalized here so sampling is a plain lookup
    rad = full[:res, :res, 0:3]
    max_rad = jnp.max(rad, axis=-1, keepdims=True)
    tint = jnp.where(max_rad > 1e-3, rad / jnp.maximum(max_rad, 1e-3), 1.0)
    return DeepShadowMap(cam=cam, breakpoints=full[:res, :res, 4:8],
                         tint=tint)


def sample_shadow(world_pos: jax.Array, dsm: DeepShadowMap,
                  shadow_offset: float = 0.05) -> jax.Array:
    """(...,3) world points -> (...) transmittance toward the light.

    shadow_offset biases the comparison toward the light
    (FrameInfo.particleShadowOffset self-shadow bias)."""
    cam = dsm.cam
    p_view = jnp.matmul(world_pos, cam.viewmat[:3, :3].T,
                        precision=jax.lax.Precision.HIGHEST) \
        + cam.viewmat[:3, 3]
    z = p_view[..., 2]
    zs = jnp.maximum(z, 1e-6)
    u = cam.fx * p_view[..., 0] / zs + cam.cx
    v = cam.fy * p_view[..., 1] / zs + cam.cy
    res_y, res_x = dsm.breakpoints.shape[:2]
    ui = jnp.clip(u.astype(jnp.int32), 0, res_x - 1)
    vi = jnp.clip(v.astype(jnp.int32), 0, res_y - 1)
    bp = dsm.breakpoints[vi, ui]                        # (...,4)

    zb = (z - shadow_offset)[..., None]
    t = jnp.ones_like(z)
    for i, level in enumerate(ISO_LEVELS):
        crossed = (bp[..., i] > 0) & (zb[..., 0] > bp[..., i])
        t = jnp.where(crossed, level, t)
    # fully behind the deepest breakpoint: extrapolate to opaque
    deep = (bp[..., 3] > 0) & (zb[..., 0] > bp[..., 3])
    t = jnp.where(deep, 0.0, t)
    # outside the frustum (behind the light or off the map): unshadowed —
    # the map only covers the scene bounding sphere
    inside = (z > 0) & (u >= 0) & (u < res_x) & (v >= 0) & (v < res_y)
    return jnp.where(inside, t, 1.0)


def sample_shadow_colored(world_pos: jax.Array, dsm: DeepShadowMap,
                          threshold: float, strength: float,
                          shadow_offset: float = 0.05) -> jax.Array:
    """(..., 3) per-channel shadow transmittance: the staircase T pushed
    through the reference's colored-shadow post-process (shadow_tint) using
    the map's normalized-radiance tint image."""
    t = sample_shadow(world_pos, dsm, shadow_offset)
    cam = dsm.cam
    p_view = jnp.matmul(world_pos, cam.viewmat[:3, :3].T,
                        precision=jax.lax.Precision.HIGHEST) \
        + cam.viewmat[:3, 3]
    zs = jnp.maximum(p_view[..., 2], 1e-6)
    res_y, res_x = dsm.breakpoints.shape[:2]
    ui = jnp.clip((cam.fx * p_view[..., 0] / zs + cam.cx).astype(jnp.int32),
                  0, res_x - 1)
    vi = jnp.clip((cam.fy * p_view[..., 1] / zs + cam.cy).astype(jnp.int32),
                  0, res_y - 1)
    rad = dsm.tint[vi, ui] if dsm.tint is not None else jnp.ones(
        t.shape + (3,), jnp.float32)
    # tint expects raw radiance but the map stores it pre-normalized; the
    # formula only uses the normalized color, so pass it through directly
    return shadow_tint(t, rad, threshold, strength)


# ---------------------------------------------------------------------------
# enclosed point lights: 6-face cube deep shadow map (VERDICT r4 next #7;
# the reference's per-ray shadows work from any origin — rgen:1343-1460)
# ---------------------------------------------------------------------------

# face basis (right, down, forward) per +x, -x, +y, -y, +z, -z
_CUBE_AXES = (
    ((0, 0, -1), (0, 1, 0), (1, 0, 0)),
    ((0, 0, 1), (0, 1, 0), (-1, 0, 0)),
    ((1, 0, 0), (0, 0, -1), (0, 1, 0)),
    ((1, 0, 0), (0, 0, 1), (0, -1, 0)),
    ((1, 0, 0), (0, 1, 0), (0, 0, 1)),
    ((-1, 0, 0), (0, 1, 0), (0, 0, -1)),
)


@dataclasses.dataclass
class CubeShadowMap:
    faces: list  # 6 DeepShadowMaps (+x, -x, +y, -y, +z, -z)


def render_cube_shadow_map(prepared: PreparedSplats, light: LightSource,
                           cfg: RenderConfig, res: int = 256,
                           max_pairs: int | None = None) -> CubeShadowMap:
    """6 deep-shadow-map faces with slightly-over-90-degree fov (so face
    seams stay covered) from the light position — the enclosed-point-light
    variant a single perspective cone cannot express."""
    _center, radius = scene_bounds(prepared)
    faces = []
    for right, down, fwd in _CUBE_AXES:
        r = jnp.asarray([right, down, fwd], jnp.float32)
        viewmat = jnp.eye(4, dtype=jnp.float32)
        viewmat = viewmat.at[:3, :3].set(r)
        viewmat = viewmat.at[:3, 3].set(-r @ light.position)
        f = 0.5 * res / 1.05  # tan(fov/2) = 1.05: 90 deg + seam margin
        cam = make_camera(viewmat, f, f, res * 0.5, res * 0.5,
                          1e-3, 4.0 * radius)
        faces.append(_render_dsm_for_camera(prepared, cam, cfg, res,
                                            max_pairs))
    return CubeShadowMap(faces=faces)


def sample_shadow_cube(world_pos: jax.Array, csm: CubeShadowMap,
                       shadow_offset: float = 0.05) -> jax.Array:
    """(..., 3) world points -> (...) transmittance toward the enclosed
    light: each face's sample is valid only inside its frustum (z > 0 and
    on-map — sample_shadow returns 1 outside), so the product over faces
    selects the covering face; seam-margin overlap double-counts only
    identical staircase levels of the same blockers (min, not product)."""
    t = jnp.ones(world_pos.shape[:-1], jnp.float32)
    for face in csm.faces:
        t = jnp.minimum(t, sample_shadow(world_pos, face, shadow_offset))
    return t


def make_shadow_fn(prepared: PreparedSplats, lights, cfg: RenderConfig,
                   res: int = 512):
    """Builds deferred_shade's shadow_fn: one deep shadow map per light.

    A POINT light inside the scene bounding sphere gets a 6-face cube map
    (a single cone cannot cover an enclosed light); others get the fitted
    perspective cone. With rt.shadow_color_strength > 0 the cone path
    returns per-channel (..., 3) colored transmittance (shadow_tint)."""
    center, radius = scene_bounds(prepared)
    maps = {}
    for light in lights:
        try:
            enclosed = (int(light.type) == int(LightType.POINT) and float(
                jnp.linalg.norm(light.position - center)) < float(radius))
        except jax.errors.TracerBoolConversionError:
            # under jit tracing the light fields are abstract: the cube/cone
            # choice is structural (it changes the program), so default to
            # the cone; build cube maps outside jit for enclosed lights
            enclosed = False
        except jax.errors.ConcretizationTypeError:
            enclosed = False
        if enclosed:
            maps[id(light)] = render_cube_shadow_map(
                prepared, light, cfg, min(res, 256))
        else:
            maps[id(light)] = render_deep_shadow_map(
                prepared, light, cfg, res)
    strength = cfg.rt.shadow_color_strength
    threshold = cfg.rt.shadow_transmittance_threshold

    def shadow_fn(world_pos, light):
        m = maps[id(light)]
        if isinstance(m, CubeShadowMap):
            return sample_shadow_cube(world_pos, m)
        if strength > 0.0 or threshold > 0.0:
            return sample_shadow_colored(world_pos, m, threshold, strength)
        return sample_shadow(world_pos, m)

    return shadow_fn


def make_ray_shadow_fn(prepared: PreparedSplats, cfg: RenderConfig,
                       shadow_offset: float = 0.05, chunk: int = 256,
                       ray_block: int = 2048, meshes=None):
    """Exact per-ray shadow transmittance (the reference's per-pixel shadow
    trace, rgen:1261-1464): one ray per shade point toward the light,
    integrating splat opacity with ops/raytrace.trace_splats. Continuous
    transmittance (no 5-level staircase) and correct for enclosed point
    lights — at per-frame trace cost; deep shadow maps remain the fast path
    (rt.shadows config selects).

    With rt.shadow_color_strength / rt.shadow_transmittance_threshold set,
    returns (..., 3) per-channel transmittance: the scalar T remapped and
    tinted by the ray's accumulated particle radiance (shadow_tint,
    rgen:1446-1460). `meshes` (a MeshBuffers) adds mesh occluders: the
    closest mesh hit before the light multiplies its material transmittance
    — glass casts colored shadows, opaque materials black ones
    (traceShadowRayMesh, rgen:1295-1340)."""
    from vk_gaussian_splatting_tpu.ops.raytrace import trace_mesh, trace_splats
    from vk_gaussian_splatting_tpu.scene.lights import LightType

    strength = cfg.rt.shadow_color_strength
    threshold = cfg.rt.shadow_transmittance_threshold
    colored = strength > 0.0 or threshold > 0.0

    def shadow_fn(world_pos, light):
        shape = world_pos.shape[:-1]
        p = world_pos.reshape(-1, 3)
        is_dir = light.type == LightType.DIRECTIONAL
        dirn = light.direction / jnp.maximum(
            jnp.linalg.norm(light.direction), 1e-9)
        to_light = jnp.where(is_dir, -dirn[None, :], light.position - p)
        dist = jnp.linalg.norm(to_light, axis=-1)
        d = to_light / jnp.maximum(dist[:, None], 1e-9)
        t_max = jnp.where(is_dir, jnp.inf, dist)
        res = trace_splats(
            prepared, p, d,
            jnp.full((p.shape[0],), shadow_offset), t_max, cfg,
            chunk=chunk, ray_block=ray_block, order="radial")
        t = res.transmittance
        if colored:
            out = shadow_tint(t, res.radiance, threshold, strength)
        else:
            out = t[:, None] * jnp.ones((1, 3), jnp.float32)
        if meshes is not None:
            hit = trace_mesh(meshes.positions, meshes.indices, p, d,
                             jnp.full((p.shape[0],), 1e-3))
            occluded = hit.hit & (hit.t < t_max - 1e-3)
            mesh_t = jnp.where(
                occluded[:, None],
                meshes.face_transmittance[jnp.maximum(hit.face, 0)], 1.0)
            out = out * mesh_t
        if not colored and meshes is None:
            return t.reshape(shape)  # back-compat scalar fast path
        return out.reshape(shape + (3,))

    return shadow_fn
