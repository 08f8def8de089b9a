"""Rendering pipelines as pure functions of (splats, camera, config).

The counterpart of the reference's frame graph
(GaussianSplatting::onRender -> renderHybridPipeline / renderPureRaytracing,
gaussian_splatting.cpp:335-521): each reference pipeline becomes one jittable
function; pipeline/config switches select the traced program (the reference's
shader-macro recompile, SURVEY.md §3.1).

A raster frame = project -> bin (slot expansion + one (tile, depth) payload
sort + per-tile segments, ops/binning.py) -> tile blend (ops/tile_blend.py:
the Triton kernel on the GPU, the XLA blender on the CPU), matching the
dist+sort+raster stages of gaussian_splatting.cpp:1298-1464.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from vk_gaussian_splatting_tpu.config import Pipeline, RenderConfig, tiles_x, tiles_y
from vk_gaussian_splatting_tpu.ops.binning import TileBins, bin_splats
from vk_gaussian_splatting_tpu.ops.projection import (
    ProjectedSplats,
    project_splats,
    ut_project_splats,
)
from vk_gaussian_splatting_tpu.ops.tile_blend import (
    RasterStatics,
    assemble_image,
    rasterize_bins,
)
from vk_gaussian_splatting_tpu.scene.cameras import Camera
from vk_gaussian_splatting_tpu.scene.splat_set import PreparedSplats


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class RenderOutput:
    image: jax.Array          # (H, W, 3)
    transmittance: jax.Array  # (H, W)
    depth: jax.Array          # (H, W) picked depth at T < depth_iso (0 = none)
    splat_id: jax.Array       # (H, W) i32 picked splat id (-1 = none)
    num_pairs: jax.Array      # () i32 — live pairs
    overflow: jax.Array       # () bool — slot/pair budget truncated coverage


def _id_row(n: int) -> jax.Array:
    """Single-row f32 splat ids (packed/gut/tri layouts, which have no
    spare row): above 2^24 they lose integer exactness and silently
    misroute the backward un-sort and splat_id picks (the analog of the
    reference's explicit 16.7M multi-TLAS boundary,
    splat_set_manager_vk.cpp:1060). Fail loudly instead — the wide-id gs2d
    layout (_id_rows_wide) or sharding handles bigger sets."""
    if n >= 1 << 24:
        raise ValueError(
            f"{n} splats exceed the 2^24 f32-exact id limit of a "
            "single-row id layout; use the gs2d f32 path (wide two-row "
            "ids, exact to 2^36) or shard the set")
    return jnp.arange(n, dtype=jnp.int32).astype(jnp.float32)


def _id_rows_wide(n: int, id_base: int = 0):
    """(lo, hi) WIDE id rows: id = hi * 2^12 + lo, both rows integer-exact
    f32 far past 2^24 — a single gs2d stream has no 16.7M boundary
    (VERDICT r4 weak #4). Bound 2^31 from i32 index arithmetic (the
    reference's largest published scene is 106M; HBM runs out long before
    2.1 G splats)."""
    if id_base + n >= 1 << 31:
        raise ValueError(f"{id_base + n} exceeds the 2^31 wide-id bound")
    ids = jnp.arange(n, dtype=jnp.int32) + id_base
    lo = (ids % 4096).astype(jnp.float32)
    hi = (ids // 4096).astype(jnp.float32)
    return lo, hi


def gs_attr_rows(proj: ProjectedSplats, id_base: int = 0) -> jax.Array:
    """(12, N) per-splat attribute rows in the gs2d layout (ops/response.py).
    Rows ride the binning sorts as payloads — no per-pair gathers. The id
    is wide (lo/hi rows, exact past 2^24); id_base offsets it for sharded
    or instance-split streams."""
    n = proj.xy.shape[0]
    id_lo, id_hi = _id_rows_wide(n, id_base)
    return jnp.stack([
        proj.xy[:, 0], proj.xy[:, 1],
        proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2],
        proj.alpha,
        proj.color[:, 0], proj.color[:, 1], proj.color[:, 2],
        proj.depth,
        id_lo,   # GS_ID
        id_hi,   # GS_ID_HI
    ], axis=0)


def gs_attr_rows_packed(proj: ProjectedSplats) -> jax.Array:
    """(8, N) packed gs2dp rows (ops/response.py): bf16/u16 pairs bitcast
    into f32 words (xy and the sort depth stay exact f32) — cuts the
    pair-sort payload count from 11 to 8 (the binning cost driver),
    mirroring the reference's fp16 shformat tier. Forward/rendering only
    (bit patterns have no gradient)."""
    from vk_gaussian_splatting_tpu.ops.response import (
        pack2bf16,
        pack_bf16_u16,
    )
    n = proj.xy.shape[0]
    return jnp.stack([
        proj.xy[:, 0],
        proj.xy[:, 1],
        pack2bf16(proj.conic[:, 0], proj.conic[:, 1]),
        pack2bf16(proj.conic[:, 2], proj.depth),
        pack2bf16(proj.color[:, 0], proj.color[:, 1]),
        pack_bf16_u16(proj.color[:, 2], proj.alpha),
        proj.depth,  # GSP_SORTD (exact blend-order key + aux depth pick)
        _id_row(n),  # GSP_ID
    ], axis=0)


def gut_attr_rows(prepared: PreparedSplats, proj: ProjectedSplats,
                  cfg: RenderConfig, depth: jax.Array | None = None
                  ) -> jax.Array:
    """(16, N) per-splat attribute rows in the gut3d layout.

    depth: overrides the depth row (the aux depth pick) — 3DGRT passes
    radial distance, its blend-order key, reproducing the reference's
    per-ray-t order for shared-origin primaries (rgen:615-818)."""
    n = proj.xy.shape[0]
    quats = prepared.quats / jnp.linalg.norm(
        prepared.quats, axis=-1, keepdims=True).clip(1e-12)
    scl = jnp.exp(prepared.scales_log) * cfg.splat_scale
    return jnp.stack([
        prepared.means[:, 0], prepared.means[:, 1], prepared.means[:, 2],
        scl[:, 0], scl[:, 1], scl[:, 2],
        proj.color[:, 0], proj.color[:, 1], proj.color[:, 2],
        quats[:, 0], quats[:, 1], quats[:, 2], quats[:, 3],
        proj.alpha,
        proj.depth if depth is None else depth,
        _id_row(n),  # GUT_ID
    ], axis=0)


def gut_attr_rows_packed(prepared: PreparedSplats, proj: ProjectedSplats,
                         cfg: RenderConfig, depth: jax.Array | None = None
                         ) -> jax.Array:
    """(11, N) packed gut3dp rows (ops/response.py): exact f32 positions and
    sort depth, bf16/u16 pairs for scale/quat/rgb/opacity. Forward/rendering
    only."""
    from vk_gaussian_splatting_tpu.ops.response import (
        pack2bf16,
        pack_bf16_u16,
    )
    n = proj.xy.shape[0]
    quats = prepared.quats / jnp.linalg.norm(
        prepared.quats, axis=-1, keepdims=True).clip(1e-12)
    scl = jnp.exp(prepared.scales_log) * cfg.splat_scale
    d = proj.depth if depth is None else depth
    return jnp.stack([
        prepared.means[:, 0], prepared.means[:, 1], prepared.means[:, 2],
        pack2bf16(scl[:, 0], scl[:, 1]),
        pack2bf16(scl[:, 2], quats[:, 0]),
        pack2bf16(quats[:, 1], quats[:, 2]),
        pack2bf16(quats[:, 3], d),
        pack2bf16(proj.color[:, 0], proj.color[:, 1]),
        pack_bf16_u16(proj.color[:, 2], proj.alpha),
        d,           # GUTP_SORTD (exact blend-order key + aux depth pick)
        _id_row(n),  # GUTP_ID
    ], axis=0)


def raster_statics(cfg: RenderConfig) -> RasterStatics:
    from vk_gaussian_splatting_tpu.config import StochasticMode
    # ANYHIT's binary accept with first-accepted-hit termination
    # (rgen:821-961) is the SPLAT estimator in a sorted FTB loop: the first
    # accepted splat saturates transmittance, so later accepts contribute
    # nothing — the single-trace variant is a GPU traversal optimization,
    # not a different estimator.
    stoch = cfg.stochastic in (StochasticMode.SPLAT, StochasticMode.ANYHIT)
    return RasterStatics(
        tiles_x=tiles_x(cfg),
        tiles_y=tiles_y(cfg),
        chunk=cfg.raster.chunk,
        alpha_min=cfg.raster.alpha_min,
        alpha_clamp=cfg.raster.alpha_clamp,
        qmax=cfg.raster.alpha_cull_qmax,
        depth_iso=cfg.raster.depth_iso_threshold,
        stochastic=stoch,
    )


def _gut_statics(st: RasterStatics, cfg: RenderConfig, packed: bool,
                 **kw) -> RasterStatics:
    """gut3d kernel statics: response model, generalized-Gaussian degree, and
    the degree-0 support cull from rt.kernel_scale_deg0."""
    from vk_gaussian_splatting_tpu.ops.raytrace import _deg0_min_response
    return dataclasses.replace(
        st, model="gut3dp" if packed else "gut3d",
        kernel_degree=cfg.rt.kernel_degree,
        kernel_min_response=max(st.kernel_min_response,
                                _deg0_min_response(cfg.rt)), **kw)


def bin_for_cfg(proj, rows, cfg: RenderConfig, max_pairs: int,
                depth_override=None) -> TileBins:
    if depth_override is not None:
        proj = dataclasses.replace(proj, depth=depth_override)
    exact = cfg.raster.expansion == "exact"
    return bin_splats(
        proj, rows,
        tile_size=cfg.raster.tile_size,
        tiles_x=tiles_x(cfg), tiles_y=tiles_y(cfg),
        slots_k=cfg.raster.slots_k,
        max_pairs=max_pairs if exact else 0,
        expansion=cfg.raster.expansion,
        # only the gs2d layout carries wide (lo, hi) id rows; its 12-row
        # count is unique among the layouts (NUM_ROWS, ops/response.py)
        wide_id=rows.shape[0] == 12,
    )


@partial(jax.jit, static_argnames=("cfg", "max_pairs"))
def render_3dgs(
    prepared: PreparedSplats,
    cam: Camera,
    cfg: RenderConfig,
    max_pairs: int = 0,
    host_order: jax.Array | None = None,
) -> RenderOutput:
    """3DGS raster pipeline (PIPELINE_VERT / PIPELINE_MESH).

    host_order: optional (N,) i32 presorted splat permutation from the CPU
    sorting path (SortMethod.HOST parity; may be one camera-move stale like
    the reference's lazy CPU sort)."""
    if cfg.raster.tile_size != 16:
        raise ValueError("the tile blender requires tile_size == 16")
    proj = project_splats(prepared, cam, cfg)
    depth_override = None
    if host_order is not None:
        n = host_order.shape[0]
        depth_override = jnp.zeros((n,), jnp.float32).at[host_order].set(
            jnp.arange(n, dtype=jnp.float32))
    packed = cfg.raster.pair_format == "packed"
    rows = gs_attr_rows_packed(proj) if packed else gs_attr_rows(proj)
    st = raster_statics(cfg)
    if packed:
        st = dataclasses.replace(st, model="gs2dp")
    samples = max(cfg.temporal_samples, 1) if st.stochastic else 1
    bins = bin_for_cfg(proj, rows, cfg, max_pairs, depth_override)
    img = trans = depth = splat_id = None
    for sample in range(samples):
        seed = jnp.full((1,), sample * 7919 + 1, jnp.int32)
        out = rasterize_bins(bins, None, seed, st)
        res = assemble_image(out, st.tiles_x, st.tiles_y,
                             cfg.width, cfg.height, cfg.background,
                             with_aux=True)
        img = res[0] if img is None else img + res[0]
        trans = res[1] if trans is None else trans + res[1]
        if depth is None:
            depth, splat_id = res[2], res[3]
    return _maybe_denoise(RenderOutput(
        image=img / samples if samples > 1 else img,
        transmittance=trans / samples if samples > 1 else trans,
        depth=depth, splat_id=splat_id,
        num_pairs=bins.num_pairs, overflow=bins.overflow,
    ), cfg)


def _maybe_denoise(out: "RenderOutput", cfg: RenderConfig) -> "RenderOutput":
    """Post-accumulation guided denoise (the DLSS-RR capability slot):
    cfg.denoise="atrous" filters the blended image with the renderer's own
    guide buffers (ops/denoise.py); aux buffers pass through."""
    if cfg.denoise != "atrous":
        return out
    from vk_gaussian_splatting_tpu.ops.denoise import atrous_denoise
    return dataclasses.replace(
        out, image=atrous_denoise(out.image, out.depth, out.splat_id,
                                  out.transmittance))


def _blend_samples(bins: TileBins, cam, cfg, st):
    """Average the blend over temporal samples (DoF/stochastic); aux picks
    from the first sample (post.comp.slang temporal accumulation)."""
    from vk_gaussian_splatting_tpu.render.rays import build_tile_rays

    samples = max(cfg.temporal_samples, 1)
    img_acc = trans_acc = depth = splat_id = None
    for sample in range(samples):
        pix_ctx = build_tile_rays(cam, cfg, sample_id=sample)
        seed = jnp.full((1,), sample * 7919 + 1, jnp.int32)
        out = rasterize_bins(bins, pix_ctx, seed, st)
        img, trans, d, sid = assemble_image(
            out, st.tiles_x, st.tiles_y,
            cfg.width, cfg.height, cfg.background, with_aux=True)
        img_acc = img if img_acc is None else img_acc + img
        trans_acc = trans if trans_acc is None else trans_acc + trans
        if depth is None:
            depth, splat_id = d, sid
    return img_acc / samples, trans_acc / samples, depth, splat_id


@partial(jax.jit, static_argnames=("cfg", "max_pairs"))
def render_3dgut(
    prepared: PreparedSplats,
    cam: Camera,
    cfg: RenderConfig,
    max_pairs: int = 0,
) -> RenderOutput:
    """3DGUT raster pipeline (PIPELINE_MESH_3DGUT): unscented-transform
    projection for binning + exact per-pixel 3D ray response in the blender,
    with thin-lens DoF and temporal-sample averaging."""
    if cfg.raster.tile_size != 16:
        raise ValueError("the tile blender requires tile_size == 16")
    proj = ut_project_splats(prepared, cam, cfg)
    packed = cfg.raster.pair_format == "packed"
    rows = (gut_attr_rows_packed if packed else gut_attr_rows)(
        prepared, proj, cfg)
    st = _gut_statics(raster_statics(cfg), cfg, packed)
    bins = bin_for_cfg(proj, rows, cfg, max_pairs)
    img, trans, depth, splat_id = _blend_samples(bins, cam, cfg, st)
    return _maybe_denoise(RenderOutput(
        image=img, transmittance=trans, depth=depth, splat_id=splat_id,
        num_pairs=bins.num_pairs, overflow=bins.overflow), cfg)


@partial(jax.jit, static_argnames=("cfg", "max_pairs"))
def render_3dgrt(
    prepared: PreparedSplats,
    cam: Camera,
    cfg: RenderConfig,
    max_pairs: int = 0,
) -> RenderOutput:
    """3DGRT ray tracing, primary rays (PIPELINE_RTX).

    The reference marches BVH hits through a K=18 sorted k-buffer per pass
    (rgen:615-818) purely to recover per-ray front-to-back order. Sorting
    candidates by euclidean distance to the shared ray origin reproduces that
    order exactly for splat centers (44 dB vs an exact per-ray-t oracle on
    adversarial scenes), so the tile blender composes the same integral
    particleIntegrate accumulates — no BVH, no k-buffer. Also correct under
    fisheye (raster view-z ordering is not)."""
    if cfg.raster.tile_size != 16:
        raise ValueError("the tile blender requires tile_size == 16")
    proj = ut_project_splats(prepared, cam, cfg)
    radial = jnp.linalg.norm(prepared.means - cam.position, axis=-1)
    packed = cfg.raster.pair_format == "packed"
    st = _gut_statics(raster_statics(cfg), cfg, packed,
                      alpha_clamp=cfg.rt.alpha_clamp,
                      min_transmittance=cfg.rt.min_transmittance)
    rows = (gut_attr_rows_packed if packed else gut_attr_rows)(
        prepared, proj, cfg)
    bins = bin_for_cfg(proj, rows, cfg, max_pairs, depth_override=radial)
    img, trans, depth, splat_id = _blend_samples(bins, cam, cfg, st)
    return _maybe_denoise(RenderOutput(
        image=img, transmittance=trans, depth=depth, splat_id=splat_id,
        num_pairs=bins.num_pairs, overflow=bins.overflow), cfg)


@partial(jax.jit, static_argnames=("cfg", "ray_block", "chunk"))
def render_3dgrt_exact(
    prepared: PreparedSplats,
    cam: Camera,
    cfg: RenderConfig,
    ray_block: int = 4096,
    chunk: int = 512,
) -> RenderOutput:
    """3DGRT primaries in EXACT per-ray-t order — the strict-science tier.

    render_3dgrt's radial order is exact for splat CENTERS from a shared
    origin (validated at 44 dB on adversarial scenes), but offers no strict
    fallback for comparisons that demand the reference's literal k-buffer
    semantics. This tier marches every pixel ray through
    ops/raytrace.trace_splats with the windowed global-t-slab order — the
    tMin-advance of rgen:676-818, exact per ray — at trace cost
    (rt.max_passes slabs per ray; no tile raster). Aux picks: iso-depth per
    ray (rgen:728-741); splat-id pick is not produced on this path (-1)."""
    from vk_gaussian_splatting_tpu.ops.raytrace import trace_splats

    h, w = cfg.height, cfg.width
    ys, xs = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32) + 0.5,
                          jnp.arange(w, dtype=jnp.float32) + 0.5,
                          indexing="ij")
    d_cam = jnp.stack([(xs - cam.cx) / cam.fx, (ys - cam.cy) / cam.fy,
                       jnp.ones_like(xs)], -1)
    d_cam = d_cam / jnp.linalg.norm(d_cam, axis=-1, keepdims=True)
    flat_d = d_cam.reshape(-1, 3) @ cam.viewmat[:3, :3]
    flat_o = jnp.broadcast_to(cam.position, flat_d.shape)
    res = trace_splats(
        prepared, flat_o, flat_d,
        jnp.zeros(flat_d.shape[0]), jnp.full(flat_d.shape[0], jnp.inf),
        cfg, chunk=chunk, ray_block=ray_block, order="windowed")
    img = res.radiance.reshape(h, w, 3)
    trans = res.transmittance.reshape(h, w)
    bg = jnp.asarray(cfg.background, jnp.float32)
    return RenderOutput(
        image=img + trans[..., None] * bg, transmittance=trans,
        depth=res.depth.reshape(h, w),
        splat_id=jnp.full((h, w), -1, jnp.int32),
        num_pairs=jnp.int32(prepared.means.shape[0]),
        overflow=jnp.bool_(False))


def _set_index_for(material, splat_id, instance_base):
    """(H,W) i32 per-pixel set index when `material` is per-set (a tuple),
    else None — the global-index-table material routing of
    deferred_shading.comp.slang:107-124."""
    from vk_gaussian_splatting_tpu.render.deferred import (
        DeferredMaterial,
        instance_index_image,
    )
    if isinstance(material, DeferredMaterial):
        return None
    if not instance_base:
        raise ValueError("per-set materials need instance_base (the "
                         "GlobalIndexTable.instance_base offsets)")
    return instance_index_image(splat_id, instance_base)


@partial(jax.jit, static_argnames=("cfg", "max_pairs", "material",
                                  "instance_base"))
def render_3dgs_lit(
    prepared: PreparedSplats,
    cam: Camera,
    cfg: RenderConfig,
    max_pairs: int = 0,
    lights: tuple = (),
    material=None,
    instance_base: tuple = (),
):
    """3DGS raster + surface reconstruction + deferred Phong shading
    (the raster-with-lighting frame of gaussian_splatting.cpp:888-908 + S11).

    material: one DeferredMaterial, or a tuple of them (one per instance,
    routed per pixel through the splat_id pick + instance_base — the
    global-index-table lookup of deferred_shading.comp.slang:107-124).
    Returns (RenderOutput, shaded_image, normal_image)."""
    from vk_gaussian_splatting_tpu.render.deferred import (
        DeferredMaterial,
        deferred_shade,
        render_normal_buffer,
    )

    if material is None:
        material = DeferredMaterial()
    proj = project_splats(prepared, cam, cfg)
    bins = bin_for_cfg(proj, gs_attr_rows(proj), cfg, max_pairs)
    st = raster_statics(cfg)
    out = rasterize_bins(bins, None, None, st)
    img, trans, depth, splat_id = assemble_image(
        out, st.tiles_x, st.tiles_y,
        cfg.width, cfg.height, cfg.background, with_aux=True)
    normal_img = render_normal_buffer(prepared, proj, cam, cfg, st,
                                      max_pairs)
    shaded = deferred_shade(img, trans, normal_img, depth, cam, cfg,
                            list(lights), material,
                            set_index_img=_set_index_for(
                                material, splat_id, instance_base))
    render_out = RenderOutput(image=img, transmittance=trans, depth=depth,
                              splat_id=splat_id, num_pairs=bins.num_pairs,
                              overflow=bins.overflow)
    return render_out, shaded, normal_img


@partial(jax.jit, static_argnames=("cfg", "max_pairs"))
def render_3dgs_composed(
    prepared: PreparedSplats,
    cam: Camera,
    cfg: RenderConfig,
    max_pairs: int = 0,
    mesh=None,
    lights: tuple = (),
) -> RenderOutput:
    """3DGS raster composited with an opaque triangle mesh (the FTB
    mesh-composited frame, gaussian_splatting.cpp:705-850): mesh depth
    prepass -> splat FTB pass clipped by mesh depth -> mesh color under the
    remaining transmittance."""
    from vk_gaussian_splatting_tpu.render.mesh_raster import (
        depth_limit_pix_ctx,
        render_mesh,
    )

    mesh_img, mesh_trans, mesh_depth, _ = render_mesh(
        mesh, cam, cfg, max_pairs, lights)

    proj = project_splats(prepared, cam, cfg)
    bins = bin_for_cfg(proj, gs_attr_rows(proj), cfg, max_pairs)
    st = dataclasses.replace(raster_statics(cfg),
                             model="gs2d_clip")
    pix_ctx = depth_limit_pix_ctx(mesh_depth, cfg)
    out = rasterize_bins(bins, pix_ctx, None, st)
    img, trans, depth, splat_id = assemble_image(
        out, st.tiles_x, st.tiles_y, cfg.width, cfg.height,
        (0.0, 0.0, 0.0), with_aux=True)

    final = img + trans[..., None] * mesh_img
    covered_mesh = mesh_trans < 0.5
    combined_depth = jnp.where((depth == 0) & covered_mesh, mesh_depth, depth)
    return RenderOutput(
        image=final,
        transmittance=trans * mesh_trans,
        depth=combined_depth,
        splat_id=splat_id,
        num_pairs=bins.num_pairs,
        overflow=bins.overflow,
    )


@partial(jax.jit, static_argnames=("cfg", "max_pairs", "material",
                                  "instance_base", "shadow_res"))
def render_hybrid(
    prepared: PreparedSplats,
    cam: Camera,
    cfg: RenderConfig,
    max_pairs: int = 0,
    lights: tuple = (),
    material=None,
    instance_base: tuple = (),
    shadow_res: int = 512,
):
    """Hybrid pipeline (PIPELINE_HYBRID / PIPELINE_HYBRID_3DGUT): raster
    primary visibility + deferred lighting with per-light deep-shadow-map
    transmittance (render/shadows.py) — the raster+RT-secondary structure of
    rgen:343-460/1261-1464 with light-space rendering standing in for per-ray
    marching. Returns (RenderOutput, shaded image, normal image)."""
    from vk_gaussian_splatting_tpu.render.deferred import (
        DeferredMaterial,
        deferred_shade,
        render_normal_buffer,
    )
    from vk_gaussian_splatting_tpu.render.rays import build_tile_rays
    from vk_gaussian_splatting_tpu.render.shadows import (
        make_ray_shadow_fn,
        make_shadow_fn,
    )

    if material is None:
        material = DeferredMaterial()
    use_gut = cfg.pipeline == Pipeline.HYBRID_3DGUT

    if use_gut:
        proj = ut_project_splats(prepared, cam, cfg)
        rows = gut_attr_rows(prepared, proj, cfg)
    else:
        proj = project_splats(prepared, cam, cfg)
        rows = gs_attr_rows(proj)
    bins = bin_for_cfg(proj, rows, cfg, max_pairs)
    st = raster_statics(cfg)
    if use_gut:
        st = _gut_statics(st, cfg, packed=False)
        pix_ctx = build_tile_rays(cam, cfg, sample_id=0)
    else:
        pix_ctx = None
    out = rasterize_bins(bins, pix_ctx, None, st)
    img, trans, depth, splat_id = assemble_image(
        out, st.tiles_x, st.tiles_y, cfg.width, cfg.height,
        cfg.background, with_aux=True)

    normal_img = render_normal_buffer(prepared, proj, cam, cfg, st,
                                      max_pairs, pix_ctx,
                                      use_gut_rows=use_gut)
    if not lights:
        shadow_fn = None
    elif cfg.rt.shadows == "ray":
        shadow_fn = make_ray_shadow_fn(prepared, cfg)
    else:
        shadow_fn = make_shadow_fn(prepared, tuple(lights), cfg, shadow_res)
    shaded = deferred_shade(img, trans, normal_img, depth, cam, cfg,
                            list(lights), material, shadow_fn=shadow_fn,
                            set_index_img=_set_index_for(
                                material, splat_id, instance_base))
    render_out = RenderOutput(image=img, transmittance=trans, depth=depth,
                              splat_id=splat_id, num_pairs=bins.num_pairs,
                              overflow=bins.overflow)
    return render_out, shaded, normal_img


@partial(jax.jit, static_argnames=("cfg", "max_pairs", "max_bounces",
                                   "stride"))
def render_composed_wavefront(
    prepared: PreparedSplats,
    cam: Camera,
    cfg: RenderConfig,
    max_pairs: int = 0,
    mesh=None,
    lights: tuple = (),
    max_bounces: int | None = None,
    stride: int = 1,
    shadow_fn=None,
):
    """Splat/mesh composite + wavefront secondary bounces: pixels whose mesh
    face is reflective (illum 1) or refractive (illum>=2) continue as a
    secondary ray batch traced against meshes + splats (render/wavefront.py —
    the reflect/refract bounce loop of rgen:244-337 on the raster primary
    pass). Returns (RenderOutput, image-with-bounces)."""
    from vk_gaussian_splatting_tpu.render.mesh_raster import (
        depth_limit_pix_ctx,
        render_mesh,
    )
    from vk_gaussian_splatting_tpu.render.wavefront import (
        add_secondary_radiance,
        secondary_spawn,
        trace_secondary,
    )

    mesh_img, mesh_trans, mesh_depth, fid = render_mesh(
        mesh, cam, cfg, max_pairs, lights)

    proj = project_splats(prepared, cam, cfg)
    bins = bin_for_cfg(proj, gs_attr_rows(proj), cfg, max_pairs)
    st = dataclasses.replace(raster_statics(cfg),
                             model="gs2d_clip")
    pix_ctx = depth_limit_pix_ctx(mesh_depth, cfg)
    out = rasterize_bins(bins, pix_ctx, None, st)
    img, trans, depth, splat_id = assemble_image(
        out, st.tiles_x, st.tiles_y, cfg.width, cfg.height,
        (0.0, 0.0, 0.0), with_aux=True)

    base = img + trans[..., None] * mesh_img
    covered_mesh = mesh_trans < 0.5
    combined_depth = jnp.where((depth == 0) & covered_mesh, mesh_depth, depth)
    render_out = RenderOutput(
        image=base, transmittance=trans * mesh_trans, depth=combined_depth,
        splat_id=splat_id, num_pairs=bins.num_pairs, overflow=bins.overflow)

    origins, dirs, throughput, _, shape_lr = secondary_spawn(
        cam, cfg, mesh, fid.astype(jnp.int32), trans, stride)
    radiance = trace_secondary(prepared, cam, cfg, mesh, origins, dirs,
                               throughput, lights, shadow_fn, max_bounces)
    final = add_secondary_radiance(base, radiance, shape_lr, cfg)
    return render_out, final


def render(prepared: PreparedSplats, cam: Camera, cfg: RenderConfig,
           max_pairs: int = 0, **kw) -> RenderOutput:
    """Pipeline dispatch (shaderio.h:61-66 pipeline ids)."""
    if cfg.pipeline in (Pipeline.VERT, Pipeline.MESH):
        return render_3dgs(prepared, cam, cfg, max_pairs, **kw)
    if cfg.pipeline == Pipeline.MESH_3DGUT:
        return render_3dgut(prepared, cam, cfg, max_pairs, **kw)
    if cfg.pipeline == Pipeline.RTX:
        return render_3dgrt(prepared, cam, cfg, max_pairs, **kw)
    if cfg.pipeline in (Pipeline.HYBRID, Pipeline.HYBRID_3DGUT):
        return render_hybrid(prepared, cam, cfg, max_pairs, **kw)[0]
    raise NotImplementedError(f"pipeline {cfg.pipeline} not yet implemented")
