"""Tile blender: the chunk math both blenders share, the choice of blender
for the backend, and image assembly.

The counterpart of the reference's raster pipelines (mesh shaders S3/S7 +
fragment blends S5). Binning (ops/binning.py) sorts (splat, tile) pairs by
(tile, depth): tile t owns the contiguous segment
[seg_starts[t], seg_starts[t] + seg_counts[t]) of the (R, P) attribute
array. A blender walks each tile's segment front to back in chunks of
``st.chunk`` pairs over all 256 pixels of the tile at once ((256, C)
arrays), and stops when, at the start of a chunk, every pixel's
transmittance is at or below ``st.min_transmittance`` (the FTB early-out of
threedgs_raster.frag.slang:299-346; the sorted loop is deterministic — no
fragment interlock). Pixels of a still-running tile keep blending, so the
image departs from a blend of every pair only in tiles that went opaque.

Two blenders implement that walk over the same TileBins:

- ops/rasterize_triton.py — one Pallas-Triton program per tile; the GPU
  path;
- ops/rasterize_xla.py — plain jnp/lax over all tiles at once; the CPU path
  and the full-size reference the kernel is checked against.

Both call the per-chunk functions below (``blend_chunk``, ``grad_chunk``),
so they differ only in how a chunk is loaded and stored, in how the
exclusive transmittance product is formed (``prefix`` argument), and in how
a finished tile stops (the kernel leaves its loop; the XLA blender masks
the tile's lanes).

Backward (both blenders): one forward-order sweep per tile. With
S_total = rgb_out . g_rgb from the saved forward output, the back-to-front
gradient walk becomes a prefix sum: for pair k with transmittance T_k in
front of it,

    dL/dalpha_k = T_k cg_k - (S_total - S_incl_k + g_T T_final) / (1 - alpha_k)

where cg_k = color_k . g_rgb and S_incl_k = sum_{j<=k} alpha_j T_j cg_j.
Response gradients come from ``jax.vjp`` of the model's alpha function, so
a new response model gets gradients for free. Each pair belongs to exactly
one tile, so each tile writes its own pairs' gradient columns.

Output per tile: (8, 256) block — rows 0-2 rgb, row 3 transmittance,
rows 4-6 picked depth and splat id (lo, hi); or rows 4-7 the four multi-iso
depths of a deep shadow map.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from vk_gaussian_splatting_tpu.ops.response import (
    ALPHA_FNS,
    ATTR_B,
    ATTR_R,
    COLOR_FNS,
    DEPTH_FNS,
    DEPTH_ROW,
    ID_HI_ROW,
    ID_ROW,
    PIXEL_COLOR_FNS,
    PIXEL_DEPTH_FNS,
    USES_PIX_CTX,
)

TILE = 16
PIX = TILE * TILE  # 256 pixels per tile
OUT_COLS = 8       # rgb, T, 4 aux
PIX_ROWS = 7       # pixel-context rows read by the response models
_NO_PICK = 1e30
_BIG_LANE = 1 << 20


@dataclasses.dataclass(frozen=True)
class RasterStatics:
    """Hashable static parameters baked into the blender (the jit-cache key)."""

    tiles_x: int
    tiles_y: int
    chunk: int = 16                # pairs per blend step (power of two)
    alpha_min: float = 1.0 / 255.0
    alpha_clamp: float = 0.999
    qmax: float = 8.0
    min_transmittance: float = 1e-4
    model: str = "gs2d"            # response model (ops/response.py)
    kernel_degree: int = 2         # gut3d generalized-gaussian degree
    kernel_min_response: float = 0.0113
    depth_iso: float = 0.7         # depth-pick transmittance threshold
    stochastic: bool = False       # STOCHASTIC_SPLAT (frag.slang:265-290)
    multi_iso: bool = False        # 4 depth picks -> deep shadow map rows 4-7
    iso_thresholds: tuple = (0.75, 0.5, 0.25, 0.05)


def tile_pixel_coords(t, tiles_x: int):
    """Pixel-centre coordinates (x, y) of tile t as two (256,) vectors."""
    pix = jax.lax.iota(jnp.int32, PIX)
    ty = t // tiles_x
    tx = t - ty * tiles_x
    px = (tx * TILE + pix % TILE).astype(jnp.float32) + 0.5
    py = (ty * TILE + pix // TILE).astype(jnp.float32) + 0.5
    return px, py


def hash_uniform(seed, pos) -> jax.Array:
    """(256, C) uniforms in [0,1) from (seed, pixel in tile, pair position)
    via an xxhash32-flavoured integer mix. Integer ALU only, so the stream
    is identical in the Triton kernel, its interpreter and the XLA blender,
    and does not depend on the chunk size."""
    pixv = jax.lax.broadcasted_iota(jnp.int32, (PIX, 1), 0).astype(jnp.uint32)
    lanev = pos.astype(jnp.uint32)
    h = (pixv * jnp.uint32(0x9E3779B1)
         ^ lanev * jnp.uint32(0x85EBCA77)
         ^ (seed.astype(jnp.uint32) * jnp.uint32(0xC2B2AE3D)))
    h = h ^ (h >> 15)
    h = h * jnp.uint32(0x2C1B3C6D)
    h = h ^ (h >> 12)
    h = h * jnp.uint32(0x297A2D39)
    h = h ^ (h >> 15)
    return (h >> 8).astype(jnp.int32).astype(jnp.float32) * jnp.float32(
        1.0 / (1 << 24))


def exact_prefix(q):
    """(exclusive, inclusive) products of q along the chunk axis, exact f32
    (the XLA blender's form)."""
    incl = jnp.cumprod(q, axis=-1)
    excl = jnp.concatenate([jnp.ones_like(q[..., :1]), incl[..., :-1]],
                           axis=-1)
    return excl, incl


def log_prefix(q):
    """(exclusive, inclusive) products of q as exp(cumsum(log q)) — the
    Triton form: that route lowers a forward cumsum but no cumulative
    product and no value slice. Relative error of a product over a chunk
    of C factors is about C * 6e-8 * max|log q| (<= 1.3e-5 for C = 32 at
    the 0.999 alpha clamp). q is floored at 1e-30 so an opaque pair
    (alpha = 1) leaves T = 1e-30 instead of 0."""
    lq = jnp.log(jnp.maximum(q, 1e-30))
    cs = jnp.cumsum(lq, axis=-1)
    return jnp.exp(cs - lq), jnp.exp(cs)


def chunk_alpha(st: RasterStatics, rows, pix, px, py, pos, live, seed):
    """(256, C) alpha of one chunk. rows: (1, C) per attribute row; pix:
    (256,) per pixel-context row or None; px, py: (256,); pos: (C,) pair
    positions; live: (C,) pairs of this tile."""
    pixc = None if pix is None else tuple(c[:, None] for c in pix)
    alpha = ALPHA_FNS[st.model](rows, pixc, px[:, None], py[:, None],
                                live[None, :], st)
    if st.stochastic:
        # STOCHASTIC_SPLAT: binary accept with p = alpha; accepted splats
        # become opaque (threedgs_raster.frag.slang:265-290).
        u = hash_uniform(seed, pos[None, :])
        alpha = jnp.where((u < alpha) & (alpha > 0.0), 1.0, 0.0)
    return alpha


def tile_running(k, chunk, seg_counts, tc, min_transmittance):
    """Tiles that blend chunk k: pairs left, and a pixel above
    min_transmittance (tc: (..., 256) transmittance at the chunk's start)."""
    return (k * chunk < seg_counts) & (jnp.max(tc, axis=-1)
                                       > min_transmittance)


def init_state():
    """Per-tile blend state: ten (256,) columns — rgb accumulators, T, four
    picked depths (1e30 = unpicked), picked id (lo, hi); unpicked id
    (-1, 0) reconstructs to -1."""
    zero = jnp.zeros((PIX,), jnp.float32)
    one = jnp.ones((PIX,), jnp.float32)
    none = jnp.full((PIX,), _NO_PICK, jnp.float32)
    return (zero, zero, zero, one, none, none, none, none, -one, zero)


def blend_chunk(st: RasterStatics, state, rows, pix, px, py, pos, live,
                seed, prefix):
    """Blend one chunk of a tile's segment into its state, front to back."""
    acc_r, acc_g, acc_b, tc = state[:4]
    picks = list(state[4:])
    alpha = chunk_alpha(st, rows, pix, px, py, pos, live, seed)
    excl, incl = prefix(1.0 - alpha)
    w = alpha * (tc[:, None] * excl)                         # (256, C)
    if st.model in PIXEL_COLOR_FNS:
        # per-pixel interpolated colors (tri2d_smooth Gouraud)
        cols = PIXEL_COLOR_FNS[st.model](rows, px[:, None], py[:, None])
    elif st.model in COLOR_FNS:
        cols = COLOR_FNS[st.model](rows)
    else:
        cols = [rows[ATTR_R], rows[ATTR_R + 1], rows[ATTR_B]]
    # per-channel f32 reductions: a (256,C)x(C,3) dot would run in TF32
    # and N=3 is smaller than a tensor-core tile
    acc = [a + jnp.sum(w * c, axis=1) for a, c in zip((acc_r, acc_g, acc_b),
                                                      cols)]

    # depth picking at the iso thresholds (threedgs_raster.frag.slang:
    # 325-346); multi_iso records the deep-shadow-map staircase instead of
    # (depth, id)
    t_after = tc[:, None] * incl                              # (256, C)
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, st.chunk), 1)
    if st.model in PIXEL_DEPTH_FNS:
        depth_row = PIXEL_DEPTH_FNS[st.model](rows, px[:, None], py[:, None])
    elif st.model in DEPTH_FNS:
        depth_row = DEPTH_FNS[st.model](rows)
    else:
        depth_row = rows[DEPTH_ROW[st.model]]
    thresholds = st.iso_thresholds if st.multi_iso else (st.depth_iso,)
    for i, thr in enumerate(thresholds):
        cond = (t_after < thr) & (alpha > 0.0)
        first = jnp.min(jnp.where(cond, lane, _BIG_LANE), axis=1)
        sel = (lane == first[:, None]) & cond
        upd = (first < _BIG_LANE) & (picks[i] > 1e29)
        picks[i] = jnp.where(
            upd, jnp.sum(jnp.where(sel, depth_row, 0.0), axis=1), picks[i])
        if i == 0 and not st.multi_iso:
            id_rows = [ID_ROW[st.model], ID_HI_ROW.get(st.model)]
            for j, r in enumerate(id_rows):
                if r is not None:
                    picks[4 + j] = jnp.where(
                        upd, jnp.sum(jnp.where(sel, rows[r], 0.0), axis=1),
                        picks[4 + j])
    return (*acc, jnp.min(t_after, axis=1), *picks)


def output_columns(st: RasterStatics, state):
    """The eight (256,) output rows of a finished tile."""
    picks = state[4:]
    depths = [jnp.where(d > 1e29, 0.0, d) for d in picks[:4]]
    if st.multi_iso:
        aux = depths
    else:
        aux = [depths[0], picks[4], picks[5], jnp.zeros_like(depths[0])]
    return (*state[:4], *aux)


def grad_chunk(st: RasterStatics, carry, ctx, rows, pix, px, py, pos, live,
               seed, prefix):
    """One chunk of the backward sweep. carry: (T, S_run) (256,) columns;
    ctx: (g_r, g_g, g_b, S_total, g_T * T_final) (256,) columns. Returns
    (carry, d_rows) with d_rows one (1, C) gradient per attribute row."""
    tc, s_run = carry
    g_r, g_g, g_b, s_total, gt_tn = ctx

    def alpha_f(rs):
        return chunk_alpha(st, rs, pix, px, py, pos, live, seed)

    alpha, alpha_vjp = jax.vjp(alpha_f, tuple(rows))
    q = 1.0 - alpha
    excl, incl = prefix(q)
    t_k = tc[:, None] * excl
    w = alpha * t_k
    g_rgb = (g_r[:, None], g_g[:, None], g_b[:, None])
    cols = (rows[ATTR_R], rows[ATTR_R + 1], rows[ATTR_B])
    cg = g_rgb[0] * cols[0] + g_rgb[1] * cols[1] + g_rgb[2] * cols[2]
    wcg = w * cg
    s_incl = s_run[:, None] + jnp.cumsum(wcg, axis=1)
    suffix = s_total[:, None] - s_incl
    qsafe = jnp.maximum(q, 1.0 - st.alpha_clamp)
    dalpha = t_k * cg - (suffix + gt_tn[:, None]) / qsafe
    d_rows = list(alpha_vjp(dalpha)[0])
    for ch in range(3):
        d_rows[ATTR_R + ch] = d_rows[ATTR_R + ch] + jnp.sum(
            g_rgb[ch] * w, axis=0, keepdims=True)
    carry = (jnp.min(tc[:, None] * incl, axis=1),
             s_run + jnp.sum(wcg, axis=1))
    return carry, d_rows


def check_differentiable(st: RasterStatics):
    if st.model in COLOR_FNS or st.model in PIXEL_COLOR_FNS:
        # packed layouts carry bit patterns; interpolated-attribute mesh
        # models are a compositing prepass — neither is differentiated
        raise NotImplementedError(
            "this response model is forward-only; use pair_format='f32' "
            "splat models for training")


def bwd_context(out: jax.Array, g: jax.Array) -> jax.Array:
    """(T, 5, 256) per-tile backward context from the saved forward output
    and its cotangent: g_rgb, S_total = rgb_out . g_rgb, g_T * T_final."""
    g_rgb = g[:, 0:3, :]
    s_total = jnp.sum(out[:, 0:3, :] * g_rgb, axis=1, keepdims=True)
    gt_tn = g[:, 3:4, :] * out[:, 3:4, :]
    return jnp.concatenate([g_rgb, s_total, gt_tn], axis=1)


def make_blender(fwd, bwd):
    """Wrap a blender's forward (attrs, seg_starts, seg_counts, pix_ctx,
    seed, st) -> (T, 8, 256) and its backward (..., ctx, st) -> d_attrs
    into one differentiable function with the shared custom VJP."""

    @partial(jax.custom_vjp, nondiff_argnums=(5,))
    def blend(attrs, seg_starts, seg_counts, pix_ctx, seed, st):
        return fwd(attrs, seg_starts, seg_counts, pix_ctx, seed, st)

    def blend_fwd(attrs, seg_starts, seg_counts, pix_ctx, seed, st):
        out = fwd(attrs, seg_starts, seg_counts, pix_ctx, seed, st)
        return out, (attrs, seg_starts, seg_counts, pix_ctx, seed, out)

    def blend_bwd(st, res, g):
        check_differentiable(st)
        attrs, seg_starts, seg_counts, pix_ctx, seed, out = res
        d_attrs = bwd(attrs, seg_starts, seg_counts, pix_ctx, seed,
                      bwd_context(out, g), st)
        # only live pairs [0, end of the last segment) carry gradients
        end = seg_starts[-1] + seg_counts[-1]
        live = jnp.arange(attrs.shape[1], dtype=jnp.int32) < end
        d_attrs = jnp.where(live[None, :], d_attrs, 0.0)
        f0 = lambda a: np.zeros(a.shape, dtype=jax.dtypes.float0)
        d_pix = None if pix_ctx is None else jnp.zeros_like(pix_ctx)
        return (d_attrs, f0(seg_starts), f0(seg_counts), d_pix, f0(seed))

    blend.defvjp(blend_fwd, blend_bwd)
    return blend


def select_blender(backend: str | None = None):
    """The tile blender for a JAX backend: the Triton kernel on the GPU, the
    XLA blender on the CPU. Any other backend is an error."""
    backend = backend or jax.default_backend()
    if backend == "gpu":
        from vk_gaussian_splatting_tpu.ops import rasterize_triton
        return rasterize_triton.blender()
    if backend == "cpu":
        from vk_gaussian_splatting_tpu.ops import rasterize_xla
        return rasterize_xla.rasterize_tiles
    raise ValueError(f"no tile blender for backend {backend!r}")


def rasterize_bins(bins, pix_ctx, seed, st: RasterStatics, blender=None):
    """Blend a TileBins into (T, 8, 256) tile blocks.

    pix_ctx: (T, 8, 256) per-tile pixel context (gut3d / clip models) or
    None. seed: (1,) i32 stochastic sample seed or None. blender: one of the
    two blenders' ``rasterize_tiles``; default: select_blender()."""
    if seed is None:
        seed = jnp.zeros((1,), jnp.int32)
    if not USES_PIX_CTX[st.model]:
        pix_ctx = None
    blender = blender or select_blender()
    return blender(bins.attrs, bins.seg_starts, bins.seg_counts, pix_ctx,
                   seed, st)


def assemble_image(out: jax.Array, tiles_x: int, tiles_y: int,
                   width: int, height: int, background=(0.0, 0.0, 0.0),
                   with_aux: bool = False):
    """(T, 8, 256) tile blocks -> (H, W, 3) image + (H, W) transmittance
    (+ picked depth and splat id when with_aux)."""
    blocks = out.reshape(tiles_y, tiles_x, OUT_COLS, TILE, TILE)
    full = blocks.transpose(0, 3, 1, 4, 2).reshape(
        tiles_y * TILE, tiles_x * TILE, OUT_COLS
    )
    rgb = full[:height, :width, 0:3]
    trans = full[:height, :width, 3]
    bg = jnp.asarray(background, jnp.float32)
    img = rgb + trans[..., None] * bg
    if not with_aux:
        return img, trans
    depth = full[:height, :width, 4]
    # wide-id layouts carry (lo, hi) in rows 5-6 (id = hi * 4096 + lo);
    # single-row layouts leave row 6 zero, so the reconstruction is shared.
    # Combine in INTEGER space: each row is f32-exact but their f32 SUM
    # rounds to even above 2^24 (the bound this encoding removes)
    splat_id = (full[:height, :width, 5].astype(jnp.int32)
                + 4096 * full[:height, :width, 6].astype(jnp.int32))
    return img, trans, depth, splat_id
