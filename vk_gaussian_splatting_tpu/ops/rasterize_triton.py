"""The tile blender as a Pallas kernel for the GPU, through Triton.

One program per 16x16 tile (grid = tiles; no schedule). Each program reads
its own ``seg_starts[t]`` / ``seg_counts[t]`` and walks its segment in a
``lax.while_loop`` of ``st.chunk``-pair steps: masked loads of one (C,)
vector per attribute row, the shared chunk math of ops/tile_blend.py over
(256, C) register arrays, and an exit as soon as every pixel of the tile is
at or below ``min_transmittance`` (tile_blend.tile_running). The state lives in registers and nothing
carries between programs, so the blocks may run in any order.

Why a kernel: the blend is the frame's hot loop, and a fused per-tile
front-to-back walk that stops once the tile is opaque is what XLA cannot
build from the plain version (ops/rasterize_xla.py), which materializes
(tiles, 256, C) arrays in device memory at every step and steps every tile
until the last one is done.

Backward: the same per-tile forward-order sweep (ops/tile_blend.grad_chunk).
Each pair belongs to exactly one tile, so each program writes its own pairs'
gradient columns with masked stores — no read-modify-write, no atomics —
and zeroes the columns of pairs it skipped after terminating early.

The transmittance products are exp(cumsum(log q)) (tile_blend.log_prefix):
this route lowers a forward cumsum but no cumulative product. All math is
f32 on the CUDA cores; the color sums are per-channel reductions, not a
TF32 dot.

``interpret=True`` runs the kernel in the Pallas interpreter; only tests use
it. Production paths reach the kernel through tile_blend.select_blender.
"""

from __future__ import annotations

import functools
from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from vk_gaussian_splatting_tpu.ops.response import USES_PIX_CTX
from vk_gaussian_splatting_tpu.ops.tile_blend import (
    OUT_COLS,
    PIX,
    PIX_ROWS,
    RasterStatics,
    blend_chunk,
    grad_chunk,
    init_state,
    log_prefix,
    make_blender,
    output_columns,
    tile_pixel_coords,
)

NUM_WARPS = 8
FWD_NAME = "tile_blend_fwd"
BWD_NAME = "tile_blend_bwd"


def _tile_setup(st, seed_ref, starts_ref, counts_ref, pix_ref):
    t = pl.program_id(0)
    start = starts_ref[t]
    count = counts_ref[t]
    px, py = tile_pixel_coords(t, st.tiles_x)
    pix = (None if pix_ref is None
           else tuple(pix_ref[t, i, :] for i in range(PIX_ROWS)))
    return t, start, count, px, py, pix, seed_ref[0]


def _load_chunk(attrs_ref, nrows, start, count, k, chunk):
    off = k * chunk + jax.lax.iota(jnp.int32, chunk)
    live = off < count
    at = pl.ds(start + k * chunk, chunk)
    rows = tuple(
        plgpu.load(attrs_ref.at[r, at], mask=live, other=0.0)[None, :]
        for r in range(nrows))
    return start + off, live, rows


def _fwd_kernel(seed_ref, starts_ref, counts_ref, attrs_ref, *refs,
                st: RasterStatics, nrows: int):
    pix_ref = refs[0] if len(refs) == 2 else None
    out_ref = refs[-1]
    c = st.chunk
    t, start, count, px, py, pix, seed = _tile_setup(
        st, seed_ref, starts_ref, counts_ref, pix_ref)
    nchunks = (count + c - 1) // c

    def cond(carry):
        k, state = carry[0], carry[1:]
        return (k < nchunks) & (jnp.max(state[3]) > st.min_transmittance)

    def body(carry):
        k, state = carry[0], carry[1:]
        pos, live, rows = _load_chunk(attrs_ref, nrows, start, count, k, c)
        state = blend_chunk(st, state, rows, pix, px, py, pos, live, seed,
                            log_prefix)
        return (k + 1, *state)

    carry = jax.lax.while_loop(cond, body, (jnp.int32(0), *init_state()))
    for i, col in enumerate(output_columns(st, carry[1:])):
        plgpu.store(out_ref.at[t, i, :], col)


def _bwd_kernel(seed_ref, starts_ref, counts_ref, attrs_ref, ctx_ref, *refs,
                st: RasterStatics, nrows: int):
    pix_ref = refs[0] if len(refs) == 2 else None
    d_ref = refs[-1]
    c = st.chunk
    t, start, count, px, py, pix, seed = _tile_setup(
        st, seed_ref, starts_ref, counts_ref, pix_ref)
    ctx = tuple(ctx_ref[t, i, :] for i in range(5))
    nchunks = (count + c - 1) // c

    def cond(carry):
        k, tc, _ = carry
        return (k < nchunks) & (jnp.max(tc) > st.min_transmittance)

    def body(carry):
        k, tc, s_run = carry
        pos, live, rows = _load_chunk(attrs_ref, nrows, start, count, k, c)
        (tc, s_run), d_rows = grad_chunk(st, (tc, s_run), ctx, rows, pix,
                                         px, py, pos, live, seed, log_prefix)
        at = pl.ds(start + k * c, c)
        for r in range(nrows):
            plgpu.store(d_ref.at[r, at], d_rows[r].reshape(c), mask=live)
        return k + 1, tc, s_run

    k_end, _, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), jnp.ones((PIX,), jnp.float32),
                     jnp.zeros((PIX,), jnp.float32)))

    # pairs behind an opaque tile get zero gradient
    @pl.loop(k_end, nchunks)
    def _zero(k):
        off = k * c + jax.lax.iota(jnp.int32, c)
        at = pl.ds(start + k * c, c)
        for r in range(nrows):
            plgpu.store(d_ref.at[r, at], jnp.zeros((c,), jnp.float32),
                        mask=off < count)


def _params():
    return plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1)


@functools.lru_cache(maxsize=64)
def _fwd_call(st: RasterStatics, nrows: int, interpret: bool):
    return pl.pallas_call(
        partial(_fwd_kernel, st=st, nrows=nrows),
        grid=(st.tiles_x * st.tiles_y,),
        out_shape=jax.ShapeDtypeStruct((st.tiles_x * st.tiles_y, OUT_COLS,
                                        PIX), jnp.float32),
        backend="triton",
        compiler_params=_params(),
        interpret=interpret,
        name=FWD_NAME,
    )


@functools.lru_cache(maxsize=64)
def _bwd_call(st: RasterStatics, nrows: int, p: int, interpret: bool):
    return pl.pallas_call(
        partial(_bwd_kernel, st=st, nrows=nrows),
        grid=(st.tiles_x * st.tiles_y,),
        out_shape=jax.ShapeDtypeStruct((nrows, p), jnp.float32),
        backend="triton",
        compiler_params=_params(),
        interpret=interpret,
        name=BWD_NAME,
    )


def _pix_args(pix_ctx, st):
    return (pix_ctx,) if USES_PIX_CTX[st.model] else ()


def _fwd(attrs, seg_starts, seg_counts, pix_ctx, seed, st, interpret):
    return _fwd_call(st, attrs.shape[0], interpret)(
        seed, seg_starts, seg_counts, attrs, *_pix_args(pix_ctx, st))


def _bwd(attrs, seg_starts, seg_counts, pix_ctx, seed, ctx, st, interpret):
    return _bwd_call(st, attrs.shape[0], attrs.shape[1], interpret)(
        seed, seg_starts, seg_counts, attrs, ctx, *_pix_args(pix_ctx, st))


@functools.lru_cache(maxsize=None)
def blender(interpret: bool = False):
    """The differentiable Triton blender, with tile_blend.make_blender's
    signature. Binning leaves at least one chunk of padding columns after
    the last live pair, so every chunk load stays inside the array."""
    return make_blender(partial(_fwd, interpret=interpret),
                        partial(_bwd, interpret=interpret))
