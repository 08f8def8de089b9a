"""The plain XLA tile blender: every tile's segment walked in lockstep.

Step k gathers chunk k of every tile's segment ((T, C) pair positions) and
blends it with the shared per-chunk math of ops/tile_blend.py, vmapped over
tiles. A tile that has no pairs left or has gone opaque takes no-op steps
(all its lanes masked) until the loop ends, when no tile runs. The backward is the same
forward-order sweep (ops/tile_blend.grad_chunk), scattering each chunk's
gradient columns to its (unique) pair positions.

This is the CPU blender, the plain version the Triton kernel is timed
against, and the reference it is checked against at full size
(ops/rasterize_ref.rasterize_naive is O(H*W*N) and only fits toy scenes).
Its transmittance products are exact f32 cumulative products.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from vk_gaussian_splatting_tpu.ops.response import USES_PIX_CTX
from vk_gaussian_splatting_tpu.ops.tile_blend import (
    PIX,
    PIX_ROWS,
    RasterStatics,
    blend_chunk,
    exact_prefix,
    grad_chunk,
    init_state,
    make_blender,
    output_columns,
    tile_pixel_coords,
    tile_running,
)


def _tile_inputs(pix_ctx, st: RasterStatics):
    t = jnp.arange(st.tiles_x * st.tiles_y, dtype=jnp.int32)
    px, py = jax.vmap(tile_pixel_coords, in_axes=(0, None))(t, st.tiles_x)
    pix = (tuple(pix_ctx[:, i, :] for i in range(PIX_ROWS))
           if USES_PIX_CTX[st.model] else None)
    return px, py, pix


def _chunk(attrs, seg_starts, seg_counts, k, chunk, running):
    """Chunk k of every tile: (T, C) positions, liveness (pairs of running
    tiles only) and per-row (T, 1, C) attribute vectors."""
    off = k * chunk + jnp.arange(chunk, dtype=jnp.int32)[None, :]
    live = (off < seg_counts[:, None]) & running[:, None]
    pos = seg_starts[:, None] + off
    idx = jnp.clip(pos, 0, attrs.shape[1] - 1)
    rows = tuple(attrs[r][idx][:, None, :] for r in range(attrs.shape[0]))
    return pos, live, rows


def _fwd(attrs, seg_starts, seg_counts, pix_ctx, seed, st: RasterStatics):
    c = st.chunk
    n = seg_starts.shape[0]
    px, py, pix = _tile_inputs(pix_ctx, st)
    step = jax.vmap(partial(blend_chunk, st, prefix=exact_prefix),
                    in_axes=(0, 0, 0, 0, 0, 0, 0, None))

    def running(k, tc):
        return tile_running(k, c, seg_counts, tc, st.min_transmittance)

    def cond(carry):
        k, state = carry
        return jnp.any(running(k, state[3]))

    def body(carry):
        k, state = carry
        pos, live, rows = _chunk(attrs, seg_starts, seg_counts, k, c,
                                 running(k, state[3]))
        return k + 1, step(state, rows, pix, px, py, pos, live, seed[0])

    state0 = tuple(jnp.broadcast_to(s, (n,) + s.shape) for s in init_state())
    _, state = jax.lax.while_loop(cond, body, (jnp.int32(0), state0))
    return jnp.stack(output_columns(st, state), axis=1)


def _bwd(attrs, seg_starts, seg_counts, pix_ctx, seed, ctx,
         st: RasterStatics):
    c = st.chunk
    n = seg_starts.shape[0]
    p = attrs.shape[1]
    px, py, pix = _tile_inputs(pix_ctx, st)
    ctx_cols = tuple(ctx[:, i, :] for i in range(5))
    step = jax.vmap(partial(grad_chunk, st, prefix=exact_prefix),
                    in_axes=(0, 0, 0, 0, 0, 0, 0, 0, None))

    def running(k, tc):
        return tile_running(k, c, seg_counts, tc, st.min_transmittance)

    def cond(carry):
        k, (tc, _), _ = carry
        return jnp.any(running(k, tc))

    def body(carry):
        k, tcarry, d_attrs = carry
        pos, live, rows = _chunk(attrs, seg_starts, seg_counts, k, c,
                                 running(k, tcarry[0]))
        tcarry, d_rows = step(tcarry, ctx_cols, rows, pix, px, py, pos,
                              live, seed[0])
        d = jnp.stack([dr[:, 0, :] for dr in d_rows], axis=0)  # (R, T, C)
        idx = jnp.where(live, pos, p)                           # p = dropped
        return k + 1, tcarry, d_attrs.at[:, idx].add(d, mode="drop")

    carry0 = (jnp.ones((n, PIX), jnp.float32),
              jnp.zeros((n, PIX), jnp.float32))
    _, _, d_attrs = jax.lax.while_loop(
        cond, body, (jnp.int32(0), carry0, jnp.zeros_like(attrs)))
    return d_attrs


# (R, P) sorted pair attrs, (T,) seg_starts / seg_counts, (T, 8, 256)
# pix_ctx or None, (1,) i32 seed, RasterStatics -> (T, 8, 256) tile blocks
rasterize_tiles = make_blender(_fwd, _bwd)
