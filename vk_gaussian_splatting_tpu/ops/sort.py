"""Depth-key encoding and sorting.

The reference encodes view depth into an order-preserving uint32
(dist.comp.slang:33-38 ``encodeMinMaxFp32``: flip sign bit for positives,
flip all bits for negatives) and radix-sorts (key, splat-id) pairs with the
vrdx GPU radix sort (4 LSD passes, 3rdparty/vrdx). Invalid slots use
0xffffffff keys so they sort last (vrdx upsweep.slang:37) — the same padding
trick static-shape XLA needs.

The sort here is ``jax.lax.sort`` over multiple keys; a hand-written radix
sort could swap in behind the same interface later.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def encode_minmax_f32(val: jax.Array) -> jax.Array:
    """fp32 -> order-preserving uint32 (dist.comp.slang:33-38)."""
    bits = jax.lax.bitcast_convert_type(val.astype(jnp.float32), jnp.int32)
    flipped = jax.lax.bitwise_xor(
        bits,
        jax.lax.bitwise_or(
            jax.lax.shift_right_arithmetic(bits, 31),
            jnp.int32(-2147483648),  # 0x80000000
        ),
    )
    return jax.lax.bitcast_convert_type(flipped, jnp.uint32)


def decode_minmax_f32(key: jax.Array) -> jax.Array:
    bits = jax.lax.bitcast_convert_type(key, jnp.int32)
    sign = jax.lax.shift_right_arithmetic(
        jax.lax.bitwise_not(bits), 31
    )
    unflipped = jax.lax.bitwise_xor(
        bits, jax.lax.bitwise_or(sign, jnp.int32(-2147483648))
    )
    return jax.lax.bitcast_convert_type(unflipped, jnp.float32)


def sort_by_depth(depth: jax.Array, valid: jax.Array, front_to_back: bool = True):
    """Global depth order over splats; invalid entries sort last.

    Returns (order, num_valid): ``order`` is a permutation of splat indices with
    valid splats first in the requested depth order (the reference's unified
    global sort, splat_set_manager_vk.cpp:2426-2517 + dist.comp key encode).
    """
    n = depth.shape[0]
    d = jnp.where(valid, depth if front_to_back else -depth, jnp.inf)
    ids = jnp.arange(n, dtype=jnp.int32)
    _, order = jax.lax.sort((d, ids), num_keys=1)
    return order, valid.sum(dtype=jnp.int32)


def sort_pairs(tile_ids: jax.Array, depth: jax.Array, payload: jax.Array, num_keys: int = 2):
    """Lexicographic (tile, depth) sort carrying a payload. All inputs (P,)."""
    st, sd, sp = jax.lax.sort((tile_ids, depth, payload), num_keys=num_keys)
    return st, sd, sp
