"""Tile binning: splat -> (tile, depth)-sorted attribute lists + segments.

The reference builds per-frame visible-splat lists with GPU atomics + indirect
dispatch (dist.comp.slang:136-153); tile rasterization needs each splat
duplicated into every 16x16 tile its extent covers. Under jit every shape is
static, so pairs live in a fixed-size array, and the design carries every
attribute through one sort instead of gathering per pair:

1. **slot expansion**: every splat broadcasts its attribute row to K
   contiguous tile-slots (pure reshape/broadcast — no searchsorted); the
   covered tile rectangle is clamped to at most K tiles around the splat
   center (overflow reported; an exact searchsorted-based expansion remains
   for giant-splat scenes);
2. pairs sort ONCE by the two keys (tile, view depth) — one unstable
   variadic ``lax.sort`` carrying all render attributes as payloads. This
   replaces the earlier depth-presort + stable tile sort: XLA lowers a
   stable sort by appending an iota tiebreak operand, so the unstable
   two-key sort has the same operand count as the stable one-key sort had,
   and the N-level presort disappears entirely. Payload width drives the
   sort's cost, so nothing redundant rides along: the splat id is NOT a
   separate payload — by convention the LAST attribute row is the splat id
   (ops/response.py ID_ROW is last in every layout) and pair_splat derives
   from it;
3. per-tile **segments**: tile t owns [seg_starts[t], seg_starts[t] +
   seg_counts[t]) of the sorted pairs; the blenders (ops/tile_blend.py) walk
   each segment from there. At least ``chunk`` padding columns follow the
   last live pair, so a blender may load a whole chunk past any live
   position without leaving the array.

Everything is O(P log P) sort + O(P) scans; the only searchsorted runs on
tile-count arrays, not pairs.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from vk_gaussian_splatting_tpu.ops.projection import ProjectedSplats

def _key_sort(keys: tuple, payloads: tuple, is_stable: bool = False):
    """Multi-key sort carrying payloads: one ``lax.sort`` over every operand
    (on the GPU it measured no slower than splitting the payloads across
    several stable sorts — PERF.md)."""
    nk = len(keys)
    res = jax.lax.sort(keys + tuple(payloads), num_keys=nk,
                       is_stable=is_stable)
    return res[:nk], res[nk:]


def _stable_key_sort(key: jax.Array, payloads: tuple):
    """(sorted_key, sorted_payloads) — stable single-key sort (used by the
    secondary-ray tracer and the binning backward)."""
    keys, pays = _key_sort((key,), payloads, is_stable=True)
    return keys[0], pays


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TileBins:
    """Sorted pair attributes + per-tile segments for the tile blenders."""

    attrs: jax.Array        # (R, P) pair attributes in (tile, depth) order
    pair_splat: jax.Array   # (P,) i32 source splat per sorted pair
    pair_valid: jax.Array   # (P,) bool live pair
    seg_starts: jax.Array   # (T,) i32 segment starts
    seg_counts: jax.Array   # (T,) i32 per-tile pair counts
    num_pairs: jax.Array    # () i32 live pair count
    overflow: jax.Array     # () bool — slot/pair budget truncated


def tile_rect(xy: jax.Array, radius: jax.Array, tile_size: int,
              tiles_x: int, tiles_y: int):
    """Per-splat covered tile rectangle [x0,x1) x [y0,y1), clamped to the grid.

    radius: (N, 2) per-axis extent (rect bounding, threedgut.h.slang:155-160;
    isotropic for 3DGS)."""
    rx, ry = radius[:, 0], radius[:, 1]
    x0 = jnp.floor((xy[:, 0] - rx) / tile_size).astype(jnp.int32)
    y0 = jnp.floor((xy[:, 1] - ry) / tile_size).astype(jnp.int32)
    x1 = jnp.floor((xy[:, 0] + rx) / tile_size).astype(jnp.int32) + 1
    y1 = jnp.floor((xy[:, 1] + ry) / tile_size).astype(jnp.int32) + 1
    x0 = jnp.clip(x0, 0, tiles_x)
    y0 = jnp.clip(y0, 0, tiles_y)
    x1 = jnp.clip(x1, 0, tiles_x)
    y1 = jnp.clip(y1, 0, tiles_y)
    return x0, y0, x1, y1


def _class_caps(n: int):
    """(cap_g, cap_m) rank-ladder boundaries: columns [0, cap_g) get the
    giant window, [cap_g, cap_m) the mid window, [cap_m, n) the small one.
    Heavy-tail fractions with floors so small scenes (light-view shadow
    maps, test blobs) keep full coverage."""
    cap_g = min(n, max(-(-n // 64), 256))
    cap_m = min(n, max(-(-n // 4), cap_g + 2048))
    return cap_g, max(cap_m, cap_g)


def _bin_impl(
    proj: ProjectedSplats,
    attr_rows: jax.Array,          # (R<=16, N) per-splat render attributes
    *,
    tile_size: int,
    tiles_x: int,
    tiles_y: int,
    chunk: int = 128,              # pair-array padding granularity
    slots_k: int = 16,
    max_pairs: int = 0,            # exact mode pair budget (0 = slots mode)
    front_to_back: bool = True,
    expansion: str = "slots",
    classes: bool = True,          # class-based slot budgets (see 2a)
    need_pos: bool = True,         # carry the pair position payload
                                   # (only the custom-VJP fwd needs it)
    wide_id: bool = False,         # last TWO rows are (id_lo, id_hi) with
                                   # id = hi * 4096 + lo (gs2d wide ids,
                                   # exact past 2^24 — ops/response.py)
):
    num_tiles = tiles_x * tiles_y
    n = proj.xy.shape[0]
    r = attr_rows.shape[0]

    # ---- 1. per-splat tile rects + depth key ------------------------------
    dkey = jnp.where(proj.valid, proj.depth if front_to_back else -proj.depth,
                     jnp.inf)
    x0, y0, x1, y1 = tile_rect(proj.xy, proj.radius, tile_size,
                               tiles_x, tiles_y)
    valid0 = (proj.valid & (proj.radius.max(axis=1) > 0)
              & (x1 > x0) & (y1 > y0))

    if expansion == "slots":
        # ---- 2a. rank-ladder slot expansion ------------------------------
        # Fixed K slots per splat wastes 3-5x: the tile-coverage distribution
        # is heavy-tailed (most splats cover <=4 tiles, a few cover dozens)
        # and sort cost scales with pair count. Splats sort by coverage
        # (largest first); the top n/64 columns get a 4K-slot window, the
        # next (to n/4) a K-slot window, the rest K/4 — wider giant coverage
        # than fixed-K at under half the pairs, and overflow degrades
        # gracefully (only the smallest over-budget splats truncate). The
        # (tile, depth) pair sort orders the concatenated streams globally,
        # so emission order never matters.
        k_m = slots_k
        k_a = min(4, k_m)
        k_g = 4 * k_m
        use_classes = classes and k_m > k_a
        cx = (proj.xy[:, 0] / tile_size).astype(jnp.int32)
        cy = (proj.xy[:, 1] / tile_size).astype(jnp.int32)
        w = jnp.maximum(x1 - x0, 0)
        h = jnp.maximum(y1 - y0, 0)
        cx = jnp.clip(cx, x0, jnp.maximum(x1 - 1, x0))
        cy = jnp.clip(cy, y0, jnp.maximum(y1 - 1, y0))
        area = jnp.where(valid0, w * h, 0)

        def window(x0, y0, x1, y1, cx, cy, gate, k):
            """Clamped k-tile window around the splat's own tile: (m, k)
            tile ids + slot validity for the m leading sorted columns."""
            m = x0.shape[0]
            w = jnp.maximum(x1 - x0, 0)
            h = jnp.maximum(y1 - y0, 0)
            wc = jnp.minimum(w, k)
            hc = jnp.minimum(h, jnp.maximum(k // jnp.maximum(wc, 1), 1))
            # prefer squarer windows when clamping both dims
            wc = jnp.minimum(wc, jnp.maximum(k // jnp.maximum(hc, 1), 1))
            x0c = jnp.clip(cx - wc // 2, x0, jnp.maximum(x1 - wc, x0))
            y0c = jnp.clip(cy - hc // 2, y0, jnp.maximum(y1 - hc, y0))
            trunc = gate & ((wc * hc) < (w * h))
            slot = jnp.broadcast_to(jax.lax.iota(jnp.int32, k)[None, :],
                                    (m, k))
            tx = x0c[:, None] + slot % jnp.maximum(wc, 1)[:, None]
            ty = y0c[:, None] + slot // jnp.maximum(wc, 1)[:, None]
            sv = (slot < (wc * hc)[:, None]) & gate[:, None]
            tile = jnp.where(sv, ty * tiles_x + tx, num_tiles)
            return tile, sv, trunc

        if not use_classes:
            tile, slot_valid, trunc = window(x0, y0, x1, y1, cx, cy, valid0,
                                             k_m)
            overflow = jnp.any(trunc)
            p_raw = n * k_m
            p_total = padded_pairs(p_raw, chunk)
            pad = p_total - p_raw

            def bcast(a):
                flat = jnp.broadcast_to(a[:, None], (n, k_m)).reshape(p_raw)
                return jnp.pad(flat, (0, pad))

            tile_f = jnp.pad(tile.reshape(p_raw).astype(jnp.int32), (0, pad),
                             constant_values=num_tiles)
            depth_f = bcast(dkey)
            pair_rows = tuple(bcast(row) for row in attr_rows)
            num_pairs = jnp.sum(slot_valid)
            sids = None
        else:
            if tiles_x > 255 or tiles_y > 255:
                raise ValueError("class expansion packs tile coords into 8 "
                                 "bits; shard wider images into bands")
            cap_g, cap_m = _class_caps(n)
            # rank-ladder sort: largest tile coverage first, so the widest
            # windows always go to the splats that need them; the key
            # doubles as the (cx, cy, valid) payload
            a12 = jnp.minimum(area, 4095)
            ckey = (((4095 - a12) << 17)
                    | (valid0.astype(jnp.int32) << 16)
                    | (cx << 8) | cy)
            w_rect = (x0 << 24) | (y0 << 16) | (x1 << 8) | y1
            (ckey_s,), spay = _key_sort((ckey,),
                                        (w_rect, dkey) + tuple(attr_rows))
            w_rect_s, dkey_s = spay[0], spay[1]
            rows_s = spay[2:]
            valid_s = ((ckey_s >> 16) & 1) > 0
            cx_s = (ckey_s >> 8) & 0xFF
            cy_s = ckey_s & 0xFF
            x0s = (w_rect_s >> 24) & 0xFF
            y0s = (w_rect_s >> 16) & 0xFF
            x1s = (w_rect_s >> 8) & 0xFF
            y1s = w_rect_s & 0xFF
            # bwd un-sorts gradients by the carried id row(s): the last
            # attr row, or (id_hi, id_lo) combined for wide-id layouts
            if wide_id:
                sids = (rows_s[r - 1].astype(jnp.int32) * 4096
                        + rows_s[r - 2].astype(jnp.int32))
            else:
                sids = rows_s[r - 1].astype(jnp.int32)

            def region(lo, hi, k):
                sl = slice(lo, hi)
                return window(x0s[sl], y0s[sl], x1s[sl], y1s[sl],
                              cx_s[sl], cy_s[sl], valid_s[sl], k)

            t_g, sv_g, tr_g = region(0, cap_g, k_g)
            t_m, sv_m, tr_m = region(cap_g, cap_m, k_m)
            t_a, sv_a, tr_a = region(cap_m, n, k_a)
            overflow = jnp.any(tr_g) | jnp.any(tr_m) | jnp.any(tr_a)

            p_raw = cap_g * k_g + (cap_m - cap_g) * k_m + (n - cap_m) * k_a
            p_total = padded_pairs(p_raw, chunk)
            pad = p_total - p_raw

            def bcast(row):
                return jnp.concatenate([
                    jnp.broadcast_to(row[:cap_g, None],
                                     (cap_g, k_g)).reshape(-1),
                    jnp.broadcast_to(row[cap_g:cap_m, None],
                                     (cap_m - cap_g, k_m)).reshape(-1),
                    jnp.broadcast_to(row[cap_m:, None],
                                     (n - cap_m, k_a)).reshape(-1),
                    jnp.zeros((pad,), row.dtype),
                ])

            tile_f = jnp.concatenate([
                t_g.reshape(-1), t_m.reshape(-1), t_a.reshape(-1),
                jnp.full((pad,), num_tiles, jnp.int32)])
            depth_f = bcast(dkey_s)
            pair_rows = tuple(bcast(row) for row in rows_s)
            num_pairs = jnp.sum(sv_a) + jnp.sum(sv_m) + jnp.sum(sv_g)

        # pair position: the bwd un-permutes d_attrs by sorting on this
        # payload, then per-region reshape-sums yield per-splat gradients
        # (inverting a sort via its transpose would lower to pair-count
        # scatters)
        pos0 = jnp.arange(p_total, dtype=jnp.int32)
    else:
        # ---- 2b. exact expansion (searchsorted; slow but uncapped) -------
        assert max_pairs > 0, "exact expansion needs a max_pairs budget"
        max_pairs = -(-max_pairs // chunk) * chunk
        p_total = padded_pairs(max_pairs, chunk)
        w = jnp.maximum(x1 - x0, 0)
        h = jnp.maximum(y1 - y0, 0)
        counts = jnp.where(valid0, w * h, 0).astype(jnp.int32)
        starts = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts)[:-1]])
        total = starts[-1] + counts[-1]
        overflow = total > max_pairs
        p = jnp.arange(p_total, dtype=jnp.int32)
        s = jnp.clip(jnp.searchsorted(starts, p, side="right") - 1, 0, n - 1)
        rank = p - starts[s]
        ws = jnp.maximum(w[s], 1)
        tx = x0[s] + rank % ws
        ty = y0[s] + rank // ws
        pv = p < jnp.minimum(total, max_pairs)
        tile_f = jnp.where(pv, ty * tiles_x + tx, num_tiles).astype(jnp.int32)
        depth_f = dkey[s]
        pair_rows = tuple(row[s] for row in attr_rows)
        pos0 = jnp.arange(p_total, dtype=jnp.int32)  # unused (autodiff path)
        num_pairs = jnp.minimum(total, max_pairs)
        sids = None

    # ---- 3. one unstable (tile, depth) two-key sort, attrs as payloads ----
    pay = ((pos0,) if need_pos else ()) + pair_rows
    skeys, sorted_pairs = _key_sort((tile_f, depth_f), pay)
    tile_sorted = skeys[0]
    if need_pos:
        pos_sorted = sorted_pairs[0]
        rows_sorted = sorted_pairs[1:]
    else:
        pos_sorted = None
        rows_sorted = sorted_pairs

    attrs = jnp.stack(rows_sorted, axis=0)

    pair_valid = tile_sorted < num_tiles
    # last attribute row is the splat id by convention (see module
    # docstring); wide-id layouts carry (id_lo, id_hi) in the last two
    sid_sorted = (rows_sorted[r - 1].astype(jnp.int32) * 4096
                  + rows_sorted[r - 2].astype(jnp.int32)) if wide_id \
        else rows_sorted[r - 1].astype(jnp.int32)
    splat_sorted = jnp.where(pair_valid, sid_sorted, 0)

    # ---- 4. per-tile segments (small arrays only) --------------------------
    tile_starts = jnp.searchsorted(
        tile_sorted, jnp.arange(num_tiles + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    seg_counts = tile_starts[1:] - tile_starts[:-1]

    bins = TileBins(
        attrs=attrs,
        pair_splat=splat_sorted,
        pair_valid=pair_valid,
        seg_starts=tile_starts[:-1],
        seg_counts=seg_counts,
        num_pairs=num_pairs,
        overflow=overflow,
    )
    return bins, pos_sorted, sids


def padded_pairs(p_raw: int, chunk: int = 128) -> int:
    """Pair-array length: p_raw rounded up to chunk, plus one chunk of
    padding that sorts behind every live pair."""
    return -(-p_raw // chunk) * chunk + chunk


def _zero_cotangent(tree):
    def z(x):
        if jnp.issubdtype(x.dtype, jnp.floating):
            return jnp.zeros_like(x)
        import numpy as np
        return np.zeros(x.shape, dtype=jax.dtypes.float0)
    return jax.tree.map(z, tree)


@partial(jax.custom_vjp, nondiff_argnums=(2,))
def _bin_slots(proj, attr_rows, statics):
    """Slots-mode binning with a sort-based backward.

    Autodiff through the fwd sorts would transpose them into pair-count
    scatters; instead the bwd sorts
    d_attrs back to broadcast order by the carried pair position, then
    per-region (m, k) reshape-sums over the slots yield class-sorted
    per-splat gradients, un-sorted to splat order by the carried ids. No
    gradient flows through proj here: tile/slot assignment is discrete and
    sort-key cotangents vanish (sorted keys are discarded), so every
    differentiable quantity reaches the blender via attr_rows.
    """
    bins, _, _ = _bin_impl(proj, attr_rows, need_pos=False, **dict(statics))
    return bins


def _regions(statics, n):
    kw = dict(statics)
    k_m = kw["slots_k"]
    k_a = min(4, k_m)
    if not (kw.get("classes", True) and k_m > k_a):
        return None
    cap_g, cap_m = _class_caps(n)
    return (n, k_a, cap_m, k_m, cap_g, 4 * k_m)


def _bin_slots_fwd(proj, attr_rows, statics):
    bins, pos_sorted, sids = _bin_impl(proj, attr_rows, **dict(statics))
    return bins, (pos_sorted, sids, proj, attr_rows.shape[0],
                  attr_rows.shape[1])


def _bin_slots_bwd(statics, res, d_bins):
    pos_sorted, sids, proj, r, n = res
    # the last two attribute rows are (depth, id) by layout convention
    # (ops/response.py) and the blender backward never produces cotangents
    # for them (aux picks are not differentiated) — skipping them keeps two
    # payloads out of the un-sorts
    rd = r - 2
    d_attrs = d_bins.attrs                       # (R, P)
    _, unsorted = _key_sort((pos_sorted,),
                            tuple(d_attrs[i] for i in range(rd)))
    d_pairs = jnp.stack(unsorted, axis=0)        # (rd, P) in emit order
    reg = _regions(statics, n)
    if reg is None:
        k = dict(statics)["slots_k"]
        d_rows = d_pairs[:, :n * k].reshape(rd, n, k).sum(axis=2)
        return (_zero_cotangent(proj),
                jnp.concatenate([d_rows, jnp.zeros((2, n), jnp.float32)]))
    _, k_a, cap_m, k_m, cap_g, k_g = reg
    og = cap_g * k_g
    om = og + (cap_m - cap_g) * k_m
    oa = om + (n - cap_m) * k_a
    d_sorted = jnp.concatenate([
        d_pairs[:, :og].reshape(rd, cap_g, k_g).sum(axis=2),
        d_pairs[:, og:om].reshape(rd, cap_m - cap_g, k_m).sum(axis=2),
        d_pairs[:, om:oa].reshape(rd, n - cap_m, k_a).sum(axis=2),
    ], axis=1)
    # back to original splat order via the carried ids
    _, back = _key_sort((sids,), tuple(d_sorted[i] for i in range(rd)))
    d_rows = jnp.concatenate([jnp.stack(back, axis=0),
                              jnp.zeros((2, n), jnp.float32)])
    return _zero_cotangent(proj), d_rows


_bin_slots.defvjp(_bin_slots_fwd, _bin_slots_bwd)


@partial(jax.jit, static_argnames=("tile_size", "tiles_x", "tiles_y", "chunk",
                                   "slots_k", "max_pairs", "front_to_back",
                                   "expansion", "classes", "wide_id"))
def bin_splats(
    proj: ProjectedSplats,
    attr_rows: jax.Array,
    *,
    tile_size: int,
    tiles_x: int,
    tiles_y: int,
    chunk: int = 128,
    slots_k: int = 16,
    max_pairs: int = 0,
    front_to_back: bool = True,
    expansion: str = "slots",
    classes: bool = True,
    wide_id: bool = False,
) -> TileBins:
    kw = dict(tile_size=tile_size, tiles_x=tiles_x, tiles_y=tiles_y,
              chunk=chunk, slots_k=slots_k, max_pairs=max_pairs,
              front_to_back=front_to_back,
              expansion=expansion, classes=classes, wide_id=wide_id)
    if expansion == "slots":
        return _bin_slots(proj, attr_rows, tuple(sorted(kw.items())))
    bins, _, _ = _bin_impl(proj, attr_rows, need_pos=False, **kw)
    return bins
