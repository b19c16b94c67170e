"""Tile liveness: which tiles of a kernel can contribute anything.

Counterpart of the helpers of ``repro/kernels/occupancy.py`` that the
serving and training paths use.  ``key_tile_live`` feeds the ball kernel's
dead-ball skip and :func:`local_half_live` the local-window kernel's
dead-half skip; ``invalidate_dead_groups`` is SEMANTIC: the selection oracle
applies it too (``core/branches.py::selection_attend``), so kernel and
oracle both give exact zeros for an all-padding query group.

Packed-varlen maps: :func:`varlen_maps` turns host ``offsets`` into the
device tensors the varlen kernels read (per-position segment ids and the
segment boundaries), built once per distinct offsets and device and cached
on the offsets' values, so the 18 layers of a batch (and its backward)
reuse one build and never read offsets back from the card.
:func:`varlen_row_tiles` and :func:`varlen_dkv_tiles` plan the fp32 varlen
kernels' walks from the same host offsets: row tiles (``varlen_fwd``,
``varlen_dq``) and key tiles (``varlen_dkv``, each with its segment's rows
cut into splits) that never cross a segment.
:func:`tile_seg_ranges` / :func:`ranges_live_map` say which (query tile,
key tile) pairs share a segment: what the kernels visit.

The ring schedule's liveness (:func:`causal_tile_live` at shard
granularity, :func:`ring_hop_live`) and :func:`offsets_digest`, the host
offsets' hashable identity, serve the ``"sharded"`` backend.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.numerics import NEG_INF, segment_ids_from_offsets

__all__ = ["key_tile_live", "local_half_live", "group_live", "invalidate_dead_groups",
           "offsets_key", "segment_ids", "VarlenMaps", "varlen_maps",
           "varlen_row_tiles", "VarlenDkvTiles", "varlen_dkv_tiles", "tile_seg_ranges",
           "ranges_live_map", "causal_tile_live", "ring_hop_live", "offsets_digest"]


def key_tile_live(key_bias: torch.Tensor, tile: int) -> torch.Tensor:
    """(B, L) fp32 additive key bias → (B, L/tile) bool: does any key of the
    tile carry weight?  A key is dead when its bias is at or below the
    NEG_INF/2 guard, the threshold at which the kernels zero p."""
    B, L = key_bias.shape
    return (key_bias.reshape(B, L // tile, tile) > NEG_INF / 2).any(-1)


def local_half_live(key_bias: torch.Tensor, window: int,
                    blk_seg: torch.Tensor | None = None) -> torch.Tensor:
    """(B, N) fp32 key bias → (B, N/window, 2) bool: the two halves of each
    local-window block that carry weight, (prev, self) — exactly the two
    ``pl.when`` steps of ``repro/kernels/local.py`` (``_local_half_live``
    of ``repro/kernels/ops.py``).  Block 0 has no prev half; with
    ``blk_seg`` (B, N/window) int32 per-block segment ids, neither has a
    block whose predecessor lies in another segment."""
    kv = key_tile_live(key_bias, window)                       # (B, n_b)
    no = torch.zeros_like(kv[:, :1])
    prev = torch.cat([no, kv[:, :-1]], dim=1)
    if blk_seg is not None:
        prev = prev & torch.cat([no, blk_seg[:, 1:] == blk_seg[:, :-1]], dim=1)
    return torch.stack([prev, kv], dim=-1)


def group_live(mask: torch.Tensor, n_groups: int) -> torch.Tensor:
    """(B, N) bool token validity → (B, G) bool: any valid token in the
    query group."""
    B, N = mask.shape
    return mask.reshape(B, n_groups, N // n_groups).any(-1)


def invalidate_dead_groups(sel_valid: torch.Tensor, mask: torch.Tensor | None,
                           n_tokens: int) -> torch.Tensor:
    """Mark every selection of an all-masked query group invalid.

    ``sel_valid``: (B, G, …) selection validity; ``mask``: (B, N) bool token
    validity or None."""
    if mask is None:
        return sel_valid
    G = sel_valid.shape[1]
    live = group_live(mask[:, :n_tokens], G)
    return sel_valid & live.reshape(live.shape + (1,) * (sel_valid.dim() - 2))


def causal_tile_live(n_q: int, n_k: int, tq: int, tk: int, *, causal: bool = False,
                     block_causal: bool = False, ell: int = 1) -> np.ndarray:
    """Static (nQ, nK) bool structural liveness of the flash mask modes:
    tile (i, j) is live iff any (query, key) pair in it passes the mask.
    The extreme pair is (last query of tile i, first key of tile j), since
    both masks are monotone in the query position and anti-monotone in the
    key index.  Plain mode: every tile."""
    qmax = (np.arange(n_q) + 1) * tq - 1
    kmin = np.arange(n_k) * tk
    if block_causal:
        return (kmin[None, :] + 1) * ell - 1 < qmax[:, None]
    if causal:
        return kmin[None, :] <= qmax[:, None]
    return np.ones((n_q, n_k), bool)


def ring_hop_live(p: int, n_loc: int, *, causal: bool = False, block_causal: bool = False,
                  ell: int = 1) -> np.ndarray:
    """Static (p, p) bool: does hop h contribute anything on shard i?  Hop h
    leaves shard i holding the K/V slab of shard (i − h) mod p, so this is
    :func:`causal_tile_live` at tile size ``n_loc`` reindexed from (query
    tile, key tile) to (shard, hop).  Token-causal: live iff h ≤ i, p(p+1)/2
    of p² hops."""
    tl = causal_tile_live(p, p, n_loc, n_loc, causal=causal, block_causal=block_causal,
                          ell=ell)
    i = np.arange(p)[:, None]
    h = np.arange(p)[None, :]
    return tl[i, (i - h) % p]


# ---------------------------------------------------------------------------
# packed-varlen maps
# ---------------------------------------------------------------------------

def offsets_key(offsets) -> tuple:
    """Hashable value of host ``offsets`` (numpy, a sequence or a CPU
    tensor).  A CUDA tensor raises: reading it back would stall the card in
    every layer, so offsets stay on the host."""
    if isinstance(offsets, torch.Tensor):
        if offsets.device.type != "cpu":
            raise ValueError("offsets must stay on the host (a CPU tensor or "
                             f"numpy array), got one on {offsets.device}")
        return tuple(offsets.reshape(-1).tolist())
    return tuple(int(x) for x in np.asarray(offsets).reshape(-1))


def offsets_digest(offsets) -> tuple | None:
    """Hashable identity of host ``offsets`` (a tuple of ints), or None for
    offsets on a device: the host cannot read them without waiting for the
    card, as JAX's cannot read traced ones."""
    if isinstance(offsets, torch.Tensor) and offsets.device.type != "cpu":
        return None
    return offsets_key(offsets)


def _check_offsets(key: tuple, length: int) -> None:
    # the kernels read rows [bounds[s], bounds[s+1]): bounds outside the axis
    # would read past it
    if not key or key[0] < 0 or key[-1] > length or any(
            a > b for a, b in zip(key[:-1], key[1:])):
        raise ValueError(f"offsets {list(key)} must be non-decreasing, start at "
                         f"≥ 0 and end at ≤ the axis length {length}")


@functools.lru_cache(maxsize=128)
def _segment_tables(key: tuple, length: int, device: torch.device):
    _check_offsets(key, length)
    seg = segment_ids_from_offsets(torch.tensor(key, dtype=torch.int32), length)
    # segment s owns positions [bounds[s], bounds[s+1]); the tail S ends at length
    bounds = torch.tensor(key + (length,), dtype=torch.int32)
    return seg.to(device), bounds.to(device)


def segment_ids(offsets, length: int, device) -> torch.Tensor:
    """Cached :func:`segment_ids_from_offsets` of host ``offsets``, on
    ``device``."""
    return _segment_tables(offsets_key(offsets), length, torch.device(device))[0]


def _offset_keys(q_offsets, k_offsets) -> tuple[tuple, tuple]:
    qk, kk = offsets_key(q_offsets), offsets_key(k_offsets)
    if len(qk) != len(kk):
        raise ValueError(f"q_offsets and k_offsets must have one length, got "
                         f"{len(qk)} and {len(kk)}")
    return qk, kk


class VarlenMaps(NamedTuple):
    """What the varlen kernels read about the packed layout: segment ids of
    the query and key positions, (T,) / (L,) int32, and the segment
    boundaries of both axes, (S+2,) int32 (the offsets, then the axis
    length, which closes the capacity-tail segment S)."""
    qseg: torch.Tensor
    kseg: torch.Tensor
    q_bounds: torch.Tensor
    k_bounds: torch.Tensor


def varlen_maps(q_offsets, k_offsets, T: int, L: int, device) -> VarlenMaps:
    """The varlen kernels' maps for host offsets of the query axis (length
    T) and key axis (length L), as device tensors, cached on the offsets'
    values and the device."""
    qk, kk = _offset_keys(q_offsets, k_offsets)
    device = torch.device(device)
    qseg, q_bounds = _segment_tables(qk, T, device)
    kseg, k_bounds = _segment_tables(kk, L, device)
    return VarlenMaps(qseg, kseg, q_bounds, k_bounds)


class VarlenDkvTiles(NamedTuple):
    """The walk of ``varlen_dkv`` on its fma path: ``table`` (tiles, S, 4)
    int32 on the device, for each key tile and split the tile's first key,
    its number of keys, and the first and end row of the split; ``splits``
    S, the row splits of every tile."""
    table: torch.Tensor
    splits: int


def _segments(key: tuple, length: int) -> list[tuple[int, int]]:
    """[start, end) of segments 0..S of an axis, as
    ``segment_ids_from_offsets`` numbers its positions: segment 0 starts at
    0, segment S (the capacity tail) ends at the axis length."""
    return list(zip((0,) + key[1:], key[1:] + (length,)))


def varlen_row_tiles(q_offsets, k_offsets, T: int, L: int, device, *,
                     rows: int) -> torch.Tensor:
    """Plan the walk of the fp32 ``varlen_fwd`` and ``varlen_dq`` from host
    offsets, cached on their values: each segment's rows (the capacity
    tail's too) cut into tiles of ``rows`` (its last tile ragged, none
    crossing a segment boundary), each given its segment's keys.  Returns
    an int32 (tiles, 4) table on ``device`` of (first row, rows, first key,
    end key); a segment with no rows gives no tile, one with no keys a tile
    with an empty key range.  Every row of [0, T) lies in exactly one tile."""
    qk, kk = _offset_keys(q_offsets, k_offsets)
    return _row_tiles(qk, kk, T, L, torch.device(device), rows)


@functools.lru_cache(maxsize=128)
def _row_tiles(qk: tuple, kk: tuple, T: int, L: int, device: torch.device,
               rows: int) -> torch.Tensor:
    _check_offsets(qk, T)
    _check_offsets(kk, L)
    tiles = [(t0, min(rows, r1 - t0), k0, k1)
             for (r0, r1), (k0, k1) in zip(_segments(qk, T), _segments(kk, L))
             for t0 in range(r0, r1, rows)]
    return torch.tensor(tiles, dtype=torch.int32).reshape(len(tiles), 4).to(device)


def varlen_dkv_tiles(q_offsets, k_offsets, T: int, L: int, device, *, keys: int,
                     rows: int, heads: int, sms: int = 132) -> VarlenDkvTiles:
    """Plan ``varlen_dkv``'s fma walk from host offsets, cached on their
    values: each segment's keys (the capacity tail's too) cut into tiles of
    ``keys`` (its last tile ragged, none crossing a segment boundary), each
    tile given its segment's rows cut into S splits of whole ``rows``-row
    tiles (:func:`repro_torch.kernels.flash.dkv_ranges`'s rule; trailing
    splits may be empty).  S gives about four blocks of (tile, head, split)
    on each of ``sms`` SMs, never more than the longest segment has row
    tiles, at least 1."""
    qk, kk = _offset_keys(q_offsets, k_offsets)
    return _dkv_tiles(qk, kk, T, L, torch.device(device), keys, rows, heads, sms)


@functools.lru_cache(maxsize=128)
def _dkv_tiles(qk: tuple, kk: tuple, T: int, L: int, device: torch.device, keys: int,
               rows: int, heads: int, sms: int) -> VarlenDkvTiles:
    _check_offsets(qk, T)
    _check_offsets(kk, L)
    tiles = [(j0, min(keys, k1 - j0), r0, r1)
             for (r0, r1), (k0, k1) in zip(_segments(qk, T), _segments(kk, L))
             for j0 in range(k0, k1, keys)]
    longest = max((r1 - r0 for *_, r0, r1 in tiles), default=0)
    S = max(1, min(-(-4 * sms // max(1, len(tiles) * heads)), -(-longest // rows)))
    table = []
    for j0, nk, r0, r1 in tiles:
        chunk = -(-(-(-(r1 - r0) // S)) // rows) * rows
        splits = []
        for s in range(S):
            lo = min(r1, r0 + s * chunk)
            splits.append((j0, nk, lo, min(r1, lo + chunk)))
        table.append(splits)
    t = torch.tensor(table, dtype=torch.int32).reshape(len(tiles), S, 4)
    return VarlenDkvTiles(t.to(device), S)


def tile_seg_ranges(seg: torch.Tensor, tile: int) -> torch.Tensor:
    """(n,) monotone segment ids → (2, ceil(n/tile)) int32 per-tile
    [first, last] segment (a ragged last tile ends at the axis end)."""
    n = seg.shape[0]
    starts = torch.arange(0, n, tile, device=seg.device)
    ends = torch.clamp(starts + tile - 1, max=n - 1)
    return torch.stack([seg[starts], seg[ends]]).to(torch.int32)


def ranges_live_map(qrng: torch.Tensor, krng: torch.Tensor) -> torch.Tensor:
    """(2, nQ) × (2, nK) per-tile segment ranges → (nQ, nK) bool: do the
    two tiles share a segment?  The (query tile, key tile) pairs the varlen
    kernels visit."""
    return ((krng[0][None, :] <= qrng[1][:, None])
            & (qrng[0][:, None] <= krng[1][None, :]))
