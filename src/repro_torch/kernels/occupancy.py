"""Tile liveness: which tiles of a kernel can contribute anything.

Counterpart of the helpers of ``repro/kernels/occupancy.py`` that the
serving and training paths use.  ``key_tile_live`` feeds the ball kernel's
dead-ball skip; ``invalidate_dead_groups`` is SEMANTIC: the selection oracle
applies it too (``core/branches.py::selection_attend``), so kernel and
oracle both give exact zeros for an all-padding query group.

Packed-varlen maps: :func:`varlen_maps` turns host ``offsets`` into the
device tensors the varlen kernels read (per-position segment ids and the
segment boundaries), built once per distinct offsets and device and cached
on the offsets' values, so the 18 layers of a batch (and its backward)
reuse one build and never read offsets back from the card.
:func:`tile_seg_ranges` / :func:`ranges_live_map` say which (query tile,
key tile) pairs share a segment: what the kernels visit.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.numerics import NEG_INF, segment_ids_from_offsets

__all__ = ["key_tile_live", "group_live", "invalidate_dead_groups",
           "offsets_key", "segment_ids", "VarlenMaps", "varlen_maps",
           "tile_seg_ranges", "ranges_live_map"]


def key_tile_live(key_bias: torch.Tensor, tile: int) -> torch.Tensor:
    """(B, L) fp32 additive key bias → (B, L/tile) bool: does any key of the
    tile carry weight?  A key is dead when its bias is at or below the
    NEG_INF/2 guard, the threshold at which the kernels zero p."""
    B, L = key_bias.shape
    return (key_bias.reshape(B, L // tile, tile) > NEG_INF / 2).any(-1)


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


@functools.lru_cache(maxsize=128)
def _segment_tables(key: tuple, length: int, device: torch.device):
    # the kernels read rows [bounds[s], bounds[s+1]): bounds outside the axis
    # would read past it
    if not key or key[0] < 0 or key[-1] > length or any(
            a > b for a, b in zip(key[:-1], key[1:])):
        raise ValueError(f"offsets {list(key)} must be non-decreasing, start at "
                         f"≥ 0 and end at ≤ the axis length {length}")
    seg = segment_ids_from_offsets(torch.tensor(key, dtype=torch.int32), length)
    # segment s owns positions [bounds[s], bounds[s+1]); the tail S ends at length
    bounds = torch.tensor(key + (length,), dtype=torch.int32)
    return seg.to(device), bounds.to(device)


def segment_ids(offsets, length: int, device) -> torch.Tensor:
    """Cached :func:`segment_ids_from_offsets` of host ``offsets``, on
    ``device``."""
    return _segment_tables(offsets_key(offsets), length, torch.device(device))[0]


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
    qk, kk = offsets_key(q_offsets), offsets_key(k_offsets)
    if len(qk) != len(kk):
        raise ValueError(f"q_offsets and k_offsets must have one length, got "
                         f"{len(qk)} and {len(kk)}")
    device = torch.device(device)
    qseg, q_bounds = _segment_tables(qk, T, device)
    kseg, k_bounds = _segment_tables(kk, L, device)
    return VarlenMaps(qseg, kseg, q_bounds, k_bounds)


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
