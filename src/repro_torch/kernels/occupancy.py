"""Tile liveness: which tiles of a kernel can contribute anything.

Counterpart of the two helpers of ``repro/kernels/occupancy.py`` that the
serving path uses.  ``key_tile_live`` feeds the ball kernel's dead-ball skip;
``invalidate_dead_groups`` is SEMANTIC: the selection oracle applies it too
(``core/branches.py::selection_attend``), so kernel and oracle both give
exact zeros for an all-padding query group.
"""

from __future__ import annotations

import torch

from repro_torch.numerics import NEG_INF

__all__ = ["key_tile_live", "group_live", "invalidate_dead_groups"]


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
