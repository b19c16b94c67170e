"""Full (dense) attention baseline: the paper's accuracy upper bound.

Counterpart of ``repro/core/full_attention.py``.  On the ``kernels``
backend it runs the flash kernels (``kernels/flash.py``) with a key bias
from the padding mask, or token-causal.
"""

from __future__ import annotations

import torch

from repro_torch.core.backend import resolve_backend

__all__ = ["full_attention"]


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mask: torch.Tensor | None = None, causal: bool = False,
                   backend=None) -> torch.Tensor:
    """q: (B, N, Hq, D); k, v: (B, L, Hkv, D); ``mask``: (B, L) bool key
    validity.  GQA-native: K/V go to the backend un-repeated.  ``backend``
    names a backend (or is one), resolved by
    :func:`core.backend.resolve_backend`.  Query rows are all computed (a
    padded row attends the valid keys).  Returns (B, N, Hq, D)."""
    return resolve_backend(backend).flash(q, k, v, key_valid=mask, causal=causal)
