"""Shared numeric constants and mask→logit-bias helpers.

Counterpart of ``repro/numerics.py``: a masked key contributes an additive
fp32 bias of ``NEG_INF`` (−1e30) to its logits, softmax statistics guard at
``NEG_INF / 2``, and rows whose keys are all masked produce exact zeros.
The CUDA kernels (``csrc/common.cuh``) carry the same constants.  Packed
(varlen) batches mark sample boundaries with an ``offsets`` array, turned
into per-position segment ids by :func:`segment_ids_from_offsets`.
"""

from __future__ import annotations

import torch

__all__ = ["NEG_INF", "mask_to_bias", "key_padding_bias", "segment_ids_from_offsets"]

NEG_INF = -1e30


def mask_to_bias(valid: torch.Tensor) -> torch.Tensor:
    """bool (… L) -> additive fp32 bias 0 / NEG_INF."""
    zero = torch.zeros((), dtype=torch.float32, device=valid.device)
    return torch.where(valid, zero, torch.full_like(zero, NEG_INF))


def key_padding_bias(mask: torch.Tensor | None, batch: int, length: int, *,
                     device: torch.device | str | None = None) -> torch.Tensor:
    """(B, L) bool key-validity (or None = all valid) -> (B, L) fp32 bias.

    ``device`` places the all-zero bias when ``mask`` is None."""
    if mask is None:
        return torch.zeros((batch, length), dtype=torch.float32, device=device)
    return mask_to_bias(mask)


def segment_ids_from_offsets(offsets, length: int, *, device=None) -> torch.Tensor:
    """Packed-varlen offsets ``(S+1,)`` → per-position segment id ``(length,)``
    int32 on ``device`` (default: the offsets' device).

    Positions in ``[offsets[i], offsets[i+1])`` get id ``i``; positions at or
    beyond ``offsets[-1]`` (the capacity tail) get id ``S``, greater than
    every real segment, so an equality test against key segment ids keeps
    the tail and the real samples apart.  Trailing repeated offsets (empty
    segments) own no positions."""
    offsets = torch.as_tensor(offsets)
    device = offsets.device if device is None else device
    bounds = offsets.to(device=device, dtype=torch.int64)[1:].contiguous()
    pos = torch.arange(length, device=device, dtype=torch.int64)
    return torch.searchsorted(bounds, pos, right=True).to(torch.int32)
