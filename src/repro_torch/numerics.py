"""Shared numeric constants and mask→logit-bias helpers.

Counterpart of ``repro/numerics.py``: a masked key contributes an additive
fp32 bias of ``NEG_INF`` (−1e30) to its logits, softmax statistics guard at
``NEG_INF / 2``, and rows whose keys are all masked produce exact zeros.
The CUDA kernels (``csrc/common.cuh``) carry the same constants.
"""

from __future__ import annotations

import torch

__all__ = ["NEG_INF", "mask_to_bias", "key_padding_bias"]

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
