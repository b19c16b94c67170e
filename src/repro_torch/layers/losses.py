"""Cross-entropy of the LM (counterpart of ``repro/layers/losses.py``).

The JAX version picks the gold logit with a one-hot masked sum so that it
stays sharded over the vocabulary; the port runs on one card, so a
``gather`` picks the same number.  The formula is the JAX one: fp32
logsumexp minus the gold logit, and a masked mean whose denominator is
floored at 1.  Where the batch is split across ranks (``sharding.
batch_total``) the denominator counts the whole batch's positions, so the
ranks' losses add up to the loss of the whole batch.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.sharding import batch_total

__all__ = ["vocab_parallel_nll", "masked_mean_nll"]


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits (..., V), labels (...) int → per-position negative
    log-likelihood (...), fp32."""
    logits = logits.float()
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def masked_mean_nll(logits: torch.Tensor, labels: torch.Tensor,
                    loss_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean NLL over the positions of ``loss_mask`` (all when None)."""
    nll = vocab_parallel_nll(logits, labels)
    if loss_mask is None:
        return nll.sum() / batch_total(nll.numel(), device=nll.device)
    nll = torch.where(loss_mask.bool(), nll, 0.0)
    return nll.sum() / torch.clamp(batch_total(loss_mask.sum()), min=1)
