"""Cross-entropy of the LM (counterpart of ``repro/layers/losses.py``).

The JAX version picks the gold logit with a one-hot masked sum so that it
stays sharded over the vocabulary.  On whole logits a ``gather`` picks the
same number.  Where the logits are this rank's vocabulary slice
(``part``: the ``lm_head`` or the tied table cut over ``model``,
``distributed/tensor_parallel.py``), the max, the sum of exponentials and
the gold logit are reduced over ``model`` and the logits are never
gathered.  The formula is the JAX one: fp32 logsumexp minus the gold
logit, and a masked mean whose denominator is floored at 1.  Where the
batch is split across ranks (``sharding.batch_total``) the denominator
counts the whole batch's positions, so the ranks' losses add up to the
loss of the whole batch.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import comm, tensor_parallel
from repro_torch.distributed.sharding import batch_total

__all__ = ["vocab_parallel_nll", "masked_mean_nll"]


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor, *,
                       part=None) -> torch.Tensor:
    """logits (..., V), labels (...) int → per-position negative
    log-likelihood (...), fp32.  ``part`` = (the ``model`` axis group, the
    first vocabulary id of these logits): ``logits`` is this rank's slice
    (..., V / model) and the result is the whole vocabulary's, the same
    bits on every rank."""
    logits = logits.float()
    if part is None:
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return torch.logsumexp(logits, dim=-1) - gold
    ax, start = part
    n = logits.shape[-1]
    local = labels.long() - start
    hit = (local >= 0) & (local < n)
    m = comm.all_reduce_max(logits.detach().amax(-1), ax)
    gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    sums = torch.stack([torch.exp(logits - m[..., None]).sum(-1),
                        torch.where(hit, gold, torch.zeros_like(gold))])
    total, gold = tensor_parallel.reduce_from_model(ax, sums)
    return m + torch.log(total) - gold


def masked_mean_nll(logits: torch.Tensor, labels: torch.Tensor,
                    loss_mask: torch.Tensor | None = None, *, part=None) -> torch.Tensor:
    """Mean NLL over the positions of ``loss_mask`` (all when None);
    ``part``: see :func:`vocab_parallel_nll`."""
    nll = vocab_parallel_nll(logits, labels, part=part)
    if loss_mask is None:
        return nll.sum() / batch_total(nll.numel(), device=nll.device)
    nll = torch.where(loss_mask.bool(), nll, 0.0)
    return nll.sum() / torch.clamp(batch_total(loss_mask.sum()), min=1)
