"""Global-norm gradient clipping (counterpart of ``repro/optim/clip.py``).

The JAX formulas, not ``torch.nn.utils.clip_grad_norm_``: the norm is
floored at 1e-12 where the library adds 1e-6.  The scale stays a device
tensor, so clipping needs no host synchronisation.
"""

from __future__ import annotations

import torch

__all__ = ["global_norm", "clip_by_global_norm"]


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ Σ g²) over all tensors, fp32, as a 0-d tensor (the norm of
    the per-tensor norms: one multi-tensor launch, not one per tensor)."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float, *, norm=None):
    """Scale ``grads`` in place by min(1, max_norm / max(norm, 1e-12));
    returns (grads, norm).  ``norm``: the norm to read, where ``grads``
    are parts of a larger gradient (default: their own global norm)."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    torch._foreach_mul_(grads, scale)
    return grads, norm
