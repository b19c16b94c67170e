"""AdamW with decoupled weight decay (paper Appendix A).

Counterpart of ``repro/optim/adamw.py``.  The JAX optimizer is a pure
function of a parameter pytree; here the parameters are a model's
``named_parameters()`` and the update runs in place under ``no_grad``
(the port keeps no second copy of the weights).  The state is explicit:
``{"m": {name: tensor}, "v": {name: tensor}, "step": int}``.  The moment
updates use PyTorch's multi-tensor (``_foreach``) ops, a handful of
launches per step instead of ten per parameter.
"""

from __future__ import annotations

import torch

__all__ = ["adamw_init", "adamw_update"]


def adamw_init(params: dict[str, torch.Tensor]) -> dict:
    """Zero fp32 moments shaped like ``params`` (name → tensor), step 0."""
    return {"m": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
            "v": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
            "step": 0}


@torch.no_grad()
def adamw_update(params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
                 opt_state: dict, *, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.01) -> dict:
    """One AdamW step over fp32 ``params`` in place; returns the new state
    (its ``m`` / ``v`` tensors updated in place, ``step`` incremented):

        m ← b1·m + (1−b1)·g        v ← b2·v + (1−b2)·g²
        p ← p − lr·(m̂ / (√v̂ + eps) + wd·p),   m̂ = m/(1−b1ᵗ), v̂ = v/(1−b2ᵗ)
    """
    step = opt_state["step"] + 1
    c1 = 1.0 - b1 ** step
    c2 = 1.0 - b2 ** step
    names = list(params)
    ps = [params[n] for n in names]
    gs = [grads[n].float() for n in names]
    ms = [opt_state["m"][n] for n in names]
    vs = [opt_state["v"][n] for n in names]
    if any(p.dtype != torch.float32 for p in ps + ms + vs):
        raise TypeError("adamw_update: the port trains fp32 parameters and state")
    torch._foreach_mul_(ms, b1)
    torch._foreach_add_(ms, gs, alpha=1 - b1)
    torch._foreach_mul_(vs, b2)
    torch._foreach_addcmul_(vs, gs, gs, value=1 - b2)
    denom = torch._foreach_div(vs, c2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    upd = torch._foreach_div(ms, c1)
    torch._foreach_div_(upd, denom)
    torch._foreach_add_(upd, ps, alpha=weight_decay)
    torch._foreach_add_(ps, upd, alpha=-lr)
    return {"m": opt_state["m"], "v": opt_state["v"], "step": step}
