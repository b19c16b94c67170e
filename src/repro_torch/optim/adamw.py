"""AdamW with decoupled weight decay (paper Appendix A).

Counterpart of ``repro/optim/adamw.py``.  The JAX optimizer is a pure
function of a parameter pytree; here the parameters are a model's
``named_parameters()`` and the update runs in place under ``no_grad``
(the port keeps no second copy of the weights).  The state is explicit:
``{"m": {name: tensor}, "v": {name: tensor}, "step": int}``, the moments in
``state_dtype`` (fp32 by default; ``ModelConfig.opt_state_dtype``).  fp32
parameters with fp32 moments update in place with PyTorch's multi-tensor
(``_foreach``) ops, a handful of launches per step instead of ten per
parameter.  Any other parameter or moment dtype (tinyllama's bf16 weights)
updates as the JAX function does: one tensor at a time in fp32, written
back in its own dtype.
"""

from __future__ import annotations

import torch

__all__ = ["adamw_init", "adamw_update"]


def adamw_init(params: dict[str, torch.Tensor], state_dtype=torch.float32) -> dict:
    """Zero moments of ``state_dtype`` shaped like ``params`` (name →
    tensor), step 0."""
    return {"m": {n: torch.zeros_like(p, dtype=state_dtype) for n, p in params.items()},
            "v": {n: torch.zeros_like(p, dtype=state_dtype) for n, p in params.items()},
            "step": 0}


@torch.no_grad()
def adamw_update(params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
                 opt_state: dict, *, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.01) -> dict:
    """One AdamW step over ``params`` in place; returns the new state (its
    ``m`` / ``v`` tensors updated in place, ``step`` incremented):

        m ← b1·m + (1−b1)·g        v ← b2·v + (1−b2)·g²
        p ← p − lr·(m̂ / (√v̂ + eps) + wd·p),   m̂ = m/(1−b1ᵗ), v̂ = v/(1−b2ᵗ)
    """
    step = opt_state["step"] + 1
    c1 = 1.0 - b1 ** step
    c2 = 1.0 - b2 ** step
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, c1=c1, c2=c2)
    fp32, cast = [], []
    for n in params:
        group = (params[n], grads[n], opt_state["m"][n], opt_state["v"][n])
        (fp32 if all(t.dtype == torch.float32 for t in (group[0], *group[2:]))
         else cast).append(group)
    if fp32:
        _update_fp32(*map(list, zip(*fp32)), **kw)
    for group in cast:
        _update_cast(*group, **kw)
    return {"m": opt_state["m"], "v": opt_state["v"], "step": step}


def _update_fp32(ps, gs, ms, vs, *, lr, b1, b2, eps, weight_decay, c1, c2):
    """fp32 parameters and moments, in place, multi-tensor."""
    gs = [g.float() for g in gs]
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


def _update_cast(p, g, m, v, *, lr, b1, b2, eps, weight_decay, c1, c2):
    """One tensor of any dtype, as ``repro/optim/adamw.py`` does it: the
    update in fp32, the moments stored in their dtype, the parameter in its
    own.  One tensor at a time bounds the fp32 temporaries."""
    g32 = g.float()
    m32 = b1 * m.float() + (1 - b1) * g32
    v32 = b2 * v.float() + (1 - b2) * g32 * g32
    p32 = p.float()
    delta = (m32 / c1) / (torch.sqrt(v32 / c2) + eps) + weight_decay * p32
    p.copy_(p32 - lr * delta)
    m.copy_(m32)
    v.copy_(v32)
