"""Token-choice top-k Mixture-of-Experts FFN with capacity-bounded,
sort-based dispatch.

Counterpart of ``repro/models/moe.py``.  Per batch row: the (token,
choice) assignments are sorted by expert, stably, ranked within each
expert's run, and the first ``cap`` of each expert fill its rows of an
(E_pad, cap, d) buffer (the rest are dropped, in sort order); the stacked
SwiGLU experts run as three batched products, and each assignment's output
comes back weighted by its renormalised router probability.  The expert
stack may be padded to ``pad_experts_to`` inert experts (zero rows in, zero
rows out); the router stays ``n_experts`` wide, so it never picks them.

Every data movement is a gather through an index that names each source
row at most once (a dropped assignment reads, or is read from, one spare
zero row that the result never keeps): the dispatch repeats x k times and
permutes it, the combine reads each assignment's output row and sums the
k choices of a token in a fixed order.  So no backward adds two
contributions into one row by atomics, and a backward on the card gives
the same bits on every call.  The expert products run in fp32 on the
exact widened operands (``preferred_element_type=float32``).

Under tensor parallelism (the stack cut over the ``model`` axis,
``distributed/tensor_parallel.py``) every rank routes every token, as
JAX's GSPMD step does, so the drop set is the same; a rank then runs only
its ``E_pad / model`` experts on the rows dispatched to them (or, where
the experts do not divide, its part of every expert's ffn dim), and the
combine is summed over ``model``.  The router and the shared expert's
products follow their own weights' layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import tensor_parallel
from repro_torch.distributed.sharding import batch_total
from repro_torch.layers.nn import Dense, SwiGLU, dense, swiglu

__all__ = ["MoE", "moe_init", "moe_capacity", "moe_route", "moe_apply"]


class MoE(nn.Module):
    """``router`` (d → n_experts), the padded expert stack ``w_gate`` /
    ``w_up`` (E_pad, d, dff) and ``w_down`` (E_pad, dff, d), and the fused
    ``shared`` expert (SwiGLU of ``n_shared_experts · moe_d_ff``) when the
    config has one."""

    def __init__(self, mcfg, *, generator: torch.Generator, dtype=torch.float32,
                 device=None):
        super().__init__()
        d, E, dff = mcfg.d_model, mcfg.n_experts, mcfg.moe_d_ff
        Ep = max(mcfg.pad_experts_to, E)
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.router = Dense(d, E, scale=0.02, **kw)

        def stack(shape, fan_in):
            w = torch.randn(shape, generator=generator, device=generator.device)
            return nn.Parameter((w * (2.0 / fan_in) ** 0.5).to(dtype=dtype, device=device))

        self.w_gate = stack((Ep, d, dff), d)
        self.w_up = stack((Ep, d, dff), d)
        self.w_down = stack((Ep, dff, d), dff)
        if mcfg.n_shared_experts:
            self.shared = SwiGLU(d, mcfg.n_shared_experts * dff, **kw)


def moe_init(mcfg, *, generator: torch.Generator, dtype=torch.float32, device=None) -> MoE:
    return MoE(mcfg, generator=generator, dtype=dtype, device=device)


def moe_capacity(mcfg, S: int) -> int:
    """Rows a (batch row, expert) pair holds: ``capacity_factor · S·k / E``,
    at least 4, at most S·k, rounded up to a multiple of 64 (of 4 below
    64).  A decode step (S = 1) gets k ≤ 4 rows: nothing drops there."""
    k, E = mcfg.experts_per_token, mcfg.n_experts
    cap = int(mcfg.capacity_factor * S * k / E) or 1
    cap = min(max(cap, 4), S * k)
    rnd = 64 if cap >= 64 else 4
    return -(-cap // rnd) * rnd


def moe_route(p: MoE, x: torch.Tensor, mcfg, top_e: torch.Tensor | None = None) -> dict:
    """The router's decisions for x (B, S, d): ``probs`` (B, S, E) fp32,
    ``top_e`` (B, S, k) and their renormalised weights ``w`` (``top_e``
    given: those experts, weighted by this router's probabilities, so that
    a check can hold two computations of one layer to one routing); the sort
    ``order`` (B, S·k) of the flat (token, choice) assignments by expert,
    and each assignment's ``slot`` (B, S, k) in its expert's rows
    (``cap`` marks a dropped one); ``counts`` (B, E_pad) assignments an
    expert received in each row, ``cap``."""
    B, S, _ = x.shape
    E, k = mcfg.n_experts, mcfg.experts_per_token
    Ep = max(mcfg.pad_experts_to, E)
    logits = dense(p.router, x).float()                             # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    if top_e is None:
        top_p, top_e = torch.topk(probs, k, dim=-1)                 # (B, S, k)
    else:
        top_p = probs.gather(-1, top_e)
    w = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    cap = moe_capacity(mcfg, S)
    e_flat = top_e.reshape(B, S * k)
    _, order = torch.sort(e_flat, dim=-1, stable=True)
    e_sort = e_flat.gather(1, order)
    counts = torch.zeros((B, Ep), dtype=torch.long, device=x.device)
    counts.scatter_add_(1, e_flat, torch.ones_like(e_flat))         # integers: exact
    starts = counts.cumsum(-1) - counts
    rank = torch.arange(S * k, device=x.device)[None] - starts.gather(1, e_sort)
    slot_sorted = torch.where(rank < cap, rank, cap)
    slot = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)   # a permutation
    return {"probs": probs, "top_e": top_e, "w": w, "order": order,
            "slot": slot.reshape(B, S, k), "counts": counts, "starts": starts, "cap": cap}


def moe_apply(p: MoE, x: torch.Tensor, mcfg,
              top_e: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """x: (B, S, d) → (y (B, S, d), {"aux_loss", "expert_counts", "top_e",
    "dropped"}): the Switch load-balance loss E · Σₑ mean(probₑ) · share(e)
    over the whole batch, the (E,) assignments each expert received, the
    experts each token chose (B, S, k) and whether any of a token's
    assignments was dropped (B, S).  ``top_e``: see :func:`moe_route`."""
    B, S, d = x.shape
    E, k = mcfg.n_experts, mcfg.experts_per_token
    Ep = max(mcfg.pad_experts_to, E)
    r = moe_route(p, x, mcfg, top_e)
    cap, order, counts, starts = r["cap"], r["order"], r["counts"], r["starts"]
    expert_counts = counts[:, :E].sum(0)
    # where the batch is split across ranks (``sharding.batch_total``): this
    # rank's share of the whole batch's loss (the shares add up to it), with
    # the token count and the assignments taken over the whole batch
    tokens = batch_total(B * S, device=x.device)
    aux_loss = E * torch.sum(r["probs"].sum((0, 1)) / tokens
                             * batch_total(expert_counts).float() / (tokens * k))

    # expert parallelism (``distributed/tensor_parallel.py``): the stack cut
    # over ``model`` on the expert dim (this rank's ``Ep / model`` experts
    # from ``e0``), or inside each expert on the ffn dim where the experts do
    # not divide; the routing is every rank's, the combine a sum over model
    split = tensor_parallel.cut_dim(p.w_gate)
    xs, w, e0, El = x, r["w"], 0, Ep
    if split is not None:
        ax = tensor_parallel.axis()
        xs, w = tensor_parallel.copy_to_model(ax, x, w)
        if split == 0:
            El = p.w_gate.shape[0]
            e0 = ax.index * El

    # dispatch: row c of expert e in batch row b is the assignment at sorted
    # position starts[e] + c when c < min(counts[e], cap); else the zero row
    n = B * S * k
    xk = xs[:, :, None, :].expand(B, S, k, d).reshape(n, d)
    xk = torch.cat([xk, xk.new_zeros((1, d))])                      # row n: zeros
    c = torch.arange(cap, device=x.device)
    starts, counts = starts[:, e0:e0 + El], counts[:, e0:e0 + El]
    pos = (starts[:, :, None] + c).clamp(max=S * k - 1)             # (B, El, cap)
    src = order.gather(1, pos.reshape(B, El * cap)).reshape(B, El, cap)
    src = src + (torch.arange(B, device=x.device) * S * k)[:, None, None]
    src = torch.where(c < counts[:, :, None], src, n)
    buf = xk[src.reshape(-1)].reshape(B, El, cap, d)

    # the experts: stacked SwiGLU, one batched product each, in fp32
    bufe = buf.transpose(0, 1).reshape(El, B * cap, d).float()
    h_g = torch.bmm(bufe, p.w_gate.float())
    h_u = torch.bmm(bufe, p.w_up.float())
    h = (F.silu(h_g) * h_u).to(x.dtype)
    out = torch.bmm(h.float(), p.w_down.float())
    if split != 2:                       # a cut ffn dim: partial sums until the combine
        out = out.to(x.dtype)
    out = out.reshape(El, B, cap, d).transpose(0, 1).reshape(B * El * cap, d)
    out = torch.cat([out, out.new_zeros((1, d))])                   # the dropped read zeros

    # combine: each assignment's row, weighted, summed over its k choices
    # (and over model: a rank holds the rows of its experts, or its part of
    # every expert's)
    slot, top_e = r["slot"], r["top_e"] - e0
    row = (torch.arange(B, device=x.device)[:, None, None] * El + top_e) * cap + slot
    row = torch.where((slot < cap) & (top_e >= 0) & (top_e < El), row, B * El * cap)
    y = (out[row.reshape(-1)].reshape(B, S, k, d).float() * w[..., None]).sum(2)
    if split is not None:
        y = tensor_parallel.reduce_from_model(ax, y)
    y = y.to(x.dtype)
    if hasattr(p, "shared"):
        y = y + swiglu(p.shared, x.reshape(B * S, d)).reshape(B, S, d)
    return y, {"aux_loss": aux_loss, "expert_counts": expert_counts, "top_e": r["top_e"],
               "dropped": (r["slot"] == cap).any(-1)}
