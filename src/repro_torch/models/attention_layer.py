"""Attention layer: Q/K/V/O projections, RoPE and the attention mechanism.

Counterpart of ``repro/models/attention_layer.py``.  The mechanism
(``mcfg.attention``) is ``"bsa"``: non-causal ``bsa_attention`` (the
point-cloud model, no RoPE), or ``bsa_attention_varlen`` on a packed batch
(``offsets``); causal ``nsa_causal_attention`` with RoPE (the LM), and its
one-token decode steps over a dense cache (``attention_layer_decode``) or
paged pools (``attention_layer_decode_paged``).  The baselines are
``"full"`` (``full_attention``, non-causal with a key mask or causal) and
``"erwin"`` (``erwin_attention`` at the layer's coarsening level), padded
layout only; their one-token decode attends the whole cache with the plain
``sdpa`` (JAX's dense cached path).  ``cross_attention_apply`` attends
precomputed memory K/V (``memory_kv``) with ``full_attention``,
non-causal, the memory mask as key validity: the encoder-decoder's
cross-attention, on the flash kernels.  Under tensor parallelism
(``distributed/tensor_parallel.py``) both layers run this rank's heads
(:class:`HeadSplit`).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.branches import BRANCHES, repeat_kv, sdpa
from repro_torch.core.bsa import bsa_attention, bsa_attention_varlen, bsa_init
from repro_torch.core.erwin import erwin_attention
from repro_torch.core.full_attention import full_attention
from repro_torch.core.nsa_causal import (init_decode_cache, init_paged_decode_cache,
                                         nsa_causal_attention, nsa_causal_decode,
                                         nsa_causal_decode_paged)
from repro_torch.distributed import comm, tensor_parallel
from repro_torch.distributed.sharding import current_rules, logical_to_spec
from repro_torch.layers.nn import Dense, dense, row_dense
from repro_torch.layers.rope import rope_angles, rotate
from repro_torch.numerics import mask_to_bias

__all__ = ["MECHANISMS", "AttentionLayer", "HeadSplit", "attention_layer_apply",
           "cross_attention_apply", "memory_kv", "attention_cache_init", "attention_paged_cache_init", "attention_layer_decode",
           "attention_layer_decode_paged"]

MECHANISMS = ("bsa", "full", "erwin")


class AttentionLayer(nn.Module):
    """``wq``, ``wk``, ``wv``, ``wo``, and the ``bsa`` parameters (φ
    operators, gates) when the mechanism is BSA."""

    def __init__(self, mcfg, *, generator: torch.Generator, dtype=torch.float32,
                 device=None):
        super().__init__()
        if mcfg.attention not in MECHANISMS:
            raise ValueError(f"attention={mcfg.attention!r}: must be one of {MECHANISMS}")
        d = mcfg.d_model
        hd = mcfg.resolved_head_dim
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.wq = Dense(d, mcfg.n_heads * hd, **kw)
        self.wk = Dense(d, mcfg.n_kv_heads * hd, **kw)
        self.wv = Dense(d, mcfg.n_kv_heads * hd, **kw)
        self.wo = Dense(mcfg.n_heads * hd, d, **kw)
        if mcfg.attention == "bsa":
            self.bsa = bsa_init(mcfg.bsa, n_heads=mcfg.n_heads,
                                n_kv_heads=mcfg.n_kv_heads, head_dim=hd, d_model=d, **kw)


def _project(p: AttentionLayer, x, mcfg, positions=None, rope: bool = True):
    """q (B, N, Hq, hd), k, v (B, N, Hkv, hd); RoPE on q and k at
    ``positions`` (B, N) when given."""
    B, N, _ = x.shape
    hd = mcfg.resolved_head_dim
    q = dense(p.wq, x).reshape(B, N, mcfg.n_heads, hd)
    k = dense(p.wk, x).reshape(B, N, mcfg.n_kv_heads, hd)
    v = dense(p.wv, x).reshape(B, N, mcfg.n_kv_heads, hd)
    if rope and positions is not None:
        cos, sin = rope_angles(positions, hd, mcfg.rope_theta)
        q, k = rotate(q, cos, sin), rotate(k, cos, sin)
    return q, k, v


def _attend(bsa, q, k, v, x, *, mcfg, causal, mask, erwin_level, offsets,
            score_reduce=None):
    """The mechanism on projected q (B, N, Hq, hd), k, v (B, N, Hkv, hd):
    (B, N, Hq, hd).  ``bsa``: the BSA parameters; ``x``: the layer input
    (token gates); ``score_reduce``: see ``core.bsa.bsa_attention``."""
    B = q.shape[0]
    if offsets is not None:
        if mcfg.attention != "bsa" or causal:
            raise NotImplementedError(
                "packed-varlen offsets are only supported by non-causal BSA "
                f"(got attention={mcfg.attention!r}, causal={causal})")
        if B != 1:
            raise ValueError(f"packed-varlen input must be a single packed row, got B={B}")
        return bsa_attention_varlen(bsa, q[0], k[0], v[0], cfg=mcfg.bsa, offsets=offsets,
                                    mask=None if mask is None else mask[0], x=x[0],
                                    score_reduce=score_reduce)[None]
    if mcfg.attention == "bsa":
        fn = nsa_causal_attention if causal else bsa_attention
        return fn(bsa, q, k, v, cfg=mcfg.bsa, mask=mask, x=x, score_reduce=score_reduce)
    if mcfg.attention == "erwin":
        return erwin_attention(q, k, v, ball_size=mcfg.bsa.ball_size, level=erwin_level,
                               mask=mask, backend=mcfg.bsa.backend)
    return full_attention(q, k, v, mask=mask, causal=causal, backend=mcfg.bsa.backend)


def attention_layer_apply(p: AttentionLayer, x: torch.Tensor, *, mcfg,
                          causal: bool = False, mask=None, positions=None,
                          rope: bool = True, erwin_level: int = 0,
                          offsets=None) -> torch.Tensor:
    """Full-sequence forward.  x: (B, N, d_model) → (B, N, d_model).

    ``causal`` runs the causal form (BSA: ``nsa_causal_attention``; full:
    token-causal) with RoPE at ``positions``; otherwise the non-causal
    mechanism: BSA, full attention with ``mask`` as the key mask, or Erwin
    at ``erwin_level``.  ``offsets`` (S+1,) int32 on the host switches
    non-causal BSA to the packed-varlen layout: x must then be one packed
    row (B == 1) whose samples lie back to back at ball-size boundaries,
    and ``mask``'s row marks real tokens; other mechanisms raise.

    Where the layer's weights are cut over ``model``
    (``distributed/tensor_parallel.py``), the rank computes its own heads
    (:class:`HeadSplit`), or, where the cut does not fall on query heads,
    the whole layer on gathered weights (JAX's replication fallback)."""
    B, N, _ = x.shape
    kw = dict(mcfg=mcfg, causal=causal, mask=mask, erwin_level=erwin_level, offsets=offsets)
    if any(tensor_parallel.cut_dim(t) is not None for t in p.parameters()):
        split = HeadSplit(mcfg, p, tensor_parallel.axis())
        if split.hq:
            return split.apply(p, x, positions=positions, rope=rope, **kw)
        p = tensor_parallel.whole(split.ax, p)
    q, k, v = _project(p, x, mcfg, positions, rope)
    out = _attend(p.bsa if mcfg.attention == "bsa" else None, q, k, v, x, **kw)
    return dense(p.wo, out.reshape(B, N, mcfg.n_heads * mcfg.resolved_head_dim))


class HeadSplit:
    """This rank's heads of an attention layer whose projections are cut
    over ``model``.

    Where the query heads divide over the axis and a rank's share of them
    covers whole GQA groups or lies inside one (``hq`` > 0: this rank's
    ``hq`` of them, from ``q0``), wq / wk / wv are column products and wo a
    row product.  The rank's query heads read the kv heads from ``kv0``
    (``rep`` query heads each): its own part of wk / wv where the kv heads
    divide too, else the whole k and v, all-gathered after the column
    product and narrowed.  Then a GQA group straddles ranks, and the
    selection scores, a sum over the group's query heads, are summed over
    ``model`` (:meth:`reduce_scores`); else top-k needs no collective.  φ
    and the gates are replicated weights in head-split compute
    (``tensor_parallel.shared``).  ``hq`` == 0: the cut falls elsewhere (inside
    a query head), and the layer runs whole on every rank."""

    def __init__(self, mcfg, p, ax):
        Hq, Hkv = mcfg.n_heads, mcfg.n_kv_heads
        self.ax, self.hd, self.n_kv = ax, mcfg.resolved_head_dim, Hkv
        cut = tensor_parallel.cut_dim
        hq, group = Hq // ax.size, Hq // Hkv
        split = (cut(p.wq.w) == 0 and cut(p.wk.w) == 0 and Hq % ax.size == 0
                 and (hq % group == 0 or group % hq == 0))
        self.hq = hq if split else 0
        if not split:                    # JAX's one-shot warning of the fallback
            mesh, rules = current_rules()
            logical_to_spec(("heads",), (Hq,), mesh, rules)
            return
        self.q0 = ax.index * hq
        self.kv0, kv = self.q0 // group, max(hq // group, 1)
        self.rep = hq // kv
        self.own_kv = Hkv % ax.size == 0
        self.split_groups = self.rep != group

    def kv(self, w, xc):
        """This rank's kv heads of the column product of ``w`` on ``xc``."""
        B, N, _ = xc.shape
        t = dense(w, xc)
        if self.own_kv:
            return t.reshape(B, N, -1, self.hd)
        t = tensor_parallel.gather_summed(self.ax, -1, t).reshape(B, N, self.n_kv, self.hd)
        return t.narrow(2, self.kv0, self.hq // self.rep)

    def reduce_scores(self, s: torch.Tensor) -> torch.Tensor:
        """Selection scores (B, M, kv, NB) of this rank's query heads → the
        whole groups' (the sum over every rank's heads of each kv head);
        no gradient (they feed top-k)."""
        full = s.new_zeros((*s.shape[:2], self.n_kv, s.shape[-1]))
        full.narrow(2, self.kv0, s.shape[2]).copy_(s.detach())
        return comm.all_reduce_sum(full, self.ax).narrow(2, self.kv0, s.shape[2])

    def _bsa(self, p):
        """φ and the gates: the gradient summed over ``model``, the gates
        narrowed to this rank's query heads."""
        bsa = tensor_parallel.shared(self.ax, p)
        g = bsa.gates
        if getattr(g, "proj", None) is not None:     # token gates: rows (3, Hq, ·)
            H = g.proj.w.shape[0] // 3
            g.proj.w = g.proj.w.reshape(3, H, -1).narrow(1, self.q0, self.hq).reshape(
                3 * self.hq, -1)
            g.proj.b = g.proj.b.reshape(3, H).narrow(1, self.q0, self.hq).reshape(-1)
        else:
            for b in BRANCHES:
                setattr(g, b, getattr(g, b).narrow(0, self.q0, self.hq))
        return bsa

    def apply(self, p, x, *, mcfg, positions, rope, **kw):
        B, N, _ = x.shape
        xc = tensor_parallel.copy_to_model(self.ax, x)
        q = dense(p.wq, xc).reshape(B, N, self.hq, self.hd)
        k, v = self.kv(p.wk, xc), self.kv(p.wv, xc)
        if rope and positions is not None:
            cos, sin = rope_angles(positions, self.hd, mcfg.rope_theta)
            q, k = rotate(q, cos, sin), rotate(k, cos, sin)
        bsa = self._bsa(p.bsa) if mcfg.attention == "bsa" else None
        out = _attend(bsa, q, k, v, xc, mcfg=mcfg,
                      score_reduce=self.reduce_scores if self.split_groups else None, **kw)
        return row_dense(p.wo, out.reshape(B, N, self.hq * self.hd))


def _cross_heads(p: AttentionLayer, mcfg):
    """(this rank's :class:`HeadSplit` of a cross-attention layer whose
    projections are cut over ``model``, else None; the layer's weights to
    compute with: its own, or, where the cut falls inside a query head,
    gathered whole, as :func:`attention_layer_apply` does).  Its ``bsa``
    parameters are never read (their gradient stays None)."""
    if all(tensor_parallel.cut_dim(getattr(p, w).w) is None for w in ("wq", "wk", "wv", "wo")):
        return None, p
    split = HeadSplit(mcfg, p, tensor_parallel.axis())
    if split.hq:
        return split, p
    return None, tensor_parallel.whole(split.ax, p)


def cross_attention_apply(p: AttentionLayer, x, memory_kv, *, mcfg,
                          mem_mask=None) -> torch.Tensor:
    """Cross-attention of x (B, N, d) to precomputed memory K/V, a (B, L,
    Hkv, D) pair: ``full_attention``, non-causal, ``mem_mask`` (B, L) bool
    as key validity, no RoPE.  Where the projections are cut over
    ``model``: this rank's query heads (wq a column product) against its
    kv heads of ``memory_kv`` (:func:`memory_kv`'s), wo a row product."""
    B, N, _ = x.shape
    hd = mcfg.resolved_head_dim
    split, p = _cross_heads(p, mcfg)
    mk, mv = memory_kv
    if split is not None:
        q = dense(p.wq, tensor_parallel.copy_to_model(split.ax, x)).reshape(B, N, split.hq, hd)
        out = full_attention(q, mk, mv, mask=mem_mask, causal=False, backend=mcfg.bsa.backend)
        return row_dense(p.wo, out.reshape(B, N, split.hq * hd))
    q = dense(p.wq, x).reshape(B, N, mcfg.n_heads, hd)
    out = full_attention(q, mk, mv, mask=mem_mask, causal=False, backend=mcfg.bsa.backend)
    return dense(p.wo, out.reshape(B, N, mcfg.n_heads * hd))


def memory_kv(p: AttentionLayer, memory, *, mcfg) -> tuple:
    """Cross-attention K/V of the encoder output (B, L, d): a (B, L, Hkv, D)
    pair; where the projections are cut over ``model``, the kv heads of
    this rank's query heads (wk / wv column products; all-gathered and
    narrowed where the cut falls inside a kv head, as
    :class:`HeadSplit` does)."""
    B, L, _ = memory.shape
    hd = mcfg.resolved_head_dim
    split, p = _cross_heads(p, mcfg)
    if split is not None:
        mc = tensor_parallel.copy_to_model(split.ax, memory)
        return split.kv(p.wk, mc), split.kv(p.wv, mc)
    return (dense(p.wk, memory).reshape(B, L, mcfg.n_kv_heads, hd),
            dense(p.wv, memory).reshape(B, L, mcfg.n_kv_heads, hd))


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def attention_cache_init(mcfg, batch: int, max_len: int, dtype, device=None) -> dict:
    """BSA: ``init_decode_cache``; other mechanisms: dense K/V of (batch,
    max_len, Hkv, D) and a shared length."""
    hd = mcfg.resolved_head_dim
    if mcfg.attention == "bsa":
        return init_decode_cache(batch, max_len, mcfg.n_kv_heads, hd, mcfg.bsa,
                                 dtype=dtype, device=device)
    kw = dict(dtype=dtype, device=device)
    return {"k": torch.zeros((batch, max_len, mcfg.n_kv_heads, hd), **kw),
            "v": torch.zeros((batch, max_len, mcfg.n_kv_heads, hd), **kw),
            "length": torch.zeros((), dtype=torch.int64, device=device)}


def attention_paged_cache_init(mcfg, num_blocks: int, page: int, dtype,
                               device=None) -> dict:
    """Flat paged pools of one layer (+1 trash block): token and compressed
    pools for BSA, token pools for the other mechanisms.  Every layer's
    pools have the same block layout, so one host block table serves the
    stack."""
    hd = mcfg.resolved_head_dim
    if mcfg.attention == "bsa":
        return init_paged_decode_cache(num_blocks, page, mcfg.n_kv_heads, hd, mcfg.bsa,
                                       dtype=dtype, device=device)
    R = (num_blocks + 1) * page
    kw = dict(dtype=dtype, device=device)
    return {"k": torch.zeros((R, mcfg.n_kv_heads, hd), **kw),
            "v": torch.zeros((R, mcfg.n_kv_heads, hd), **kw)}


def _attend_cache(q, k_all, v_all, valid, mcfg):
    """q (B, 1, Hq, D) against every cached row k_all / v_all (B, L, Hkv, D)
    where ``valid`` (B, L): the plain ``sdpa`` of the dense cached path."""
    rep = mcfg.n_heads // mcfg.n_kv_heads
    out = sdpa(q.transpose(1, 2),
               repeat_kv(k_all.to(q.dtype), rep).transpose(1, 2),
               repeat_kv(v_all.to(q.dtype), rep).transpose(1, 2),
               mask_to_bias(valid[:, None, None, :]))
    return out.transpose(1, 2)


def attention_layer_decode_paged(p: AttentionLayer, x1, cache, table, lengths, *, mcfg,
                                 page: int, rope: bool = True, step=None):
    """One-token decode against paged pools with per-slot lengths: x1
    (B, 1, d); ``table`` (B, n_pages); ``lengths`` (B,) — RoPE turns each
    slot's query and key by its own position.  ``step``: the step's
    ``nsa_causal.paged_step``, shared by the layers.  Returns (out
    (B, 1, d), cache)."""
    B = x1.shape[0]
    q, k, v = _project(p, x1, mcfg, lengths[:, None] if rope else None, rope)
    if mcfg.attention == "bsa":
        out, cache = nsa_causal_decode_paged(p.bsa, q, k, v, cache, table, lengths,
                                             cfg=mcfg.bsa, page=page, x1=x1, step=step)
    else:
        capacity = table.shape[1] * page
        wrow = table.gather(1, (lengths // page)[:, None].long())[:, 0] * page + lengths % page
        cache["k"][wrow.long()] = k[:, 0].to(cache["k"].dtype)
        cache["v"][wrow.long()] = v[:, 0].to(cache["v"].dtype)
        apos = torch.arange(capacity, device=x1.device)[None].expand(B, capacity)
        rows = (table.long().gather(1, apos // page) * page + apos % page)
        out = _attend_cache(q, cache["k"][rows], cache["v"][rows],
                            apos <= lengths[:, None], mcfg)
    return dense(p.wo, out.reshape(B, 1, mcfg.n_heads * mcfg.resolved_head_dim)), cache


def attention_layer_decode(p: AttentionLayer, x1, cache, *, mcfg, rope: bool = True,
                           step=None):
    """One-token decode over the dense cache: x1 (B, 1, d) at position
    ``cache["length"]`` → (out (B, 1, d), cache).  ``step``: the step's
    ``nsa_causal.dense_step``, shared by the layers."""
    B = x1.shape[0]
    t = cache["length"]
    q, k, v = _project(p, x1, mcfg, t.expand(B, 1) if rope else None, rope)
    if mcfg.attention == "bsa":
        out, cache = nsa_causal_decode(p.bsa, q, k, v, cache, cfg=mcfg.bsa, x1=x1, step=step)
    else:
        cache["k"][:, t] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, t] = v[:, 0].to(cache["v"].dtype)
        S = cache["k"].shape[1]
        valid = (torch.arange(S, device=x1.device) <= t)[None].expand(B, S)
        out = _attend_cache(q, cache["k"], cache["v"], valid, mcfg)
        cache = {**cache, "length": t + 1}
    return dense(p.wo, out.reshape(B, 1, mcfg.n_heads * mcfg.resolved_head_dim)), cache
