"""Layout wrappers between the core tensor convention (B, N, H, D) and the
kernels' GQA-grouped (B·Hkv, rep, N, D) / blocked layouts.

Counterpart of ``repro/kernels/ops.py`` (``ball_attention``,
``flash_attention``, ``selection_attention``, ``gated_combine`` and the
packed-varlen ``flash_attention_varlen``, ``ball_attention_varlen``,
``selection_attention_varlen``); these are what the ``"kernels"`` backend
dispatches to.  The contract is the JAX
one: q (B, N, Hq, D), k/v (B, L, Hkv, D) with Hq = Hkv·rep and query head
h·rep + r belonging to KV head h; masks are (B, L) bool with True = real
and mask KEYS in logit space; ``q_valid`` is an optimisation hint whose
padded rows come back unspecified.  Each wrapper is differentiable: it
calls its kernel's ``torch.autograd.Function``, whose forward launches the
forward kernel and whose backward the backward kernel(s) on CUDA tensors,
and which runs the plain versions on CPU tensors.  Masked keys get exactly
zero gradient.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import bta, epilogue, flash, selection, varlen
from repro_torch.kernels.occupancy import invalidate_dead_groups, varlen_maps
from repro_torch.numerics import key_padding_bias, mask_to_bias

__all__ = ["ball_attention", "flash_attention", "selection_attention",
           "gated_combine", "flash_attention_varlen", "ball_attention_varlen",
           "selection_attention_varlen"]


def _to_bh(t):
    """(B, L, Hkv, D) → (B·Hkv, L, D): one K/V stream per KV head
    (contiguous: at B = 1 the reshape alone would be a strided view)."""
    B, L, H, D = t.shape
    return t.transpose(1, 2).reshape(B * H, L, D).contiguous()


def _to_grouped(q, Hkv):
    """(B, N, Hq, D) → (B·Hkv, rep, N, D)."""
    B, N, Hq, D = q.shape
    rep = Hq // Hkv
    return (q.reshape(B, N, Hkv, rep, D).permute(0, 2, 3, 1, 4)
             .reshape(B * Hkv, rep, N, D).contiguous())


def _from_grouped(o, B, Hkv):
    BH, rep, N, D = o.shape
    return o.reshape(B, Hkv, rep, N, D).permute(0, 3, 1, 2, 4).reshape(B, N, Hkv * rep, D)


def ball_attention(q, k, v, mask, ball_size: int):
    """Ball-Tree Attention: full attention inside each contiguous ball.
    ``mask``: (B, N) bool or None.  Returns (B, N, Hq, D)."""
    B, N, Hq, D = q.shape
    Hkv = k.shape[2]
    kb = key_padding_bias(mask, B, N, device=q.device)
    o = bta.BallAttentionFn.apply(_to_grouped(q, Hkv), _to_bh(k), _to_bh(v), kb,
                                  ball_size, Hkv)
    return _from_grouped(o, B, Hkv)


def flash_attention(q, k, v, *, key_valid=None, causal=False, block_causal=False,
                    ell=1, q_valid=None):
    """Streaming-softmax attention of q against K/V of any length L.
    ``key_valid``: (B, L) bool; ``causal`` / ``block_causal`` as in the
    kernel (block-causal: query t sees coarse key j iff (j+1)·ℓ − 1 < t).
    The ragged key edge is masked inside the kernel: nothing is padded.
    Returns (B, N, Hq, D)."""
    B, N, Hq, D = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    if causal and L != N:
        raise ValueError("token-causal flash needs aligned queries and keys "
                         f"(N={N}, L={L})")
    kb = key_padding_bias(key_valid, B, L, device=q.device)
    o = flash.FlashAttentionFn.apply(_to_grouped(q, Hkv), _to_bh(k), _to_bh(v), kb,
                                     q_valid, Hkv, causal, block_causal, ell)
    return _from_grouped(o, B, Hkv)


def selection_attention(q, k, v, top_idx, sel_valid, mask, *, block_size: int,
                        group_size: int, q_valid=None):
    """Group-selected sparse attention.  ``top_idx`` / ``sel_valid``:
    (B, G, Hkv, k*); invalid selections go to the kernel as index −1, and
    every selection of an all-padding query group is invalidated first.
    ``mask``: (B, L) bool token validity of the keys or None.  Returns
    (B, N, Hq, D)."""
    B, N, Hq, D = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    ell = block_size
    nb = k.shape[1] // ell
    G = top_idx.shape[1]
    g = N // G
    qg = (q.reshape(B, G, g, Hkv, rep, D).permute(0, 3, 1, 2, 4, 5)
           .reshape(B, Hkv, G, g * rep, D))
    kb = k.reshape(B, nb, ell, Hkv, D).permute(0, 3, 1, 2, 4).contiguous()
    vb = v.reshape(B, nb, ell, Hkv, D).permute(0, 3, 1, 2, 4).contiguous()
    sel_valid = invalidate_dead_groups(
        sel_valid, q_valid if q_valid is not None else mask, N)
    idx = torch.where(sel_valid, top_idx, torch.full_like(top_idx, -1))
    idx = idx.to(torch.int32).permute(0, 2, 1, 3).contiguous()   # (B,Hkv,G,k*)
    if mask is None:
        tok_bias = torch.zeros((B, nb, ell), dtype=torch.float32, device=q.device)
    else:
        tok_bias = mask_to_bias(mask.reshape(B, nb, ell))
    o = selection.SelectionAttentionFn.apply(qg.contiguous(), kb, vb, idx, tok_bias)
    return (o.reshape(B, Hkv, G, g, rep, D).permute(0, 2, 3, 1, 4, 5)
             .reshape(B, N, Hq, D))


def gated_combine(outs, gates, mask):
    """Fused gate-and-mask epilogue over the three branch outputs.
    ``outs``: three (B, N, H, D) tensors; ``gates``: three fp32 tensors
    broadcastable to (B, N, H, 1) (per-head gates are expanded to rows here
    and their row gradients sum back through the expand); ``mask``: (B, N)
    bool or None.  Returns (B, N, H, D) in ``outs[0].dtype``."""
    o1, o2, o3 = outs
    B, N, H, D = o1.shape
    R = B * N * H
    g1, g2, g3 = (g.float().expand(B, N, H, 1).reshape(R) for g in gates)
    if mask is None:
        m = torch.ones(R, dtype=torch.float32, device=o1.device)
    else:
        m = mask[:, :, None].expand(B, N, H).reshape(R).float()
    out = epilogue.GatedCombineFn.apply(*(o.reshape(R, D) for o in (o1, o2, o3)),
                                        g1, g2, g3, m)
    return out.reshape(B, N, H, D)


# ---------------------------------------------------------------------------
# Packed-varlen wrappers.  No batch dim: all samples lie on one packed axis,
# q (T, Hq, D), k/v (L, Hkv, D), with host ``offsets`` (S+1,) int32 marking
# the sample boundaries (every entry a multiple of the ball size; trailing
# repeats are empty segments).  ``mask`` / ``key_valid`` is the packed (T,)
# / (L,) bool validity.
# ---------------------------------------------------------------------------

def flash_attention_varlen(q, k, v, q_offsets, k_offsets, *, key_valid=None):
    """Packed-varlen streaming-softmax attention: segment i of the queries
    (``q_offsets``) attends only segment i of the keys (``k_offsets``; the
    compression branch passes ``offsets // ℓ`` for its pooled keys), and the
    capacity tail only the tail.  ``key_valid``: (L,) bool.  The offsets stay
    on the host; their device maps are built once per layout
    (``occupancy.varlen_maps``).  Returns (T, Hq, D)."""
    T, Hq, D = q.shape
    L, Hkv, _ = k.shape
    maps = varlen_maps(q_offsets, k_offsets, T, L, q.device)
    kb = key_padding_bias(None if key_valid is None else key_valid[None], 1, L,
                          device=q.device)
    o = varlen.VarlenAttentionFn.apply(
        _to_grouped(q[None], Hkv), _to_bh(k[None]), _to_bh(v[None]), kb,
        maps.qseg[None], maps.kseg[None], maps.q_bounds, maps.k_bounds)
    return _from_grouped(o, 1, Hkv)[0]


def ball_attention_varlen(q, k, v, offsets, mask, ball_size: int):
    """Packed-varlen Ball-Tree Attention.  Every offset is a multiple of
    ``ball_size``, so no ball straddles two samples: this is
    :func:`ball_attention` at B = 1.  ``mask``: (T,) bool or None.  Returns
    (T, Hq, D)."""
    return ball_attention(q[None], k[None], v[None],
                          None if mask is None else mask[None], ball_size)[0]


def selection_attention_varlen(q, k, v, top_idx, sel_valid, offsets, mask, *,
                               block_size: int, group_size: int):
    """Packed-varlen group-selected sparse attention.  ``top_idx`` /
    ``sel_valid``: (G, Hkv, k*) global block indices on the packed axis;
    samples are kept apart upstream (the selection scores mask other
    segments' blocks), so this is :func:`selection_attention` at B = 1;
    ``offsets`` is part of the signature for uniformity.  Returns
    (T, Hq, D)."""
    return selection_attention(q[None], k[None], v[None], top_idx[None],
                               sel_valid[None], None if mask is None else mask[None],
                               block_size=block_size, group_size=group_size)[0]
