"""Layout wrappers between the core tensor convention (B, N, H, D) and the
kernels' GQA-grouped (B·Hkv, rep, N, D) / blocked layouts.

Counterpart of ``repro/kernels/ops.py`` (``ball_attention``,
``flash_attention``, ``selection_attention``, ``gated_combine``); these are
what the ``"kernels"`` backend dispatches to.  The contract is the JAX
one: q (B, N, Hq, D), k/v (B, L, Hkv, D) with Hq = Hkv·rep and query head
h·rep + r belonging to KV head h; masks are (B, L) bool with True = real
and mask KEYS in logit space; ``q_valid`` is an optimisation hint whose
padded rows come back unspecified.  Each wrapper launches one kernel on
CUDA tensors and runs that kernel's plain version on CPU tensors.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import bta, epilogue, flash, selection
from repro_torch.kernels.occupancy import invalidate_dead_groups
from repro_torch.numerics import key_padding_bias, mask_to_bias

__all__ = ["ball_attention", "flash_attention", "selection_attention",
           "gated_combine"]


def _to_bh(t):
    """(B, L, Hkv, D) → (B·Hkv, L, D): one K/V stream per KV head."""
    B, L, H, D = t.shape
    return t.transpose(1, 2).reshape(B * H, L, D)


def _to_grouped(q, Hkv):
    """(B, N, Hq, D) → (B·Hkv, rep, N, D)."""
    B, N, Hq, D = q.shape
    rep = Hq // Hkv
    return q.reshape(B, N, Hkv, rep, D).permute(0, 2, 3, 1, 4).reshape(B * Hkv, rep, N, D)


def _from_grouped(o, B, Hkv):
    BH, rep, N, D = o.shape
    return o.reshape(B, Hkv, rep, N, D).permute(0, 3, 1, 2, 4).reshape(B, N, Hkv * rep, D)


def ball_attention(q, k, v, mask, ball_size: int):
    """Ball-Tree Attention: full attention inside each contiguous ball.
    ``mask``: (B, N) bool or None.  Returns (B, N, Hq, D)."""
    B, N, Hq, D = q.shape
    Hkv = k.shape[2]
    kb = key_padding_bias(mask, B, N, device=q.device)
    o, _ = bta.ball_attention_fwd(_to_grouped(q, Hkv), _to_bh(k), _to_bh(v), kb,
                                  ball_size=ball_size, n_heads=Hkv)
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
    o, _ = flash.flash_attention_fwd(
        _to_grouped(q, Hkv), _to_bh(k), _to_bh(v), kb, q_valid, n_heads=Hkv,
        causal=causal, block_causal=block_causal, ell=ell)
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
    o, _ = selection.selection_attention_fwd(qg.contiguous(), kb, vb, idx, tok_bias)
    return (o.reshape(B, Hkv, G, g, rep, D).permute(0, 2, 3, 1, 4, 5)
             .reshape(B, N, Hq, D))


def gated_combine(outs, gates, mask):
    """Fused gate-and-mask epilogue over the three branch outputs.
    ``outs``: three (B, N, H, D) tensors; ``gates``: three fp32 tensors
    broadcastable to (B, N, H, 1); ``mask``: (B, N) bool or None.  Returns
    (B, N, H, D) in ``outs[0].dtype``."""
    o1, o2, o3 = outs
    B, N, H, D = o1.shape
    R = B * N * H
    g1, g2, g3 = (g.float().expand(B, N, H, 1).reshape(R) for g in gates)
    if mask is None:
        m = torch.ones(R, dtype=torch.float32, device=o1.device)
    else:
        m = mask[:, :, None].expand(B, N, H).reshape(R).float()
    out = epilogue.gated_combine_fwd(*(o.reshape(R, D) for o in (o1, o2, o3)),
                                     g1, g2, g3, m)
    return out.reshape(B, N, H, D)
