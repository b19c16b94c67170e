"""Plain-PyTorch oracles of the four forward kernels, in the core layout.

Counterpart of ``repro/kernels/ref.py``.  Each returns what its kernel
returns, the logsumexp residual included, for inputs in the ``core`` tensor
convention (q (B, N, Hq, D), k/v (B, L, Hkv, D)); the GQA layouts of the
kernels stay in ``kernels/ops.py``.  lse is (B, N, Hq) fp32.
"""

from __future__ import annotations

import torch

from repro_torch.core.branches import gated_combine_ref, repeat_kv, sdpa
from repro_torch.core.bsa import ball_attention_ref
from repro_torch.kernels.flash import visible_keys
from repro_torch.kernels.occupancy import invalidate_dead_groups
from repro_torch.numerics import mask_to_bias

__all__ = ["ball_attention_ref", "flash_attention_ref", "selection_attention_ref",
           "gated_combine_ref"]


def flash_attention_ref(q, k, v, *, key_valid=None, causal=False,
                        block_causal=False, ell=1):
    """(o, lse) of ``ops.flash_attention``.  q: (B, N, Hq, D), k/v:
    (B, L, Hkv, D)."""
    B, N, Hq, D = q.shape
    L = k.shape[1]
    rep = Hq // k.shape[2]
    bias = torch.zeros((B, 1, 1, L), dtype=torch.float32, device=q.device)
    if key_valid is not None:
        bias = bias + mask_to_bias(key_valid[:, None, None, :])
    ok = visible_keys(N, L, causal=causal, block_causal=block_causal, ell=ell,
                      device=q.device)
    if ok is not None:
        bias = bias + mask_to_bias(ok)[None, None]
    o, lse = sdpa(q.transpose(1, 2), repeat_kv(k, rep).transpose(1, 2),
                  repeat_kv(v, rep).transpose(1, 2), bias, return_lse=True)
    return o.transpose(1, 2), lse.transpose(1, 2)


def selection_attention_ref(q, k, v, top_idx, sel_valid, mask, *,
                            block_size: int):
    """(o, lse) of ``ops.selection_attention``, dead-group invalidation
    included (all-padding query groups attend nothing)."""
    sel_valid = invalidate_dead_groups(sel_valid, mask, q.shape[1])
    B, N, Hq, D = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    ell = block_size
    nb = N // ell
    G = top_idx.shape[1]
    g = N // G
    k_star = top_idx.shape[-1]
    safe = torch.where(sel_valid, top_idx, torch.zeros_like(top_idx)).long()
    bidx = torch.arange(B, device=q.device)[:, None, None, None]
    hidx = torch.arange(Hkv, device=q.device)[None, None, :, None]
    kg = k.reshape(B, nb, ell, Hkv, D)[bidx, safe, :, hidx, :]   # (B,G,Hkv,k*,ℓ,D)
    vg = v.reshape(B, nb, ell, Hkv, D)[bidx, safe, :, hidx, :]
    key_valid = sel_valid[..., None].expand(B, G, Hkv, k_star, ell)
    if mask is not None:
        key_valid = key_valid & mask.reshape(B, nb, ell)[bidx, safe]
    bias = mask_to_bias(key_valid.reshape(B, G, Hkv, 1, 1, k_star * ell))
    qg = q.reshape(B, G, g, Hkv, rep, D).permute(0, 1, 3, 4, 2, 5)  # (B,G,Hkv,rep,g,D)
    o, lse = sdpa(qg, kg.reshape(B, G, Hkv, 1, k_star * ell, D),
                  vg.reshape(B, G, Hkv, 1, k_star * ell, D), bias, return_lse=True)
    o = o.permute(0, 1, 4, 2, 3, 5).reshape(B, N, Hq, D)
    lse = lse.permute(0, 1, 4, 2, 3).reshape(B, N, Hq)
    return o, lse
