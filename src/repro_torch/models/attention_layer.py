"""Attention layer: Q/K/V/O projections around non-causal BSA.

Counterpart of ``repro/models/attention_layer.py`` for the path the
point-cloud model runs: no RoPE, non-causal ``bsa_attention``, or
``bsa_attention_varlen`` on a packed batch (``offsets``).  The other
mechanisms (full, Erwin), the causal variant and decoding belong to later
slices of the port.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.bsa import bsa_attention, bsa_attention_varlen, bsa_init
from repro_torch.layers.nn import Dense, dense

__all__ = ["AttentionLayer", "attention_layer_apply"]


class AttentionLayer(nn.Module):
    def __init__(self, mcfg, *, generator: torch.Generator, dtype=torch.float32,
                 device=None):
        super().__init__()
        if mcfg.attention != "bsa":
            raise NotImplementedError(
                f"attention={mcfg.attention!r} is not ported (only 'bsa')")
        d = mcfg.d_model
        hd = mcfg.resolved_head_dim
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.wq = Dense(d, mcfg.n_heads * hd, **kw)
        self.wk = Dense(d, mcfg.n_kv_heads * hd, **kw)
        self.wv = Dense(d, mcfg.n_kv_heads * hd, **kw)
        self.wo = Dense(mcfg.n_heads * hd, d, **kw)
        self.bsa = bsa_init(mcfg.bsa, n_heads=mcfg.n_heads,
                            n_kv_heads=mcfg.n_kv_heads, head_dim=hd, d_model=d, **kw)


def attention_layer_apply(p: AttentionLayer, x: torch.Tensor, *, mcfg,
                          mask=None, offsets=None) -> torch.Tensor:
    """x: (B, N, d_model) → (B, N, d_model) through non-causal BSA.

    ``offsets`` (S+1,) int32 on the host switches to the packed-varlen
    layout: x must then be one packed row (B == 1) whose samples lie back
    to back at ball-size boundaries, and ``mask``'s row marks real tokens."""
    B, N, _ = x.shape
    if offsets is not None and B != 1:
        raise ValueError(f"packed-varlen input must be a single packed row, got B={B}")
    hd = mcfg.resolved_head_dim
    q = dense(p.wq, x).reshape(B, N, mcfg.n_heads, hd)
    k = dense(p.wk, x).reshape(B, N, mcfg.n_kv_heads, hd)
    v = dense(p.wv, x).reshape(B, N, mcfg.n_kv_heads, hd)
    if offsets is not None:
        out = bsa_attention_varlen(p.bsa, q[0], k[0], v[0], cfg=mcfg.bsa,
                                   offsets=offsets,
                                   mask=None if mask is None else mask[0], x=x[0])[None]
    else:
        out = bsa_attention(p.bsa, q, k, v, cfg=mcfg.bsa, mask=mask, x=x)
    return dense(p.wo, out.reshape(B, N, mcfg.n_heads * hd))
