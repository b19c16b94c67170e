"""Attention layer: Q/K/V/O projections, RoPE and the attention mechanism.

Counterpart of ``repro/models/attention_layer.py``.  The mechanism
(``mcfg.attention``) is ``"bsa"``: non-causal ``bsa_attention`` (the
point-cloud model, no RoPE), or ``bsa_attention_varlen`` on a packed batch
(``offsets``); causal ``nsa_causal_attention`` with RoPE (the LM), and its
one-token decode steps over a dense cache (``attention_layer_decode``) or
paged pools (``attention_layer_decode_paged``).  The baselines are
``"full"`` (``full_attention``, non-causal with a key mask or causal) and
``"erwin"`` (``erwin_attention`` at the layer's coarsening level), padded
layout only.  Their dense-cache decode paths and cross-attention belong to
the encoder-decoder family, not ported yet: a decode of a mechanism other
than BSA raises.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.bsa import bsa_attention, bsa_attention_varlen, bsa_init
from repro_torch.core.erwin import erwin_attention
from repro_torch.core.full_attention import full_attention
from repro_torch.core.nsa_causal import (init_decode_cache, init_paged_decode_cache,
                                         nsa_causal_attention, nsa_causal_decode,
                                         nsa_causal_decode_paged)
from repro_torch.layers.nn import Dense, dense
from repro_torch.layers.rope import rope_angles, rotate

__all__ = ["MECHANISMS", "AttentionLayer", "attention_layer_apply",
           "attention_cache_init", "attention_paged_cache_init", "attention_layer_decode",
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
    and ``mask``'s row marks real tokens; other mechanisms raise."""
    B, N, _ = x.shape
    q, k, v = _project(p, x, mcfg, positions, rope)
    if offsets is not None:
        if mcfg.attention != "bsa" or causal:
            raise NotImplementedError(
                "packed-varlen offsets are only supported by non-causal BSA "
                f"(got attention={mcfg.attention!r}, causal={causal})")
        if B != 1:
            raise ValueError(f"packed-varlen input must be a single packed row, got B={B}")
        out = bsa_attention_varlen(p.bsa, q[0], k[0], v[0], cfg=mcfg.bsa,
                                   offsets=offsets,
                                   mask=None if mask is None else mask[0], x=x[0])[None]
    elif mcfg.attention == "bsa":
        if causal:
            out = nsa_causal_attention(p.bsa, q, k, v, cfg=mcfg.bsa, mask=mask, x=x)
        else:
            out = bsa_attention(p.bsa, q, k, v, cfg=mcfg.bsa, mask=mask, x=x)
    elif mcfg.attention == "erwin":
        out = erwin_attention(q, k, v, ball_size=mcfg.bsa.ball_size, level=erwin_level,
                              mask=mask, backend=mcfg.bsa.backend)
    else:
        out = full_attention(q, k, v, mask=mask, causal=causal, backend=mcfg.bsa.backend)
    return dense(p.wo, out.reshape(B, N, mcfg.n_heads * mcfg.resolved_head_dim))


def _bsa_only(mcfg, what: str) -> None:
    if mcfg.attention != "bsa":
        raise NotImplementedError(
            f"{what} is ported for attention='bsa' only, got {mcfg.attention!r} (the "
            "dense-cache decode of the other mechanisms comes with the "
            "encoder-decoder family)")


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def attention_cache_init(mcfg, batch: int, max_len: int, dtype, device=None) -> dict:
    _bsa_only(mcfg, "the decode cache")
    return init_decode_cache(batch, max_len, mcfg.n_kv_heads, mcfg.resolved_head_dim,
                             mcfg.bsa, dtype=dtype, device=device)


def attention_paged_cache_init(mcfg, num_blocks: int, page: int, dtype,
                               device=None) -> dict:
    """Flat paged pools of one layer (+1 trash block).  Every layer's pools
    have the same block layout, so one host block table serves the stack."""
    _bsa_only(mcfg, "the paged decode cache")
    return init_paged_decode_cache(num_blocks, page, mcfg.n_kv_heads,
                                   mcfg.resolved_head_dim, mcfg.bsa, dtype=dtype,
                                   device=device)


def attention_layer_decode_paged(p: AttentionLayer, x1, cache, table, lengths, *, mcfg,
                                 page: int, rope: bool = True, step=None):
    """One-token decode against paged pools with per-slot lengths: x1
    (B, 1, d); ``table`` (B, n_pages); ``lengths`` (B,) — RoPE turns each
    slot's query and key by its own position.  ``step``: the step's
    ``nsa_causal.paged_step``, shared by the layers.  Returns (out
    (B, 1, d), cache)."""
    B = x1.shape[0]
    q, k, v = _project(p, x1, mcfg, lengths[:, None] if rope else None, rope)
    out, cache = nsa_causal_decode_paged(p.bsa, q, k, v, cache, table, lengths,
                                         cfg=mcfg.bsa, page=page, x1=x1, step=step)
    return dense(p.wo, out.reshape(B, 1, mcfg.n_heads * mcfg.resolved_head_dim)), cache


def attention_layer_decode(p: AttentionLayer, x1, cache, *, mcfg, rope: bool = True,
                           step=None):
    """One-token decode over the dense cache: x1 (B, 1, d) at position
    ``cache["length"]`` → (out (B, 1, d), cache).  ``step``: the step's
    ``nsa_causal.dense_step``, shared by the layers."""
    B = x1.shape[0]
    pos = cache["length"].expand(B, 1)
    q, k, v = _project(p, x1, mcfg, pos if rope else None, rope)
    out, cache = nsa_causal_decode(p.bsa, q, k, v, cache, cfg=mcfg.bsa, x1=x1, step=step)
    return dense(p.wo, out.reshape(B, 1, mcfg.n_heads * mcfg.resolved_head_dim)), cache
