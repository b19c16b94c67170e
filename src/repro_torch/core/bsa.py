"""Ball Sparse Attention (BSA), non-causal form.

Counterpart of ``repro/core/bsa.py`` (``bsa_init``, ``ball_attention_ref``,
``_compression_branch``, ``_selection_scores``, ``_selection_branch``,
``bsa_attention`` and, for the packed-varlen layout,
``bsa_attention_varlen``).  Operates on ball-ordered point sequences: after the
ball-tree permutation every contiguous chunk of ``ball_size`` tokens is a
ball.  Three branches (paper Eq. 9), combined with sigmoid gates:

  * ``ball`` — full attention inside each ball (kernel ``bta``),
  * ``cmp``  — queries against φ-pooled coarse K/V (kernel ``flash``),
  * ``slc``  — per query group, the top-k coarse blocks attended at token
               resolution (kernel ``selection``),

and the gated combine (kernel ``epilogue``).  The JAX version's sharding
hints (``constrain``) have no counterpart on one device and are dropped.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.backend import get_varlen, resolve_branch_backends
from repro_torch.core.branches import (BRANCHES, block_validity, diag_scores,
                                       gate_values, phi_apply, score_dtype_cast,
                                       sdpa)
from repro_torch.core.config import BSAConfig
from repro_torch.kernels.occupancy import segment_ids
from repro_torch.layers.nn import Dense
from repro_torch.numerics import NEG_INF, mask_to_bias

__all__ = ["BSAParams", "bsa_init", "bsa_attention", "bsa_attention_varlen",
           "ball_attention_ref"]


class Phi(nn.Module):
    """Parameters of one φ operator: a positional offset ``pos`` (ℓ, D)."""

    def __init__(self, cfg: BSAConfig, head_dim: int, *, generator, dtype, device):
        super().__init__()
        if cfg.phi != "mean":
            raise NotImplementedError(f"phi={cfg.phi!r} is not ported (only 'mean')")
        pos = torch.randn((cfg.cmp_block, head_dim), generator=generator) * 0.02
        self.pos = nn.Parameter(pos.to(dtype=dtype, device=device))


class Gates(nn.Module):
    """Scalar mode: per-head logits ``ball`` / ``cmp`` / ``slc`` (zeros, so
    every gate starts at ½).  Token mode: a ``proj`` dense d_model → 3H."""

    def __init__(self, cfg: BSAConfig, n_heads: int, d_model: int, *, generator,
                 dtype, device):
        super().__init__()
        if cfg.gate_mode == "scalar":
            for b in BRANCHES:
                setattr(self, b, nn.Parameter(
                    torch.zeros(n_heads, dtype=dtype, device=device)))
        else:
            self.proj = Dense(d_model, 3 * n_heads, generator=generator, scale=0.02,
                              bias=True, dtype=dtype, device=device)


class BSAParams(nn.Module):
    """φ operators and gates of one BSA layer (keys as in the JAX pytree)."""

    def __init__(self, cfg: BSAConfig, *, n_heads: int, head_dim: int, d_model: int,
                 generator: torch.Generator, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.phi_k = Phi(cfg, head_dim, **kw)
        self.phi_v = Phi(cfg, head_dim, **kw)
        self.gates = Gates(cfg, n_heads, d_model, **kw)
        if cfg.query_cmp_selection or cfg.group_compression:
            self.phi_q = Phi(cfg, head_dim, **kw)


def bsa_init(cfg: BSAConfig, *, n_heads: int, n_kv_heads: int, head_dim: int,
             d_model: int, generator: torch.Generator, dtype=torch.float32,
             device=None) -> BSAParams:
    return BSAParams(cfg, n_heads=n_heads, head_dim=head_dim, d_model=d_model,
                     generator=generator, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Branch 1 — Ball-Tree Attention (block-diagonal)
# ---------------------------------------------------------------------------

def ball_attention_ref(q, k, v, mask, ball_size: int, *, return_lse: bool = False):
    """Full attention within each contiguous ball (equal head counts).
    q, k, v: (B, N, H, D); mask (B, N) bool or None.  Returns (B, N, H, D),
    and with ``return_lse`` also lse (B, N, H)."""
    B, N, H, D = q.shape
    m = ball_size
    if N % m:
        raise ValueError(f"N={N} not a multiple of ball_size={m}")
    nb = N // m

    def balls(t):
        return t.reshape(B, nb, m, H, D).permute(0, 1, 3, 2, 4)   # (B,nb,H,m,D)

    bias = mask_to_bias(mask.reshape(B, nb, 1, 1, m)) if mask is not None else None
    out = sdpa(balls(q), balls(k), balls(v), bias, return_lse=return_lse)
    if not return_lse:
        return out.permute(0, 1, 3, 2, 4).reshape(B, N, H, D)
    o, lse = out
    return (o.permute(0, 1, 3, 2, 4).reshape(B, N, H, D),
            lse.permute(0, 1, 3, 2).reshape(B, N, H))


# ---------------------------------------------------------------------------
# Branch 2 — Compression
# ---------------------------------------------------------------------------

def _compression_branch(params, q, k, v, mask, cfg: BSAConfig, backend):
    """Returns (out (B, N, Hq, D), k_cmp, v_cmp, blk_valid)."""
    B, N, Hq, D = q.shape
    k_cmp = phi_apply(params.phi_k, k, mask, cfg)                 # (B,NB,Hkv,D)
    v_cmp = phi_apply(params.phi_v, v, mask, cfg)
    blk_valid = block_validity(mask, B, N, cfg.cmp_block, device=q.device)
    if cfg.group_compression:
        # Eq. 15: pool the queries too; attend at block level; un-pool ℓ×
        nb = N // cfg.cmp_block
        q_cmp = phi_apply(params.phi_q, q, mask, cfg)
        out_c = backend.flash(q_cmp, k_cmp, v_cmp, key_valid=blk_valid,
                              chunk_tokens=cfg.jnp_chunk_tokens,
                              q_valid=None if mask is None else blk_valid)
        out = out_c[:, :, None].expand(B, nb, cfg.cmp_block, Hq, D).reshape(B, N, Hq, D)
        return out, k_cmp, v_cmp, blk_valid
    out = backend.flash(q, k_cmp, v_cmp, key_valid=blk_valid,
                        chunk_tokens=cfg.jnp_chunk_tokens, q_valid=mask)
    return out, k_cmp, v_cmp, blk_valid


# ---------------------------------------------------------------------------
# Branch 3 — Selection
# ---------------------------------------------------------------------------

def _selection_scores(params, q, k_cmp, blk_valid, mask, cfg: BSAConfig, q_seg=None):
    """Group-level importance scores (B, G, Hkv, NB) fp32, already masked
    (invalid block / own ball).

    ``q_seg``: (N,) int32 segment ids of a packed-varlen axis (B = 1): the
    blocks of other segments score NEG_INF, so top-k never picks across a
    sample boundary (and ``sel_valid`` goes False for any that slip in)."""
    B, N, Hq, D = q.shape
    Hkv = k_cmp.shape[2]
    rep = Hq // Hkv
    nb = k_cmp.shape[1]
    ell = cfg.cmp_block
    g = cfg.group_size if cfg.group_size else 1
    if cfg.query_cmp_selection and cfg.group_size:
        # Eq. 13–14: score with φ-pooled queries (block granularity)
        q_s = phi_apply(params.phi_q, q, mask, cfg)                 # (B,NB,Hq,D)
        s = diag_scores(q_s, k_cmp, rep, cfg.score_dtype)           # (B,NB,Hkv,NB)
        rows_per_group = max(g // ell, 1)
        G = nb // rows_per_group
        s = s.reshape(B, G, rows_per_group, Hkv, nb).mean(dim=2)    # Eq. 12 mean
    else:
        s = diag_scores(q, k_cmp, rep, cfg.score_dtype)             # (B,N,Hkv,NB)
        if cfg.group_size:
            s = s.reshape(B, N // g, g, Hkv, nb).mean(dim=2)
    s = s / (D ** 0.5)
    neg = torch.full((), NEG_INF, dtype=s.dtype, device=s.device)
    s = torch.where(blk_valid[:, None, None, :], s, neg)
    if cfg.mask_own_ball:
        n_groups = s.shape[1]
        grp_ball = (torch.arange(n_groups, device=s.device) * (N // n_groups)
                    ) // cfg.ball_size
        blk_ball = (torch.arange(nb, device=s.device) * ell) // cfg.ball_size
        own = grp_ball[:, None] == blk_ball[None, :]                # (G, NB)
        s = torch.where(own[None, :, None, :], neg, s)
    if q_seg is not None:
        # offsets are ball multiples and groups / blocks subdivide balls, so
        # each lies inside one segment: its first token's id is its segment
        n_groups = s.shape[1]
        grp_seg = q_seg.reshape(n_groups, N // n_groups)[:, 0]      # (G,)
        blk_seg = q_seg.reshape(nb, ell)[:, 0]                      # (NB,)
        same = grp_seg[:, None] == blk_seg[None, :]
        s = torch.where(same[None, :, None, :], s, neg)
    return s


def _selection_branch(params, q, k, v, k_cmp, blk_valid, mask, cfg: BSAConfig,
                      backend):
    """Top-k block choice + exact attention.  Returns (out, indices)."""
    B, N, Hq, D = q.shape
    nb = N // cfg.cmp_block
    scores = _selection_scores(params, q, k_cmp, blk_valid, mask, cfg)
    G = scores.shape[1]
    k_star = min(cfg.top_k, nb)
    top_vals, top_idx = torch.topk(scores, k_star, dim=-1)           # (B,G,Hkv,k*)
    sel_valid = top_vals > NEG_INF / 2
    out = backend.selection(q, k, v, top_idx, sel_valid, mask,
                            block_size=cfg.cmp_block, group_size=N // G,
                            chunk_tokens=cfg.jnp_chunk_tokens)
    return out, top_idx


# ---------------------------------------------------------------------------
# Full BSA
# ---------------------------------------------------------------------------

def bsa_attention(params: BSAParams, q, k, v, *, cfg: BSAConfig, mask=None, x=None,
                  return_aux: bool = False):
    """Ball Sparse Attention (paper Eq. 9).

    q: (B, N, Hq, D); k, v: (B, N, Hkv, D); mask: (B, N) bool (True = real).
    Each batch row is an independent ball-ordered sample; padded keys are
    masked in logit space on every branch and padded query rows are zeroed
    by the combine.  ``x`` is the pre-projection layer input, needed only
    for token gating.  Returns (B, N, Hq, D) [+ aux dict]."""
    B, N, Hq, D = q.shape
    if k.shape[:2] != (B, N) or v.shape != k.shape:
        raise ValueError(f"k/v must be (B, N, Hkv, D) with (B, N) = {(B, N)}")
    if Hq % k.shape[2]:
        raise ValueError("q heads must be a multiple of kv heads")
    in_dtype = q.dtype
    q, k, v = score_dtype_cast(cfg, q, k, v)

    bk = resolve_branch_backends(cfg)
    out_ball = bk["ball"].ball(q, k, v, mask, ball_size=cfg.ball_size,
                               chunk_tokens=cfg.jnp_chunk_tokens)
    out_cmp, k_cmp, v_cmp, blk_valid = _compression_branch(
        params, q, k, v, mask, cfg, bk["cmp"])
    out_slc, top_idx = _selection_branch(
        params, q, k, v, k_cmp, blk_valid, mask, cfg, bk["slc"])

    gates = gate_values(params.gates, cfg, x, Hq)
    out = bk["ball"].gated_combine(
        (out_ball, out_cmp, out_slc),
        (gates["ball"], gates["cmp"], gates["slc"]), mask).to(in_dtype)
    if return_aux:
        return out, {"ball": out_ball, "cmp": out_cmp, "slc": out_slc,
                     "indices": top_idx, "gates": gates}
    return out


def bsa_attention_varlen(params: BSAParams, q, k, v, *, cfg: BSAConfig, offsets,
                         mask=None, x=None, return_aux: bool = False):
    """Ball Sparse Attention over a packed-varlen batch.

    q: (T, Hq, D); k, v: (T, Hkv, D): all samples concatenated on one token
    axis of capacity T.  ``offsets``: (S+1,) int32 sample boundaries on the
    host (numpy or a CPU tensor), each a multiple of ``cfg.ball_size``
    (what ``core.balltree.pack_varlen`` gives); trailing repeats are empty
    segments.  ``mask``: (T,) bool, True on real tokens (pass the one from
    ``pack_varlen``, so per-sample padding and the capacity tail are
    masked).  Equal to running each sample alone: the ball and selection
    branches keep samples apart by construction (offsets are ball
    multiples; a group picks only blocks of its own segment), the
    compression branch by segment ids in the varlen kernel.  ``x``: the
    pre-projection input (T, d_model), for token gating.  Returns
    (T, Hq, D) [+ aux dict]."""
    T, Hq, D = q.shape
    if k.shape[0] != T or v.shape != k.shape:
        raise ValueError(f"k/v must be (T, Hkv, D) with T = {T}")
    if Hq % k.shape[1]:
        raise ValueError("q heads must be a multiple of kv heads")
    in_dtype = q.dtype
    q, k, v = score_dtype_cast(cfg, q, k, v)
    ell = cfg.cmp_block
    nb = T // ell
    ct = cfg.jnp_chunk_tokens
    maskb = None if mask is None else mask[None]
    offsets = torch.as_tensor(offsets)
    bk = resolve_branch_backends(cfg)

    # ball branch: block-diagonal by construction (offsets are ball multiples)
    out_ball = get_varlen(bk["ball"], "ball")(q, k, v, offsets, mask,
                                              ball_size=cfg.ball_size, chunk_tokens=ct)

    # compression branch: packed tokens against packed φ blocks; the block
    # offsets are exact because sample boundaries are ball (hence ℓ) multiples
    k_cmp = phi_apply(params.phi_k, k[None], maskb, cfg)[0]        # (NB, Hkv, D)
    v_cmp = phi_apply(params.phi_v, v[None], maskb, cfg)[0]
    blk_valid = block_validity(maskb, 1, T, ell, device=q.device)  # (1, NB)
    k_off = offsets // ell
    flash_vl = get_varlen(bk["cmp"], "flash")
    if cfg.group_compression:
        q_cmp = phi_apply(params.phi_q, q[None], maskb, cfg)[0]
        out_c = flash_vl(q_cmp, k_cmp, v_cmp, k_off, k_off, key_valid=blk_valid[0],
                         chunk_tokens=ct)                           # (NB, Hq, D)
        out_cmp = out_c[:, None].expand(nb, ell, Hq, D).reshape(T, Hq, D)
    else:
        out_cmp = flash_vl(q, k_cmp, v_cmp, offsets, k_off, key_valid=blk_valid[0],
                           chunk_tokens=ct)

    # selection branch: segment isolation on top of the usual masking of the
    # scores, then the layout-agnostic gather-attend
    scores = _selection_scores(params, q[None], k_cmp[None], blk_valid, maskb, cfg,
                               q_seg=segment_ids(offsets, T, q.device))
    G = scores.shape[1]
    top_vals, top_idx = torch.topk(scores, min(cfg.top_k, nb), dim=-1)
    sel_valid = top_vals > NEG_INF / 2
    out_slc = get_varlen(bk["slc"], "selection")(
        q, k, v, top_idx[0], sel_valid[0], offsets, mask, block_size=ell,
        group_size=T // G, chunk_tokens=ct)

    gates = gate_values(params.gates, cfg, None if x is None else x[None], Hq)
    out = bk["ball"].gated_combine(
        (out_ball[None], out_cmp[None], out_slc[None]),
        (gates["ball"], gates["cmp"], gates["slc"]), maskb)[0].to(in_dtype)
    if return_aux:
        return out, {"ball": out_ball, "cmp": out_cmp, "slc": out_slc,
                     "indices": top_idx[0], "gates": gates}
    return out
