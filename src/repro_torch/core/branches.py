"""Shared branch math for BSA: φ compression, gating, attention.

Counterpart of ``repro/core/branches.py``.  Tensor convention:
q (B, N, Hq, D), k/v (B, N, Hkv, D) with Hq = Hkv·rep (GQA; query head
h·rep + r belongs to KV head h).  Softmax logits are always fp32: a bf16
operand is widened to fp32 before a product, which makes each product exact
and the sum fp32, as ``preferred_element_type=float32`` does in JAX.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import lse_finalize
from repro_torch.kernels.occupancy import invalidate_dead_groups
from repro_torch.layers.nn import dense, mlp
from repro_torch.numerics import NEG_INF, mask_to_bias

__all__ = ["BRANCHES", "phi_apply", "block_validity", "gate_values",
           "gated_combine_ref", "repeat_kv", "score_dtype_cast", "diag_scores",
           "sdpa", "gather_attend_blocks", "selection_attend",
           "chunked_q_attention"]

BRANCHES = ("ball", "cmp", "slc")


# ---------------------------------------------------------------------------
# φ — block compression (paper Eq. 5 / Eq. 13)
# ---------------------------------------------------------------------------

def phi_apply(p, x: torch.Tensor, mask: torch.Tensor | None, cfg) -> torch.Tensor:
    """Compress token blocks to coarse tokens.

    ``p`` carries ``pos`` (ℓ, D), and ``fc1`` / ``fc2`` for φ = "mlp";
    x: (B, N, H, D) → (B, NB, H, D) with NB = N // ℓ.  Padded positions
    contribute zero.  φ = "mean": the mean over valid tokens, divided by
    max(count, 1).  φ = "mlp": each block's ℓ tokens of a head flattened
    to ℓ·D (token outer, dim inner), then ``layers.nn.mlp`` (ℓ·D → 2D →
    D, GELU), shared by heads and blocks."""
    if cfg.phi not in ("mean", "mlp"):
        raise ValueError(f"phi={cfg.phi!r}: must be 'mean' or 'mlp'")
    B, N, H, D = x.shape
    ell = cfg.cmp_block
    if N % ell:
        raise ValueError(f"N={N} not a multiple of cmp_block={ell}")
    nb = N // ell
    xb = x.reshape(B, nb, ell, H, D) + p.pos.to(x.dtype)[None, None, :, None, :]
    if mask is not None:
        mb = mask.reshape(B, nb, ell)[..., None, None]
        xb = torch.where(mb, xb, torch.zeros((), dtype=x.dtype, device=x.device))
    if cfg.phi == "mlp":
        return mlp(p, xb.permute(0, 1, 3, 2, 4).reshape(B, nb, H, ell * D))
    if mask is None:
        return xb.float().mean(dim=2).to(x.dtype)
    cnt = mask.reshape(B, nb, ell).sum(-1).clamp(min=1)
    out = xb.float().sum(dim=2) / cnt[..., None, None].float()
    return out.to(x.dtype)


def block_validity(mask: torch.Tensor | None, B: int, N: int, ell: int, *,
                   device=None) -> torch.Tensor:
    """(B, NB) bool — a coarse block is valid iff it holds ≥ 1 real token."""
    nb = N // ell
    if mask is None:
        return torch.ones((B, nb), dtype=torch.bool, device=device)
    return mask.reshape(B, nb, ell).any(-1)


# ---------------------------------------------------------------------------
# Gating (paper Eq. 9)
# ---------------------------------------------------------------------------

def gate_values(gates, cfg, x: torch.Tensor | None, n_heads: int) -> dict:
    """dict branch -> fp32 gate values broadcastable to (B, N, H, 1).

    ``gates`` carries ``ball`` / ``cmp`` / ``slc`` (H,) tensors in scalar
    mode, or a ``proj`` dense layer (d_model → 3H) in token mode."""
    if cfg.gate_mode == "scalar":
        return {b: torch.sigmoid(getattr(gates, b).float())[None, None, :, None]
                for b in BRANCHES}
    if x is None:
        raise ValueError("token gating needs the layer input")
    g = torch.sigmoid(dense(gates.proj, x).float())              # (B, N, 3H)
    B, N, _ = g.shape
    g = g.reshape(B, N, 3, n_heads, 1)
    return {b: g[:, :, i] for i, b in enumerate(BRANCHES)}


def gated_combine_ref(outs, gates, mask):
    """Reference gate-and-mask epilogue: Σ g_b·out_b in fp32, query-masked,
    in ``outs[0].dtype``."""
    out = sum(g * o.float() for g, o in zip(gates, outs))
    if mask is not None:
        out = torch.where(mask[:, :, None, None], out, torch.zeros_like(out))
    return out.to(outs[0].dtype)


# ---------------------------------------------------------------------------
# Attention primitives (fp32 softmax; GQA via head reshape)
# ---------------------------------------------------------------------------

def repeat_kv(kv: torch.Tensor, rep: int) -> torch.Tensor:
    """(B, N, Hkv, D) -> (B, N, Hkv*rep, D)"""
    if rep == 1:
        return kv
    B, N, Hkv, D = kv.shape
    return kv[:, :, :, None, :].expand(B, N, Hkv, rep, D).reshape(B, N, Hkv * rep, D)


def score_dtype_cast(cfg, *tensors):
    """Under ``score_dtype="bfloat16"`` the attention inputs go in as bf16
    once, at the top of ``bsa_attention``; fp32 returns them untouched."""
    if cfg.score_dtype == "bfloat16":
        return tuple(t.to(torch.bfloat16) for t in tensors)
    return tensors


def diag_scores(q, k_cmp, rep: int, score_dtype=torch.float32) -> torch.Tensor:
    """Selection importance scores q·k_cmpᵀ summed over each GQA group's rep
    query heads.  q: (B, M, Hq, D), k_cmp: (B, NB, Hkv, D) → (B, M, Hkv, NB)
    fp32.  Operands are rounded once to ``score_dtype``; the contraction
    accumulates fp32."""
    B, M, Hq, D = q.shape
    Hkv = k_cmp.shape[2]
    if Hq != Hkv * rep:
        raise ValueError(f"GQA miswiring: Hq={Hq} != Hkv={Hkv} * rep={rep}")
    dt = getattr(torch, score_dtype) if isinstance(score_dtype, str) else score_dtype
    qg = q.reshape(B, M, Hkv, rep, D).to(dt).float()
    kc = k_cmp.to(dt).float()
    return torch.einsum("bmkrd,bnkd->bmkn", qg, kc)


def sdpa(q, k, v, bias=None, *, return_lse: bool = False):
    """softmax(q kᵀ/√D + bias) v.

    q: (..., M, D), k/v: (..., L, D), bias broadcastable to (..., M, L).
    Rows whose keys are ALL masked (bias = NEG_INF) return zeros.  With
    ``return_lse`` also returns the per-row logsumexp residual (..., M),
    ``LSE_EMPTY`` on all-masked rows — what the kernels emit."""
    d = q.shape[-1]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / (d ** 0.5)
    if bias is not None:
        logits = logits + bias
    m = torch.clamp(logits.amax(dim=-1, keepdim=True), min=NEG_INF / 2)
    p = torch.exp(logits - m)
    if bias is not None:
        p = torch.where(logits <= NEG_INF / 2, torch.zeros_like(p), p)
    l = p.sum(-1, keepdim=True)
    w = (p / torch.clamp(l, min=1e-20)).to(v.dtype)
    out = torch.matmul(w.float(), v.float()).to(v.dtype)
    if return_lse:
        return out, lse_finalize(m, l)[..., 0]
    return out


def gather_attend_blocks(q_g, kb, vb, idx, sel_valid, tok_valid, scale_dim: int):
    """Selection attention for grouped queries.

    q_g: (G, B, g, Hkv, rep, D); kb/vb: (B, Hkv, NB, ℓ, D) head-major;
    idx/sel_valid: (G, B, Hkv, k*); tok_valid: (B, NB, ℓ) bool or None.
    Returns (G, B, g, Hkv, rep, D)."""
    G, B, g, Hkv, rep, D = q_g.shape
    NB, ell = kb.shape[2], kb.shape[3]
    k_star = idx.shape[-1]
    L = k_star * ell
    safe = torch.where(sel_valid, idx, torch.zeros_like(idx)).long()
    ig = safe.permute(1, 2, 0, 3).reshape(B, Hkv, G * k_star)
    kg = torch.gather(kb.reshape(B, Hkv, NB, ell * D), 2,
                      ig[..., None].expand(-1, -1, -1, ell * D)).reshape(B, Hkv, G, L, D)
    vg = torch.gather(vb.reshape(B, Hkv, NB, ell * D), 2,
                      ig[..., None].expand(-1, -1, -1, ell * D)).reshape(B, Hkv, G, L, D)
    key_valid = sel_valid.permute(1, 2, 0, 3)[..., None].expand(B, Hkv, G, k_star, ell)
    if tok_valid is not None:
        tv = torch.gather(tok_valid.reshape(B, 1, NB, ell).expand(B, Hkv, NB, ell), 2,
                          ig[..., None].expand(-1, -1, -1, ell))
        key_valid = key_valid & tv.reshape(B, Hkv, G, k_star, ell)
    bias = mask_to_bias(key_valid.reshape(B, Hkv, G, 1, 1, L))
    qh = q_g.permute(1, 3, 0, 4, 2, 5)                       # (B,Hkv,G,rep,g,D)
    logits = torch.einsum("bhgrmd,bhgld->bhgrml", qh.float(), kg.float()) / (scale_dim ** 0.5)
    logits = logits + bias
    mx = torch.clamp(logits.amax(-1, keepdim=True), min=NEG_INF / 2)
    p = torch.exp(logits - mx)
    p = torch.where(logits <= NEG_INF / 2, torch.zeros_like(p), p)
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-20)
    out = torch.einsum("bhgrml,bhgld->bhgrmd", p.to(vg.dtype).float(),
                       vg.float()).to(vg.dtype)
    return out.permute(2, 0, 4, 1, 3, 5)                     # (G,B,g,Hkv,rep,D)


def selection_attend(q, k, v, top_idx, sel_valid, mask, *, block_size: int,
                     q_valid=None):
    """Layout around :func:`gather_attend_blocks` for the reference selection
    branch.  q: (B, N, Hq, D); k/v: (B, L, Hkv, D); top_idx/sel_valid:
    (B, G, Hkv, k*).  ``mask`` is the (B, L) key mask and doubles as the
    query mask unless ``q_valid`` (B, N) is given.  Groups whose query tokens
    are all padding get their selections invalidated (→ exact zeros), as the
    kernel path does.  Returns (B, N, Hq, D)."""
    sel_valid = invalidate_dead_groups(
        sel_valid, q_valid if q_valid is not None else mask, q.shape[1])
    B, N, Hq, D = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    ell = block_size
    nb = k.shape[1] // ell
    G = top_idx.shape[1]
    g = N // G
    kb = k.reshape(B, nb, ell, Hkv, D).permute(0, 3, 1, 2, 4)
    vb = v.reshape(B, nb, ell, Hkv, D).permute(0, 3, 1, 2, 4)
    tok_valid = mask.reshape(B, nb, ell) if mask is not None else None
    q_g = q.reshape(B, G, g, Hkv, rep, D).permute(1, 0, 2, 3, 4, 5)
    out = gather_attend_blocks(q_g, kb, vb, top_idx.permute(1, 0, 2, 3),
                               sel_valid.permute(1, 0, 2, 3), tok_valid, D)
    return out.permute(1, 0, 2, 3, 4, 5).reshape(B, N, Hq, D)


def chunked_q_attention(q, k, v, *, key_valid=None, block_causal_ell: int = 0,
                        chunk: int = 0, q_seg=None, k_seg=None):
    """Dense attention of q against (small) K/V, optionally in query chunks.

    q: (B, N, H, D); k/v: (B, L, H, D) with the same head count;
    key_valid: (B, L) bool.  ``block_causal_ell`` > 0 applies the
    compression-branch causal rule: query t sees key j iff
    (j+1)·ℓ − 1 < t.  ``q_seg`` / ``k_seg`` (given together): (N,) / (L,)
    int32 segment ids shared across the batch — packed-varlen isolation, a
    query sees only keys of its own segment.  ``chunk`` bounds the logits
    held at once."""
    B, N, H, D = q.shape
    L = k.shape[1]
    kh = k.transpose(1, 2)
    vh = v.transpose(1, 2)
    if key_valid is not None:
        base = mask_to_bias(key_valid[:, None, None, :])
    else:
        base = torch.zeros((B, 1, 1, L), dtype=torch.float32, device=q.device)
    qh = q.transpose(1, 2)                                    # (B, H, N, D)

    def attend(qc, pos):
        bias = base
        if block_causal_ell:
            end = (torch.arange(L, device=q.device) + 1) * block_causal_ell - 1
            bias = bias + mask_to_bias(end[None, :] < pos[:, None])[None, None]
        if q_seg is not None:
            bias = bias + mask_to_bias(q_seg[pos][:, None] == k_seg[None, :])[None, None]
        return sdpa(qc, kh, vh, bias)

    pos = torch.arange(N, device=q.device)
    if chunk and N % chunk == 0 and N > chunk:
        out = torch.cat([attend(qh[:, :, s:s + chunk], pos[s:s + chunk])
                         for s in range(0, N, chunk)], dim=2)
    else:
        out = attend(qh, pos)
    return out.transpose(1, 2)
