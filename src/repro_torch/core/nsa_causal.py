"""Causal BSA/NSA for 1-D token sequences (the LM backend).

Counterpart of ``repro/core/nsa_causal.py``.  On a token sequence the ball
tree degenerates to contiguous blocks, so BSA becomes NSA with a blocked
local window in place of the ball branch:

  * ``ball`` → blocked local attention: query block i (w positions) attends
    causally within itself and fully to block i−1 (kernel ``local_fwd``);
  * ``cmp``  → φ-pooled K/V blocks; query t sees every block that ends
    strictly before t (kernel ``flash_fwd`` in block-causal mode);
  * ``slc``  → per query group, the top-k* strictly past blocks (a block is
    selectable iff it ends before the group starts), with NSA's
    ``force_first_block`` boost (kernel ``selection_fwd``),

combined by the gated epilogue (kernel ``epilogue_fwd``).  The decode path
(``nsa_causal_decode_paged``) updates a token cache and a compressed cache
one token at a time, reading each row set from its K and V pools in one
call of the backend's ``paged_gather_pair`` (kernel ``paged_gather_pair``,
four a layer and step); the dense lockstep cache is its degenerate
one-page layout (``nsa_causal_decode``).

Caches are dicts of tensors updated IN PLACE (the JAX version returns new
arrays): a decode step scatters its token rows into the pools it was given
and returns the same dict.  Under the ``"sharded"`` backend the decode
re-enters through ``distributed.sharded_backend.sharded_paged_decode``,
which runs this same core on row-partitioned pools (its ``_pool_ops``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.backend import get_paged_gather, resolve_branch_backends
from repro_torch.core.branches import (block_validity, diag_scores, gate_values,
                                       phi_apply, score_dtype_cast, sdpa)
from repro_torch.core.bsa import BSAParams, bsa_init
from repro_torch.core.config import BSAConfig
from repro_torch.numerics import NEG_INF, mask_to_bias

__all__ = ["nsa_init", "nsa_causal_attention", "init_decode_cache",
           "nsa_causal_decode", "init_paged_decode_cache", "nsa_causal_decode_paged",
           "PagedStep", "paged_step", "dense_step", "local_window_attention_ref"]


def nsa_init(cfg: BSAConfig, *, n_heads: int, n_kv_heads: int, head_dim: int,
             d_model: int, generator: torch.Generator, dtype=torch.float32,
             device=None) -> BSAParams:
    """φ_k, φ_v, the gates and (with ``query_cmp_selection``) φ_q: the same
    parameters as ``bsa_init``."""
    return bsa_init(cfg, n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim,
                    d_model=d_model, generator=generator, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Local branch: blocked causal window
# ---------------------------------------------------------------------------

def local_window_attention_ref(q, k, v, window: int, mask=None, chunk_blocks: int = 0,
                               block_seg=None):
    """Blocked local causal attention (plain PyTorch reference).

    q, k, v: (B, N, H, D) with equal head counts.  Query block i attends to
    block i (causal) and block i−1 (full).  ``mask``: (B, N) bool key
    validity or None.  ``chunk_blocks`` > 0 computes that many blocks at a
    time (bounds the temporary logits).  ``block_seg``: (nb,) int32
    per-block segment ids of a packed batch: the previous-block half is
    masked where block i−1 lies in another segment."""
    B, N, H, D = q.shape
    w = window
    if N % w:
        raise ValueError(f"N={N} not a multiple of local window {w}")
    nb = N // w
    dev = q.device

    def blocks(t):
        return t.reshape(B, nb, w, H, D).transpose(2, 3)             # (B,nb,H,w,D)

    qb, kb, vb = blocks(q), blocks(k), blocks(v)
    kcat = torch.cat([torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], 1), kb], 3)
    vcat = torch.cat([torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], 1), vb], 3)
    qi = torch.arange(w, device=dev)[:, None]
    ki = torch.arange(2 * w, device=dev)[None, :]
    causal = ki <= qi + w                                             # prev + self-causal
    first = causal & (ki >= w)                                        # block 0: no prev
    biases = torch.where((torch.arange(nb, device=dev) == 0)[:, None, None],
                         mask_to_bias(first)[None], mask_to_bias(causal)[None])
    biases = biases[None, :, None]                                    # (1,nb,1,w,2w)
    if block_seg is not None:
        prev_ok = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                             block_seg[1:] == block_seg[:-1]])
        prev_allow = torch.cat([prev_ok[:, None].expand(nb, w),
                                torch.ones((nb, w), dtype=torch.bool, device=dev)], 1)
        biases = biases + mask_to_bias(prev_allow)[None, :, None, None, :]
    if mask is not None:
        mb = mask.reshape(B, nb, w)
        mprev = torch.cat([torch.ones_like(mb[:, :1]), mb[:, :-1]], 1)
        biases = biases + mask_to_bias(torch.cat([mprev, mb], 2)[:, :, None, None, :])
    if chunk_blocks and nb % chunk_blocks == 0 and nb > chunk_blocks:
        bb = biases.expand(B, *biases.shape[1:])
        out = torch.cat([sdpa(qb[:, s:s + chunk_blocks], kcat[:, s:s + chunk_blocks],
                              vcat[:, s:s + chunk_blocks], bb[:, s:s + chunk_blocks])
                         for s in range(0, nb, chunk_blocks)], dim=1)
    else:
        out = sdpa(qb, kcat, vcat, biases)                            # (B,nb,H,w,D)
    return out.transpose(2, 3).reshape(B, N, H, D)


# ---------------------------------------------------------------------------
# Full-sequence causal NSA
# ---------------------------------------------------------------------------

def nsa_causal_attention(params: BSAParams, q, k, v, *, cfg: BSAConfig, mask=None,
                         x=None, return_aux: bool = False, score_reduce=None):
    """Causal BSA.  q: (B, N, Hq, D); k, v: (B, N, Hkv, D); ``mask``: (B, N)
    bool or None; ``x``: the layer input (token gating); ``score_reduce``:
    see ``core.bsa.bsa_attention``.  Returns
    (B, N, Hq, D) [+ aux dict of the branch outputs, picks and gates]."""
    B, N, Hq, D = q.shape
    ell = cfg.cmp_block
    in_dtype = q.dtype
    q, k, v = score_dtype_cast(cfg, q, k, v)
    bk = resolve_branch_backends(cfg)
    out_local = bk["ball"].local_window(q, k, v, window=cfg.effective_local_window,
                                        mask=mask, chunk_tokens=cfg.jnp_chunk_tokens)

    # compression: query t sees coarse key j iff block j ends before t
    k_cmp = phi_apply(params.phi_k, k, mask, cfg)                     # (B,NB,Hkv,D)
    v_cmp = phi_apply(params.phi_v, v, mask, cfg)
    blk_valid = block_validity(mask, B, N, ell, device=q.device)
    kw = {} if mask is None else {"q_valid": mask}
    out_cmp = bk["cmp"].flash(q, k_cmp, v_cmp, key_valid=blk_valid, block_causal=True,
                              ell=ell, chunk_tokens=cfg.jnp_chunk_tokens, **kw)

    out_slc, top_idx = _causal_selection(params, q, k, v, k_cmp, blk_valid, mask, cfg,
                                         bk["slc"], score_reduce)
    gates = gate_values(params.gates, cfg, x, Hq)
    out = bk["ball"].gated_combine(
        (out_local, out_cmp, out_slc),
        (gates["ball"], gates["cmp"], gates["slc"]), mask).to(in_dtype)
    if return_aux:
        return out, {"local": out_local, "cmp": out_cmp, "slc": out_slc,
                     "indices": top_idx, "gates": gates}
    return out


def _causal_selection(params, q, k, v, k_cmp, blk_valid, mask, cfg: BSAConfig, backend,
                      score_reduce=None):
    """Group-causal top-k* block selection and its attention.  Returns
    (out (B, N, Hq, D), top_idx (B, G, Hkv, k*))."""
    B, N, Hq, D = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    ell = cfg.cmp_block
    nb = N // ell
    g = cfg.group_size if cfg.group_size else 1
    if cfg.query_cmp_selection and cfg.group_size:
        q_s = phi_apply(params.phi_q, q, mask, cfg)                   # (B,NB,Hq,D)
        s = diag_scores(q_s, k_cmp, rep, cfg.score_dtype)             # (B,NB,Hkv,NB)
        if score_reduce is not None:
            s = score_reduce(s)
        rows_per_group = max(g // ell, 1)
        s = s.reshape(B, nb // rows_per_group, rows_per_group, Hkv, nb).mean(dim=2)
    else:
        s = diag_scores(q, k_cmp, rep, cfg.score_dtype)               # (B,N,Hkv,NB)
        if score_reduce is not None:
            s = score_reduce(s)
        if cfg.group_size:
            s = s.reshape(B, N // g, g, Hkv, nb).mean(dim=2)
    s = s / (D ** 0.5)

    G = s.shape[1]
    dev = s.device
    grp_start = torch.arange(G, device=dev) * (N // G)
    blk_end = torch.arange(nb, device=dev) * ell + (ell - 1)
    causal = blk_end[None, :] < grp_start[:, None]                    # (G,NB) strictly past
    neg = torch.full((), NEG_INF, dtype=s.dtype, device=dev)
    s = torch.where(causal[None, :, None, :], s, neg)
    s = torch.where(blk_valid[:, None, None, :], s, neg)
    if cfg.force_first_block:
        # NSA always selects the initial block (when causally valid)
        boost = torch.where(causal[:, 0], -NEG_INF, 0.0).to(s.dtype)  # (G,)
        s = torch.cat([s[..., :1] + boost[None, :, None, None], s[..., 1:]], dim=-1)
    top_vals, top_idx = torch.topk(s, min(cfg.top_k, nb), dim=-1)     # (B,G,Hkv,k*)
    sel_valid = top_vals > NEG_INF / 2
    out = backend.selection(q, k, v, top_idx, sel_valid, mask, block_size=ell,
                            group_size=N // G, chunk_tokens=cfg.jnp_chunk_tokens)
    return out, top_idx


# ---------------------------------------------------------------------------
# Decode (incremental, cached)
# ---------------------------------------------------------------------------

def init_decode_cache(batch: int, max_len: int, n_kv_heads: int, head_dim: int,
                      cfg: BSAConfig, dtype=torch.bfloat16, device=None) -> dict:
    """Dense per-slot caches (the lockstep layout) and a shared length."""
    w = cfg.effective_local_window
    if max_len < 2 * w or max_len % w:
        raise ValueError(f"max_len={max_len} must be a multiple of the local "
                         f"window {w} and at least 2×")
    nb = max_len // cfg.cmp_block
    kw = dict(dtype=dtype, device=device)
    return {
        "k": torch.zeros((batch, max_len, n_kv_heads, head_dim), **kw),
        "v": torch.zeros((batch, max_len, n_kv_heads, head_dim), **kw),
        "k_cmp": torch.zeros((batch, nb, n_kv_heads, head_dim), **kw),
        "v_cmp": torch.zeros((batch, nb, n_kv_heads, head_dim), **kw),
        "length": torch.zeros((), dtype=torch.int64, device=device),
    }


def init_paged_decode_cache(num_blocks: int, page: int, n_kv_heads: int, head_dim: int,
                            cfg: BSAConfig, dtype=torch.bfloat16, device=None) -> dict:
    """Flat KV pools shared by every slot: ``num_blocks`` blocks of ``page``
    tokens plus one trash block (id ``num_blocks``) that takes the writes of
    inactive slots and the reads through unallocated table entries.
    ``page`` must be a multiple of the local window (the 2w window never
    reaches an unallocated page) and of ℓ (a φ-block's compressed row lives
    in the same pool block as its tokens)."""
    w = cfg.effective_local_window
    ell = cfg.cmp_block
    if page % w or page % ell:
        raise ValueError(f"page={page} must be a multiple of the local window "
                         f"{w} and of cmp_block {ell}")
    R = (num_blocks + 1) * page
    Rc = (num_blocks + 1) * (page // ell)
    kw = dict(dtype=dtype, device=device)
    return {
        "k": torch.zeros((R, n_kv_heads, head_dim), **kw),
        "v": torch.zeros((R, n_kv_heads, head_dim), **kw),
        "k_cmp": torch.zeros((Rc, n_kv_heads, head_dim), **kw),
        "v_cmp": torch.zeros((Rc, n_kv_heads, head_dim), **kw),
    }


def _cmp_attend_from_rows(kc_all, vc_all, q1, blk_ok, rep):
    """Compression-branch attention and the selection block scores.

    kc_all / vc_all: (B, NB, Hkv, D) gathered compressed rows; q1:
    (B, 1, Hq, D); blk_ok: (B, NB) bool.  Returns (out_cmp (B, Hkv, rep, D)
    in the rows' dtype, scores (B, Hkv, NB) fp32, NEG_INF on dead blocks).
    Products run in fp32, as JAX promotes mixed bf16 / fp32 operands."""
    B, _, Hq, D = q1.shape
    Hkv = kc_all.shape[2]
    qg = q1.reshape(B, Hkv, rep, D)                                   # (B,Hkv,rep,D)
    out = sdpa(qg, kc_all.transpose(1, 2), vc_all.transpose(1, 2),
               mask_to_bias(blk_ok[:, None, None, :]))                # (B,Hkv,rep,D)
    s = torch.einsum("bkrd,bnkd->bkn", qg.float(), kc_all.float()) / (D ** 0.5)
    s = torch.where(blk_ok[:, None, :], s, NEG_INF)
    return out, s


class _DensePoolOps:
    """Single-device pool access of the paged decode: the same rows of the K
    and the V pool gathered in one call of the backend's
    ``paged_gather_pair``, in-place row scatters."""

    def __init__(self, gather_pair):
        # (R,Hkv,D) K pool, V pool, rows → two rows.shape+(Hkv,D)
        self.gather_pair = gather_pair

    @staticmethod
    def gather_head(pool, rows, head_idx):
        # per-head row gather: rows (B,Hkv,k*,ℓ), head_idx broadcastable
        return pool[rows, head_idx]

    @staticmethod
    def scatter_rows(pool, rows, vals):
        return pool.index_copy_(0, rows, vals.to(pool.dtype))

    def cmp_attend(self, k_pool, v_pool, rows, q1, blk_ok, rep):
        return _cmp_attend_from_rows(*self.gather_pair(k_pool, v_pool, rows), q1, blk_ok,
                                     rep)


class PagedStep(NamedTuple):
    """What a paged decode step reads and writes, as a function of the block
    table and the lengths only: the same for every layer of the stack, so
    ``lm_paged_decode_step`` builds it once a step (:func:`paged_step`).
    Row indices are int64 for the scatters and int32 for the gathers."""
    table: torch.Tensor       # (B, n_pages) int64
    wrow: torch.Tensor        # (B,) token-pool row of each slot's new token
    brows: torch.Tensor       # (B, ℓ) rows of the φ-block holding it
    crow: torch.Tensor        # (B,) compressed-pool row of that block
    complete: torch.Tensor    # (B, 1, 1) bool: the new token completes its block
    win_rows: torch.Tensor    # (B, 2w) rows of the blocked local window
    win_bias: torch.Tensor    # (B, 1, 1, 2w) fp32: 0 up to t, NEG_INF past it
    cmp_rows: torch.Tensor    # (B, NB) compressed rows of every block
    blk_ok: torch.Tensor      # (B, NB) bool: blocks that end strictly before t
    first_boost: torch.Tensor  # (B, 1, 1) fp32: −NEG_INF where block 0 is selectable


def _row_of(table, pos, page):
    """(B, L) positions → (B, L) pool rows through the block table."""
    return torch.gather(table, 1, pos // page) * page + pos % page


def paged_step(table, lengths, *, cfg: BSAConfig, page: int) -> PagedStep:
    """The layer-independent part of a paged decode step (see
    :func:`nsa_causal_decode_paged`)."""
    ell = cfg.cmp_block
    w = cfg.effective_local_window
    n_pages = table.shape[1]
    cpp = page // ell                          # compressed rows per page
    nb_max = n_pages * cpp
    if n_pages * page < 2 * w:
        raise ValueError(f"slot capacity {n_pages * page} < 2×local window {w}")
    dev = table.device
    table = table.long()
    t = lengths.long()[:, None]                # (B, 1) position of each new token
    blk = t // ell
    complete = (t + 1) % ell == 0
    start = torch.clamp(t // w - 1, min=0) * w
    pos = start + torch.arange(2 * w, device=dev)
    ar = torch.arange(nb_max, device=dev)
    crows = torch.gather(table, 1, (ar // cpp).expand(table.shape[0], nb_max)) * cpp \
        + ar % cpp                                                      # (B, NB)
    n_before = torch.where(complete, (t + 1) // ell - 1, (t + 1) // ell)
    blk_ok = ar < n_before
    return PagedStep(
        table=table,
        wrow=_row_of(table, t, page)[:, 0],
        brows=_row_of(table, blk * ell + torch.arange(ell, device=dev), page).int(),
        crow=torch.gather(crows, 1, blk)[:, 0],
        complete=complete[:, :, None],
        win_rows=_row_of(table, pos, page).int(),
        win_bias=mask_to_bias(pos <= t)[:, None, None, :],
        cmp_rows=crows.int(),
        blk_ok=blk_ok,
        first_boost=torch.where(blk_ok[:, :1], -NEG_INF, 0.0)[:, :, None])


def nsa_causal_decode_paged(params: BSAParams, q1, k1, v1, cache: dict, table, lengths,
                            *, cfg: BSAConfig, page: int, x1=None,
                            step: PagedStep | None = None, _pool_ops=None):
    """One decode step over paged per-slot caches.

    q1: (B, 1, Hq, D); k1, v1: (B, 1, Hkv, D): slot b's new token at position
    ``lengths[b]``.  ``cache``: flat pools (init_paged_decode_cache),
    updated in place; ``table``: (B, n_pages) integer block table (pages →
    pool blocks; unallocated and retired entries name the trash block);
    ``lengths``: (B,) per-slot token counts (not advanced here: the host
    owns them).  ``step``: :func:`paged_step` of (table, lengths), when the
    caller shares one across layers.

    The host allocator guarantees that the page holding position
    ``lengths[b]`` belongs to slot b alone (copy-on-write runs before the
    step), so the token scatter and the compressed row's read-modify-write
    never collide across slots; inactive slots write into the trash block.
    Returns (out (B, 1, Hq, D) in q1's dtype, cache)."""
    backend = resolve_branch_backends(cfg)["cmp"]
    # (``is True``: the auto backend answers any attribute with a dispatcher)
    if _pool_ops is None and getattr(backend, "is_sharded_backend", False) is True:
        # re-enter with row-partitioned pool ops; the inner call comes back
        # here with _pool_ops set
        from repro_torch.distributed import sharded_backend
        return sharded_backend.sharded_paged_decode(backend, params, q1, k1, v1, cache,
                                                    table, lengths, cfg=cfg, page=page,
                                                    x1=x1, step=step)
    ops = _pool_ops if _pool_ops is not None else _DensePoolOps(get_paged_gather(backend))
    st = step if step is not None else paged_step(table, lengths, cfg=cfg, page=page)
    B, _, Hq, D = q1.shape
    Hkv = k1.shape[2]
    rep = Hq // Hkv
    ell = cfg.cmp_block
    dev = q1.device

    # --- token cache: each slot's new token
    k_pool = ops.scatter_rows(cache["k"], st.wrow, k1[:, 0])
    v_pool = ops.scatter_rows(cache["v"], st.wrow, v1[:, 0])

    # --- compressed cache: slots whose new token completes a φ-block; the
    # read-modify-write keeps the other slots' rows (exclusively owned)
    k_blk, v_blk = ops.gather_pair(k_pool, v_pool, st.brows)
    new_kc = phi_apply(params.phi_k, k_blk, None, cfg)
    new_vc = phi_apply(params.phi_v, v_blk, None, cfg)
    kc_old, vc_old = ops.gather_pair(cache["k_cmp"], cache["v_cmp"], st.crow)
    kc_val = torch.where(st.complete, new_kc[:, 0], kc_old)
    vc_val = torch.where(st.complete, new_vc[:, 0], vc_old)
    k_cmp = ops.scatter_rows(cache["k_cmp"], st.crow, kc_val)
    v_cmp = ops.scatter_rows(cache["v_cmp"], st.crow, vc_val)

    # --- local branch: the blocked window [max(t//w − 1, 0)·w, t]; positions
    # past t still name allocated-or-trash pages (w | page), the bias removes them
    qg = q1.reshape(B, Hkv, rep, D)
    k_win, v_win = ops.gather_pair(k_pool, v_pool, st.win_rows)
    out_local = sdpa(qg, k_win.transpose(1, 2), v_win.transpose(1, 2), st.win_bias)

    # --- compression branch: the complete blocks that end strictly before t
    out_cmp, s = ops.cmp_attend(k_cmp, v_cmp, st.cmp_rows, q1, st.blk_ok, rep)

    # --- selection branch on the scores (B, Hkv, NB) of cmp_attend
    if cfg.force_first_block:
        s = torch.cat([s[..., :1] + st.first_boost, s[..., 1:]], dim=-1)
    k_star = min(cfg.top_k, s.shape[-1])
    top_vals, top_idx = torch.topk(s, k_star, dim=-1)                 # (B,Hkv,k*)
    sel_valid = top_vals > NEG_INF / 2
    L = k_star * ell
    ig = torch.where(sel_valid, top_idx, 0)
    sel_pos = ig[..., None] * ell + torch.arange(ell, device=dev)     # (B,Hkv,k*,ℓ)
    srows = _row_of(st.table, sel_pos.reshape(B, Hkv * L), page).reshape(B, Hkv, k_star, ell)
    head_idx = torch.arange(Hkv, device=dev)[None, :, None, None]
    kg = ops.gather_head(k_pool, srows, head_idx).reshape(B, Hkv, L, D)
    vg = ops.gather_head(v_pool, srows, head_idx).reshape(B, Hkv, L, D)
    key_bias = mask_to_bias(sel_valid[..., None].expand(B, Hkv, k_star, ell)
                            .reshape(B, Hkv, 1, L))
    logits = torch.einsum("bkrd,bkld->bkrl", qg.float(), kg.float()) / (D ** 0.5)
    logits = logits + key_bias
    mx = torch.clamp(logits.amax(-1, keepdim=True), min=NEG_INF / 2)
    p = torch.exp(logits - mx)
    p = torch.where(logits <= NEG_INF / 2, 0.0, p)
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-20)
    out_slc = torch.einsum("bkrl,bkld->bkrd", p.to(vg.dtype).float(), vg.float())

    gates = gate_values(params.gates, cfg, x1, Hq)           # (B|1, 1, Hq, 1)
    out = (gates["ball"] * out_local.reshape(B, 1, Hq, D).float()
           + gates["cmp"] * out_cmp.reshape(B, 1, Hq, D).float()
           + gates["slc"] * out_slc.reshape(B, 1, Hq, D))
    return out.to(q1.dtype), {"k": k_pool, "v": v_pool, "k_cmp": k_cmp, "v_cmp": v_cmp}


def dense_step(cache: dict, cfg: BSAConfig) -> PagedStep:
    """:func:`paged_step` of the dense cache's degenerate paged layout (one
    page of ``max_len`` tokens per slot, the identity block table)."""
    B, S_max = cache["k"].shape[:2]
    table = torch.arange(B, device=cache["k"].device)[:, None]    # slot b ↔ block b
    return paged_step(table, cache["length"].expand(B), cfg=cfg, page=S_max)


def nsa_causal_decode(params: BSAParams, q1, k1, v1, cache: dict, *, cfg: BSAConfig,
                      x1=None, step: PagedStep | None = None):
    """One decode step over the dense cache (the lockstep layout).

    q1: (B, 1, Hq, D); k1, v1: (B, 1, Hkv, D) for the new token at position
    ``cache["length"]``.  The dense (B, max_len, ·) cache is the degenerate
    paged layout: one page of ``max_len`` tokens per slot, the identity
    block table, one shared length; so lockstep and paged decode share one
    numeric core.  ``step``: :func:`dense_step` of the cache, when the
    caller shares one across layers.  Returns (out (B, 1, Hq, D), cache with
    length + 1)."""
    B, S_max, Hkv, D = cache["k"].shape
    nb = cache["k_cmp"].shape[1]
    if step is None:
        step = dense_step(cache, cfg)
    pools = {"k": cache["k"].view(B * S_max, Hkv, D),
             "v": cache["v"].view(B * S_max, Hkv, D),
             "k_cmp": cache["k_cmp"].view(B * nb, Hkv, D),
             "v_cmp": cache["v_cmp"].view(B * nb, Hkv, D)}
    out, _ = nsa_causal_decode_paged(params, q1, k1, v1, pools, step.table,
                                     cache["length"].expand(B), cfg=cfg, page=S_max,
                                     x1=x1, step=step)
    return out, {**cache, "length": cache["length"] + 1}
