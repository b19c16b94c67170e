"""Group-selected sparse attention kernels (the NSA/BSA hot path), forward
and backward.

Replaces ``repro/kernels/selection.py::_fwd_kernel`` and ``::_bwd_kernel``
with its jnp scatter ``_scatter_blocks`` (Pallas, TPU).  The CUDA sources
are ``csrc/selection_fwd.cu`` and ``csrc/selection_bwd.cu``.

What bounds them on the H100: each query group gathers k* blocks of ℓ keys
and values for only 4·M·k*·ℓ·D FLOP forward and 10·M·k*·ℓ·D backward
(M = g·rep = 8 rows at the paper's shapes), so memory traffic bounds them.
The TPU scalar-prefetched the indices to drive its block fetches; here each
warp loads its own group's indices and gathers the selected blocks itself.
With 8 rows against 8 keys a tensor-core tile would be mostly empty, so one
warp owns one (batch, KV head, group): 8 rows × 4 lanes, D/4 dims a lane,
shuffles sum a row's dot products.  Invalid selections (−1) cost nothing; a
group with no valid selection writes zeros (and lse = ``LSE_EMPTY``).

The backward accumulates dQ over the group's k* selections in registers and
adds each selection's dK, dV (summed over the group's rows by shuffles)
atomically into fp32 (B, Hkv, NB, ℓ, D) buffers, so a block chosen by
several groups sums their contributions without the TPU's staging buffer
of per-selection tiles; bf16 operands are cast from the fp32 sums at the
end.  Atomic adds make the order of that sum vary from run to run (fp32
rounding only).

Layout: q (B, Hkv, G, M, D); kb, vb (B, Hkv, NB, ℓ, D); idx (B, Hkv, G, k*)
int32 (−1 = invalid); tok_bias (B, NB, ℓ) fp32.  The forward returns o like
q and lse (B, Hkv, G, M) fp32.  :class:`SelectionAttentionFn` is the
differentiable op (in q, kb, vb).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.core.branches import sdpa
from repro_torch.kernels import _build
from repro_torch.kernels.common import (_counter, check_cuda_inputs, on_cpu,
                                        p_from_lse, row_delta)
from repro_torch.numerics import NEG_INF

__all__ = ["selection_attention_fwd", "selection_attention_fwd_plain",
           "selection_attention_bwd", "selection_attention_bwd_plain",
           "SelectionAttentionFn", "COUNT", "COUNT_BWD"]

COUNT = _counter("selection_fwd")
COUNT_BWD = _counter("selection_bwd")


def _check_shapes(name, q, kb, vb, idx, tok_bias):
    B, Hkv, G, M, D = q.shape
    NB, ell = kb.shape[2], kb.shape[3]
    if (kb.shape != (B, Hkv, NB, ell, D) or vb.shape != kb.shape
            or idx.shape[:3] != (B, Hkv, G) or tok_bias.shape != (B, NB, ell)):
        raise ValueError(f"{name}: shapes disagree: q {tuple(q.shape)}, kb "
                         f"{tuple(kb.shape)}, vb {tuple(vb.shape)}, idx "
                         f"{tuple(idx.shape)}, tok_bias {tuple(tok_bias.shape)}")


def _gather(kb, vb, idx, tok_bias):
    """Selected blocks: (kg, vg) (B, Hkv, G, k*·ℓ, D), their bias
    (B, Hkv, G, 1, k*·ℓ) with invalid selections at NEG_INF, and the
    flattened safe block index (B, Hkv, G·k*)."""
    B, Hkv, NB, ell, D = kb.shape
    G, k_star = idx.shape[2], idx.shape[3]
    valid = idx >= 0
    flat = torch.where(valid, idx, torch.zeros_like(idx)).long().reshape(B, Hkv, G * k_star)
    kg, vg = (torch.gather(t.reshape(B, Hkv, NB, ell * D), 2,
                           flat[..., None].expand(-1, -1, -1, ell * D))
              .reshape(B, Hkv, G, k_star * ell, D) for t in (kb, vb))
    tb = torch.gather(tok_bias[:, None].expand(-1, Hkv, -1, -1).reshape(B, Hkv, NB, ell),
                      2, flat[..., None].expand(-1, -1, -1, ell))
    tb = tb.reshape(B, Hkv, G, k_star, ell)
    bias = torch.where(valid[..., None], tb, torch.full_like(tb, NEG_INF))
    return kg, vg, bias.reshape(B, Hkv, G, 1, k_star * ell), flat


def selection_attention_fwd_plain(q, kb, vb, idx, tok_bias):
    """Plain PyTorch version of the kernel: same inputs, same (o, lse)."""
    kg, vg, bias, _ = _gather(kb, vb, idx, tok_bias)
    return sdpa(q, kg, vg, bias, return_lse=True)


def selection_attention_fwd(q, kb, vb, idx, tok_bias):
    """(o, lse) of group-selected attention: the CUDA kernel on CUDA tensors,
    the plain version on CPU tensors."""
    B, Hkv, G, M, D = q.shape
    NB, ell = kb.shape[2], kb.shape[3]
    _check_shapes("selection_fwd", q, kb, vb, idx, tok_bias)
    if on_cpu(q, kb, vb, idx, tok_bias):
        return selection_attention_fwd_plain(q, kb, vb, idx, tok_bias)
    check_cuda_inputs("selection_fwd", data=(q, kb, vb), f32=(tok_bias,),
                      i32=(idx,), head_dim=D)
    o = torch.empty_like(q)
    lse = torch.empty((B, Hkv, G, M), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.launch("selection_fwd", q.data_ptr(), kb.data_ptr(), vb.data_ptr(),
                  idx.data_ptr(), tok_bias.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), B, Hkv, G, M, NB, ell, idx.shape[-1], D,
                  int(q.dtype == torch.bfloat16), stream)
    COUNT.hit()
    return o, lse


def selection_attention_bwd_plain(q, kb, vb, idx, tok_bias, do, lse, delta):
    """Plain PyTorch version of the backward kernel: per group, p recomputed
    from lse over its gathered blocks, dQ = dS·K, and per-selection
    dK = dSᵀQ, dV = pᵀdO scatter-added (fp32) into the blocked gradients,
    duplicates summing.  p and dS are rounded to the operand dtype before
    their products.  Returns (dq, dkb, dvb)."""
    B, Hkv, G, M, D = q.shape
    NB, ell = kb.shape[2], kb.shape[3]
    scale = D ** -0.5
    adt = q.dtype
    kg, vg, bias, flat = _gather(kb, vb, idx, tok_bias)
    qf, dof, kf, vf = q.float(), do.float(), kg.float(), vg.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale + bias
    p = p_from_lse(s, lse[..., None])                         # (B, Hkv, G, M, k*·ℓ)
    dv_sel = torch.matmul(p.to(adt).float().transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = (p * (dp - delta[..., None]) * scale).to(adt).float()
    dq = torch.matmul(ds, kf)
    dk_sel = torch.matmul(ds.transpose(-1, -2), qf)           # (B, Hkv, G, k*·ℓ, D)
    target = flat[..., None].expand(-1, -1, -1, ell * D)

    def scatter(d_sel):
        out = torch.zeros((B, Hkv, NB, ell * D), dtype=torch.float32, device=q.device)
        out.scatter_add_(2, target, d_sel.reshape(B, Hkv, -1, ell * D))
        return out.reshape(B, Hkv, NB, ell, D)

    return dq.to(q.dtype), scatter(dk_sel).to(kb.dtype), scatter(dv_sel).to(vb.dtype)


def selection_attention_bwd(q, kb, vb, idx, tok_bias, do, lse, delta):
    """(dq, dkb, dvb) from the forward's lse and δ = rowsum(dO·O): the CUDA
    kernel on CUDA tensors, the plain version on CPU tensors."""
    B, Hkv, G, M, D = q.shape
    NB, ell = kb.shape[2], kb.shape[3]
    _check_shapes("selection_bwd", q, kb, vb, idx, tok_bias)
    if do.shape != q.shape or lse.shape != (B, Hkv, G, M) or delta.shape != lse.shape:
        raise ValueError(f"selection_bwd: dO must be {tuple(q.shape)} and lse / "
                         f"delta {(B, Hkv, G, M)}")
    if on_cpu(q, kb, vb, idx, tok_bias, do, lse, delta):
        return selection_attention_bwd_plain(q, kb, vb, idx, tok_bias, do, lse, delta)
    check_cuda_inputs("selection_bwd", data=(q, kb, vb, do),
                      f32=(tok_bias, lse, delta), i32=(idx,), head_dim=D)
    dq = torch.empty_like(q)
    dkb = torch.zeros(kb.shape, dtype=torch.float32, device=q.device)
    dvb = torch.zeros(vb.shape, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.launch("selection_bwd", q.data_ptr(), kb.data_ptr(), vb.data_ptr(),
                  idx.data_ptr(), tok_bias.data_ptr(), do.data_ptr(), lse.data_ptr(),
                  delta.data_ptr(), dq.data_ptr(), dkb.data_ptr(), dvb.data_ptr(),
                  B, Hkv, G, M, NB, ell, idx.shape[-1], D,
                  int(q.dtype == torch.bfloat16), stream)
    COUNT_BWD.hit()
    return dq, dkb.to(kb.dtype), dvb.to(vb.dtype)


class SelectionAttentionFn(torch.autograd.Function):
    """Differentiable group-selected attention in q, kb, vb (indices and
    token bias take no gradient)."""

    @staticmethod
    def forward(ctx, q, kb, vb, idx, tok_bias):
        o, lse = selection_attention_fwd(q, kb, vb, idx, tok_bias)
        ctx.save_for_backward(q, kb, vb, idx, tok_bias, o, lse)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, kb, vb, idx, tok_bias, o, lse = ctx.saved_tensors
        do = do.contiguous()
        dq, dkb, dvb = selection_attention_bwd(q, kb, vb, idx, tok_bias, do, lse,
                                               row_delta(do, o))
        return dq, dkb, dvb, None, None
