"""Flash-attention kernels with the mask modes BSA needs, forward and
backward.

Replaces ``repro/kernels/flash.py::_fwd_kernel``, ``::_dq_kernel`` and
``::_dkv_kernel`` (Pallas, TPU), with the index masks of
``flash.py::_mask_logits``.  The CUDA sources are ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu`` (``flash_dq`` and ``flash_dkv``, one file: they share
their inputs, the mask code and the recompute of p).

What bounds them on the H100: in the compression branch (N queries against
L = N/ℓ pooled keys, D = 32) the forward does 4·L·D FLOP per query row and
the backward 10·L·D, so the arithmetic bounds them.  The TPU carried the
running softmax state (and the backward's dQ / dK, dV sums) across
sequential grid steps; Hopper blocks run in no order, so each sum runs
inside one block: the forward and ``flash_dq`` give a block 128 query rows
and stage 64-key K/V tiles into shared memory; ``flash_dkv`` runs on the
transposed grid, a block owning 64 keys and staging 64-row tiles of Q and
dO, and sums the GQA group's rep query heads in that loop.  The ragged last
key tile (L = 480) is masked in the kernel, so nothing is padded here.
Query rows the forward skipped (a 128-row tile none of whose rows is a
valid query, ``q_valid``) carry o = 0 and lse = ``LSE_EMPTY``; the backward
kernels read that residual and skip them, so their dQ is exactly 0 and they
add nothing to dK, dV.

Layout: q (B·Hkv, rep, N, D); k, v (B·Hkv, L, D); key_bias (B, L) fp32;
q_valid (B, N) bool or None.  ``causal``: key j visible to query t iff
j ≤ t; ``block_causal``: coarse key j visible iff (j+1)·ℓ − 1 < t.
The forward returns o like q and lse (B·Hkv, rep, N) fp32.
:class:`FlashAttentionFn` is the differentiable op.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.core.branches import sdpa
from repro_torch.kernels import _build
from repro_torch.kernels.common import (_counter, check_cuda_inputs, on_cpu,
                                        p_from_lse, row_delta)
from repro_torch.numerics import NEG_INF

__all__ = ["flash_attention_fwd", "flash_attention_fwd_plain", "flash_attention_bwd",
           "flash_attention_bwd_plain", "flash_attention_dq", "flash_attention_dkv",
           "FlashAttentionFn", "COUNT", "COUNT_DQ", "COUNT_DKV"]

COUNT = _counter("flash_fwd")
COUNT_DQ = _counter("flash_dq")
COUNT_DKV = _counter("flash_dkv")


def visible_keys(N: int, L: int, *, causal: bool, block_causal: bool, ell: int,
                 device=None) -> torch.Tensor | None:
    """(N, L) bool index mask of the causal modes, None in plain mode."""
    if not (causal or block_causal):
        return None
    t = torch.arange(N, device=device)[:, None]
    j = torch.arange(L, device=device)[None, :]
    return (j + 1) * ell - 1 < t if block_causal else j <= t


def _check_shapes(name, q, k, v, key_bias, n_heads):
    BH, rep, N, D = q.shape
    L = k.shape[1]
    B = BH // n_heads
    if k.shape != (BH, L, D) or v.shape != k.shape or key_bias.shape != (B, L):
        raise ValueError(f"{name}: k/v must be {(BH, L, D)} and key_bias "
                         f"{(B, L)}, got {tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(key_bias.shape)}")


def _full_bias(key_bias, N, *, n_heads, causal, block_causal, ell):
    """(B·Hkv, 1, N or 1, L) additive bias: key bias plus the index mask."""
    L = key_bias.shape[1]
    bias = key_bias.repeat_interleave(n_heads, dim=0)[:, None, None, :]
    ok = visible_keys(N, L, causal=causal, block_causal=block_causal, ell=ell,
                      device=key_bias.device)
    if ok is not None:
        bias = torch.where(ok, bias, torch.full_like(bias, NEG_INF))
    return bias


def flash_attention_fwd_plain(q, k, v, key_bias, q_valid=None, *, n_heads: int,
                              causal: bool = False, block_causal: bool = False,
                              ell: int = 1):
    """Plain PyTorch version of the kernel: same inputs, same (o, lse) on
    every valid query row (``q_valid`` is only a skip hint; the plain
    version computes every row)."""
    bias = _full_bias(key_bias, q.shape[2], n_heads=n_heads, causal=causal,
                      block_causal=block_causal, ell=ell)
    return sdpa(q, k[:, None], v[:, None], bias, return_lse=True)


def flash_attention_fwd(q, k, v, key_bias, q_valid=None, *, n_heads: int,
                        causal: bool = False, block_causal: bool = False,
                        ell: int = 1):
    """(o, lse) of streaming attention: the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors."""
    BH, rep, N, D = q.shape
    L = k.shape[1]
    _check_shapes("flash_fwd", q, k, v, key_bias, n_heads)
    if q_valid is not None and q_valid.shape != (BH // n_heads, N):
        raise ValueError(f"flash_fwd: q_valid must be {(BH // n_heads, N)}")
    if on_cpu(q, k, v, key_bias):
        return flash_attention_fwd_plain(q, k, v, key_bias, q_valid,
                                         n_heads=n_heads, causal=causal,
                                         block_causal=block_causal, ell=ell)
    qv = None if q_valid is None else q_valid.to(torch.uint8).contiguous()
    check_cuda_inputs("flash_fwd", data=(q, k, v), f32=(key_bias,), head_dim=D)
    o = torch.empty_like(q)
    lse = torch.empty((BH, rep, N), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.launch("flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  key_bias.data_ptr(), None if qv is None else qv.data_ptr(),
                  o.data_ptr(), lse.data_ptr(), BH, rep, N, L, D, n_heads,
                  int(causal), int(block_causal), ell,
                  int(q.dtype == torch.bfloat16), stream)
    COUNT.hit()
    return o, lse


def flash_attention_bwd_plain(q, k, v, key_bias, do, lse, delta, *, n_heads: int,
                              causal: bool = False, block_causal: bool = False,
                              ell: int = 1):
    """Plain PyTorch version of the two backward kernels: p recomputed from
    lse, dV = pᵀdO, dP = dO·Vᵀ, dS = p(dP − δ)·scale, dQ = dS·K, dK = dSᵀQ,
    dK/dV summed over the group's rep query heads; p and dS rounded to the
    operand dtype before their products.  Returns (dq, dk, dv)."""
    BH, rep, N, D = q.shape
    scale = D ** -0.5
    adt = q.dtype
    bias = _full_bias(key_bias, N, n_heads=n_heads, causal=causal,
                      block_causal=block_causal, ell=ell)
    qf, dof = q.float(), do.float()
    kf, vf = k.float()[:, None], v.float()[:, None]           # (BH, 1, L, D)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale + bias
    p = p_from_lse(s, lse[..., None])                         # (BH, rep, N, L)
    dv = torch.einsum("brnl,brnd->bld", p.to(adt).float(), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = (p * (dp - delta[..., None]) * scale).to(adt).float()
    dq = torch.matmul(ds, kf)
    dk = torch.einsum("brnl,brnd->bld", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_launch(name, outs, q, k, v, key_bias, do, lse, delta, *, n_heads, causal,
                block_causal, ell):
    BH, rep, N, D = q.shape
    if do.shape != q.shape or lse.shape != (BH, rep, N) or delta.shape != lse.shape:
        raise ValueError(f"{name}: dO must be {tuple(q.shape)} and lse / delta "
                         f"{(BH, rep, N)}")
    check_cuda_inputs(name, data=(q, k, v, do), f32=(key_bias, lse, delta), head_dim=D)
    _build.launch(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
                  do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                  *(t.data_ptr() for t in outs), BH, rep, N, k.shape[1], D, n_heads,
                  int(causal), int(block_causal), ell, int(q.dtype == torch.bfloat16),
                  torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention_dq(q, k, v, key_bias, do, lse, delta, *, n_heads: int,
                       causal: bool = False, block_causal: bool = False, ell: int = 1):
    """dq from the forward's lse and δ = rowsum(dO·O): the ``flash_dq``
    kernel on CUDA tensors, the plain version on CPU tensors."""
    kw = dict(n_heads=n_heads, causal=causal, block_causal=block_causal, ell=ell)
    _check_shapes("flash_dq", q, k, v, key_bias, n_heads)
    if on_cpu(q, k, v, key_bias, do, lse, delta):
        return flash_attention_bwd_plain(q, k, v, key_bias, do, lse, delta, **kw)[0]
    dq = torch.empty_like(q)
    _bwd_launch("flash_dq", (dq,), q, k, v, key_bias, do, lse, delta, **kw)
    COUNT_DQ.hit()
    return dq


def flash_attention_dkv(q, k, v, key_bias, do, lse, delta, *, n_heads: int,
                        causal: bool = False, block_causal: bool = False, ell: int = 1):
    """(dk, dv) from the forward's lse and δ: the ``flash_dkv`` kernel on
    CUDA tensors, the plain version on CPU tensors."""
    kw = dict(n_heads=n_heads, causal=causal, block_causal=block_causal, ell=ell)
    _check_shapes("flash_dkv", q, k, v, key_bias, n_heads)
    if on_cpu(q, k, v, key_bias, do, lse, delta):
        return flash_attention_bwd_plain(q, k, v, key_bias, do, lse, delta, **kw)[1:]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("flash_dkv", (dk, dv), q, k, v, key_bias, do, lse, delta, **kw)
    COUNT_DKV.hit()
    return dk, dv


def flash_attention_bwd(q, k, v, key_bias, do, lse, delta, *, n_heads: int,
                        causal: bool = False, block_causal: bool = False,
                        ell: int = 1):
    """(dq, dk, dv): the two backward kernels (``flash_dq``, ``flash_dkv``)
    on CUDA tensors, the plain version on CPU tensors."""
    kw = dict(n_heads=n_heads, causal=causal, block_causal=block_causal, ell=ell)
    if on_cpu(q, k, v, key_bias, do, lse, delta):
        return flash_attention_bwd_plain(q, k, v, key_bias, do, lse, delta, **kw)
    return (flash_attention_dq(q, k, v, key_bias, do, lse, delta, **kw),
            *flash_attention_dkv(q, k, v, key_bias, do, lse, delta, **kw))


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable streaming attention in q, k, v (bias and ``q_valid``
    take no gradient)."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, q_valid, n_heads: int, causal: bool,
                block_causal: bool, ell: int):
        kw = dict(n_heads=n_heads, causal=causal, block_causal=block_causal, ell=ell)
        o, lse = flash_attention_fwd(q, k, v, key_bias, q_valid, **kw)
        ctx.save_for_backward(q, k, v, key_bias, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, key_bias, o, lse = ctx.saved_tensors
        do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, key_bias, do, lse, row_delta(do, o),
                                         **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None
