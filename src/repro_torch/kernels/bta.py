"""Ball-Tree Attention kernels (block-diagonal fused attention), forward and
backward.

Replaces ``repro/kernels/bta.py::_fwd_kernel`` and ``::_bwd_kernel``
(Pallas, TPU).  The CUDA sources are ``csrc/bta_fwd.cu`` and
``csrc/bta_bwd.cu``.

What bounds them on the H100: at the paper's shapes (ball m = 256, D = 32)
the forward does 4·m·D FLOP per query row and the backward 10·m·D (five
products) against a few D-wide rows of bytes, so the arithmetic bounds both.
The forward stages one ball's K and V (64 KB in fp32) into shared memory
once per block and runs every query row of the ball against it with fp32
FMAs (no tensor cores yet).  The backward is single-pass per ball, as on the
TPU (the ball is the tile, so a ball's dQ, dK, dV depend on that ball
alone): one block first runs each query row against the staged K/V for dQ,
then stages the ball's Q and dO rows and runs each key against them for dK
and dV, summing the GQA group's rep query heads in that loop.  A ball with no
valid key skips everything and writes zeros (lse = ``LSE_EMPTY`` forward,
zero gradients backward).

Layout (GQA-native, as the TPU kernel): q (B·Hkv, rep, N, D); k, v
(B·Hkv, N, D); key_bias (B, N) fp32 additive (0 / NEG_INF).  The forward
returns o like q and lse (B·Hkv, rep, N) fp32.  :class:`BallAttentionFn` is
the differentiable op, as ``jax.custom_vjp`` wraps the Pallas pair.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.core.branches import sdpa
from repro_torch.kernels import _build
from repro_torch.kernels.common import (_counter, check_cuda_inputs, on_cpu,
                                        p_from_lse, row_delta)
from repro_torch.kernels.occupancy import key_tile_live

__all__ = ["ball_attention_fwd", "ball_attention_fwd_plain", "ball_attention_bwd",
           "ball_attention_bwd_plain", "BallAttentionFn", "COUNT", "COUNT_BWD"]

COUNT = _counter("bta_fwd")
COUNT_BWD = _counter("bta_bwd")


def _check_shapes(name, q, k, v, key_bias, ball_size, n_heads):
    BH, rep, N, D = q.shape
    if k.shape != (BH, N, D) or v.shape != k.shape:
        raise ValueError(f"{name}: k/v must be {(BH, N, D)}, got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if key_bias.shape != (BH // n_heads, N) or N % ball_size:
        raise ValueError(f"{name}: key_bias must be {(BH // n_heads, N)} and "
                         f"ball_size {ball_size} must divide N={N}")


def _live(key_bias, ball_size):
    return key_tile_live(key_bias, ball_size).to(torch.int32)


def ball_attention_fwd_plain(q, k, v, key_bias, *, ball_size: int, n_heads: int):
    """Plain PyTorch version of the kernel: same inputs, same (o, lse)."""
    BH, rep, N, D = q.shape
    m = ball_size
    nb = N // m
    qb = q.reshape(BH, rep, nb, m, D).transpose(1, 2)        # (BH, nb, rep, m, D)
    kb = k.reshape(BH, 1, nb, m, D).transpose(1, 2)          # (BH, nb, 1, m, D)
    vb = v.reshape(BH, 1, nb, m, D).transpose(1, 2)
    bias = key_bias.repeat_interleave(n_heads, dim=0)        # (BH, N)
    bias = bias.reshape(BH, nb, 1, 1, m)
    o, lse = sdpa(qb, kb, vb, bias, return_lse=True)
    return (o.transpose(1, 2).reshape(BH, rep, N, D),
            lse.transpose(1, 2).reshape(BH, rep, N))


def ball_attention_fwd(q, k, v, key_bias, *, ball_size: int, n_heads: int,
                       live=None):
    """(o, lse) of ball attention: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors.  ``live``: the (B, N/m) int32 ball liveness of
    ``key_bias`` when the caller already has it."""
    BH, rep, N, D = q.shape
    _check_shapes("bta_fwd", q, k, v, key_bias, ball_size, n_heads)
    if on_cpu(q, k, v, key_bias):
        return ball_attention_fwd_plain(q, k, v, key_bias, ball_size=ball_size,
                                        n_heads=n_heads)
    live = _live(key_bias, ball_size) if live is None else live
    check_cuda_inputs("bta_fwd", data=(q, k, v), f32=(key_bias,), i32=(live,),
                      head_dim=D)
    o = torch.empty_like(q)
    lse = torch.empty((BH, rep, N), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.launch("bta_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  key_bias.data_ptr(), live.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), BH, rep, N, D, ball_size, n_heads,
                  int(q.dtype == torch.bfloat16), stream)
    COUNT.hit()
    return o, lse


def ball_attention_bwd_plain(q, k, v, key_bias, do, lse, delta, *, ball_size: int,
                             n_heads: int):
    """Plain PyTorch version of the backward kernel: p recomputed from lse,
    dV = pᵀdO, dP = dO·Vᵀ, dS = p(dP − δ)·scale, dQ = dS·K, dK = dSᵀQ, the
    dV/dK products summed over the group's rep query heads.  p and dS are
    rounded to the operand dtype before their products, as on the TPU.
    Returns (dq, dk, dv) in the dtypes of q, k, v."""
    BH, rep, N, D = q.shape
    m = ball_size
    nb = N // m
    scale = D ** -0.5
    adt = q.dtype

    def rows(t):                      # (BH, rep, N, …) → (BH, nb, rep, m, …)
        return t.reshape(BH, rep, nb, m, *t.shape[3:]).transpose(1, 2)

    qb, dob = rows(q).float(), rows(do).float()
    kb = k.reshape(BH, nb, 1, m, D).float()
    vb = v.reshape(BH, nb, 1, m, D).float()
    bias = key_bias.repeat_interleave(n_heads, dim=0).reshape(BH, nb, 1, 1, m)
    s = torch.matmul(qb, kb.transpose(-1, -2)) * scale + bias
    p = p_from_lse(s, rows(lse)[..., None])                  # (BH, nb, rep, m, m)
    dv = torch.einsum("bnrqk,bnrqd->bnkd", p.to(adt).float(), dob)
    dp = torch.matmul(dob, vb.transpose(-1, -2))
    ds = (p * (dp - rows(delta)[..., None]) * scale).to(adt).float()
    dq = torch.matmul(ds, kb)
    dk = torch.einsum("bnrqk,bnrqd->bnkd", ds, qb)
    return (dq.transpose(1, 2).reshape(BH, rep, N, D).to(q.dtype),
            dk.reshape(BH, N, D).to(k.dtype), dv.reshape(BH, N, D).to(v.dtype))


def ball_attention_bwd(q, k, v, key_bias, do, lse, delta, *, ball_size: int,
                       n_heads: int, live=None):
    """(dq, dk, dv) of ball attention from the forward's lse and
    δ = rowsum(dO·O): the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors."""
    BH, rep, N, D = q.shape
    _check_shapes("bta_bwd", q, k, v, key_bias, ball_size, n_heads)
    if do.shape != q.shape or lse.shape != (BH, rep, N) or delta.shape != lse.shape:
        raise ValueError(f"bta_bwd: dO must be {tuple(q.shape)} and lse / delta "
                         f"{(BH, rep, N)}")
    if on_cpu(q, k, v, key_bias, do, lse, delta):
        return ball_attention_bwd_plain(q, k, v, key_bias, do, lse, delta,
                                        ball_size=ball_size, n_heads=n_heads)
    live = _live(key_bias, ball_size) if live is None else live
    check_cuda_inputs("bta_bwd", data=(q, k, v, do), f32=(key_bias, lse, delta),
                      i32=(live,), head_dim=D)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.launch("bta_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  key_bias.data_ptr(), live.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), BH, rep, N, D, ball_size, n_heads,
                  int(q.dtype == torch.bfloat16), stream)
    COUNT_BWD.hit()
    return dq, dk, dv


class BallAttentionFn(torch.autograd.Function):
    """Differentiable ball attention in q, k, v (the bias takes no
    gradient).  The forward saves (q, k, v, key_bias, live, o, lse), as the
    JAX custom VJP does."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, ball_size: int, n_heads: int):
        live = None if on_cpu(q, k, v, key_bias) else _live(key_bias, ball_size)
        o, lse = ball_attention_fwd(q, k, v, key_bias, ball_size=ball_size,
                                    n_heads=n_heads, live=live)
        ctx.save_for_backward(q, k, v, key_bias, live, o, lse)
        ctx.kw = dict(ball_size=ball_size, n_heads=n_heads)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, key_bias, live, o, lse = ctx.saved_tensors
        do = do.contiguous()
        dq, dk, dv = ball_attention_bwd(q, k, v, key_bias, do, lse, row_delta(do, o),
                                        live=live, **ctx.kw)
        return dq, dk, dv, None, None, None
