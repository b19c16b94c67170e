"""Blocked local causal attention kernel (the causal LM's local branch),
forward.

Replaces ``repro/kernels/local.py::_fwd_kernel`` (Pallas, TPU).  The CUDA
source is ``csrc/local_fwd.cu``.  Query block i (``window`` = w positions)
attends causally within block i and fully to block i−1, the blocked
equivalent of a sliding window of w..2w keys.

What bounds it on the H100: each query row does 4·D FLOP per visible key
(w to 2w of them) against one read of its q row, so the arithmetic bounds
it at the prefill shapes.  The TPU fetched the prev and self key halves
with two index maps and skipped dead halves through a scalar-prefetched
liveness table; here a thread block owns up to 128 rows of one (b·h,
query head, block), stages each live half through shared memory in 64-key
tiles and folds every row through an online softmax.  The liveness of the
two halves, (B, N/w, 2), is computed here (``occupancy.local_half_live``),
with the packed layout's segment rule folded into the prev half, so the
kernel reads no segment ids.

Layout: q (B·Hkv, rep, N, D); k, v (B·Hkv, N, D); key_bias (B, N) fp32
(0 valid / NEG_INF padding); blk_seg (B, N/w) int32 per-block segment ids
or None (one segment).  Returns o like q and lse (B·Hkv, rep, N) fp32
(``LSE_EMPTY`` on a row with no valid key); serving reads only o, the
backward kernel of the training slice reads lse.

:class:`LocalWindowFn` is the differentiable op.  Its backward kernel
(``repro/kernels/local.py::_bwd_kernel``) comes with the LM training
slice: on CUDA tensors the backward raises; on CPU tensors autograd
differentiates the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.core.branches import sdpa
from repro_torch.kernels import _build
from repro_torch.kernels.common import _counter, check_cuda_inputs, on_cpu
from repro_torch.kernels.occupancy import local_half_live
from repro_torch.numerics import NEG_INF

__all__ = ["local_window_fwd", "local_window_fwd_plain", "LocalWindowFn", "COUNT"]

COUNT = _counter("local_fwd")


def _check_shapes(q, k, v, key_bias, blk_seg, window, n_heads):
    BH, rep, N, D = q.shape
    B = BH // n_heads
    if window <= 0 or N % window:
        raise ValueError(f"local_fwd: N={N} is not a multiple of the window {window}")
    if k.shape != (BH, N, D) or v.shape != k.shape or key_bias.shape != (B, N):
        raise ValueError(f"local_fwd: k/v must be {(BH, N, D)} and key_bias {(B, N)}, "
                         f"got {tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(key_bias.shape)}")
    if blk_seg is not None and blk_seg.shape != (B, N // window):
        raise ValueError(f"local_fwd: blk_seg must be {(B, N // window)}, "
                         f"got {tuple(blk_seg.shape)}")


def local_window_fwd_plain(q, k, v, key_bias, blk_seg=None, *, window: int,
                           n_heads: int):
    """Plain PyTorch version of the kernel: same inputs, same (o, lse).
    Each block's rows attend the 2w keys [prev block, own block] under one
    (w, 2w) bias: the key bias, NEG_INF on the prev half of block 0 and of a
    block whose predecessor lies in another segment, and the causal rule on
    the self half."""
    BH, rep, N, D = q.shape
    w = window
    nb = N // w
    B = BH // n_heads
    qb = q.reshape(BH, rep, nb, w, D).transpose(1, 2)              # (BH,nb,rep,w,D)

    def with_prev(t):                                              # (BH,nb,2w,D)
        tb = t.reshape(BH, nb, w, D)
        return torch.cat([torch.cat([torch.zeros_like(tb[:, :1]), tb[:, :-1]], 1), tb], 2)

    kbias = key_bias.reshape(B, nb, w)
    neg = torch.full_like(kbias[:, :1], NEG_INF)
    pbias = torch.cat([neg, kbias[:, :-1]], dim=1)
    if blk_seg is not None:
        same = torch.cat([torch.zeros_like(blk_seg[:, :1], dtype=torch.bool),
                          blk_seg[:, 1:] == blk_seg[:, :-1]], dim=1)
        pbias = torch.where(same[..., None], pbias, NEG_INF)
    ok = torch.ones((w, 2 * w), dtype=torch.bool, device=q.device)
    ok[:, w:] = torch.tril(ok[:, w:])                              # self half: causal
    bias = torch.where(ok, torch.cat([pbias, kbias], dim=2)[:, :, None, :], NEG_INF)
    bias = bias.repeat_interleave(n_heads, dim=0)[:, :, None]      # (BH,nb,1,w,2w)
    o, lse = sdpa(qb, with_prev(k)[:, :, None], with_prev(v)[:, :, None], bias,
                  return_lse=True)
    return (o.transpose(1, 2).reshape(BH, rep, N, D),
            lse.transpose(1, 2).reshape(BH, rep, N))


def local_window_fwd(q, k, v, key_bias, blk_seg=None, *, window: int, n_heads: int):
    """(o, lse) of blocked local causal attention: the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors."""
    _check_shapes(q, k, v, key_bias, blk_seg, window, n_heads)
    side = () if blk_seg is None else (blk_seg,)
    if on_cpu(q, k, v, key_bias, *side):
        return local_window_fwd_plain(q, k, v, key_bias, blk_seg, window=window,
                                      n_heads=n_heads)
    BH, rep, N, D = q.shape
    live = local_half_live(key_bias, window, blk_seg).to(torch.int32).contiguous()
    check_cuda_inputs("local_fwd", data=(q, k, v), f32=(key_bias,), i32=(live,),
                      head_dim=D)
    o = torch.empty_like(q)
    lse = torch.empty((BH, rep, N), dtype=torch.float32, device=q.device)
    _build.launch("local_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  key_bias.data_ptr(), live.data_ptr(), o.data_ptr(), lse.data_ptr(),
                  BH, rep, N, D, window, n_heads, int(q.dtype == torch.bfloat16),
                  torch.cuda.current_stream(q.device).cuda_stream)
    COUNT.hit()
    return o, lse


class LocalWindowFn(torch.autograd.Function):
    """Differentiable blocked local attention in q, k, v (bias and segment
    ids take no gradient).  On CPU tensors the backward differentiates the
    plain version by autograd; on CUDA tensors it raises until the backward
    kernel (``repro/kernels/local.py::_bwd_kernel``) is ported with the LM
    training slice."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, blk_seg, window: int, n_heads: int):
        o, _ = local_window_fwd(q, k, v, key_bias, blk_seg, window=window,
                                n_heads=n_heads)
        ctx.save_for_backward(q, k, v, key_bias, blk_seg)
        ctx.kw = dict(window=window, n_heads=n_heads)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_bias, blk_seg = ctx.saved_tensors
        if q.device.type != "cpu":
            raise NotImplementedError(
                "local_fwd has no backward kernel yet: the backward of "
                "repro/kernels/local.py::_bwd_kernel comes with the LM training "
                "slice of the port")
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            o, _ = local_window_fwd_plain(*leaves, key_bias, blk_seg, **ctx.kw)
            dq, dk, dv = torch.autograd.grad(o, leaves, do)
        return dq, dk, dv, None, None, None, None
