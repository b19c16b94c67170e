"""Blocked local causal attention kernels (the causal LM's local branch),
forward and backward.

Replaces ``repro/kernels/local.py::_fwd_kernel`` and ``::_bwd_kernel``
(Pallas, TPU).  The CUDA sources are ``csrc/local_fwd.cu``
(``local_fwd_mma``, ``local_fwd_rows``) and ``csrc/local_bwd.cu``
(``local_dq`` and ``local_dkv``).  Query block i
(``window`` = w positions) attends causally within block i and fully to
block i−1, the blocked equivalent of a sliding window of w..2w keys.

What bounds them on the H100: each query row does 4·D FLOP per visible key
(w to 2w of them) forward and 14·D backward against one read of its q row,
so the arithmetic bounds them at the LM's shapes.  The TPU fetched the prev
and self key halves with two index maps, skipped dead halves through a
scalar-prefetched liveness table, and ran the backward in one grid cell per
block that also fetched the next query block.  Here the forward and
``local_dq`` give a block 64 rows of one (b·h, query head, block) that walk
the live prev half's key tiles and the self half's up to their diagonal
tile (:func:`dq_walk`, the walk of both); ``local_dkv``
gives a block 64 keys of one (b·h, block) and walks the rep query heads
over the rows that see them, its own block's from its first key on,
causally, and the next block's in full (:func:`dkv_walk`).  The backward's
two kernels each own their outputs (no atomics, a fixed order of sums).
One rule picks the path of all three (:func:`local_plan`): bf16 with a
window that is a multiple of 64 (the LM's 256) runs on the tensor cores
(``mma.sync``, tiles staged by ``cp.async``; the forward's tile step is
``flash_fwd``'s); fp32 and smaller windows keep the FMA pipes, the forward
one thread a row in blocks of 128 rows with 64-key staged tiles, the
backward 4 lanes a row or key.  The liveness of the two halves, (B, N/w, 2), is
computed here once a call (``occupancy.local_half_live``), with the packed
layout's segment rule folded into the prev half; block i's "next" flag is
block i+1's prev flag.  The kernels read no segment ids.

Layout: q (B·Hkv, rep, N, D); k, v (B·Hkv, N, D); key_bias (B, N) fp32
(0 valid / NEG_INF padding); blk_seg (B, N/w) int32 per-block segment ids
or None (one segment).  The forward returns o like q and lse
(B·Hkv, rep, N) fp32 (``LSE_EMPTY`` on a row with no valid key); the
backward takes them with dO and δ = rowsum(dO·O).  :class:`LocalWindowFn`
is the differentiable op.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch.core.branches import sdpa
from repro_torch.kernels import _build
from repro_torch.kernels.common import (HEAD_DIMS, _counter, check_cuda_inputs, on_cpu,
                                        p_from_lse, row_delta)
from repro_torch.kernels.occupancy import local_half_live
from repro_torch.numerics import NEG_INF

__all__ = ["local_window_fwd", "local_window_fwd_plain", "local_window_bwd",
           "local_window_bwd_plain", "local_window_dq", "local_window_dkv", "local_plan",
           "LocalPlan", "dq_walk", "dkv_walk", "live_map", "LocalWindowFn", "COUNT",
           "COUNT_DQ", "COUNT_DKV"]

COUNT = _counter("local_fwd")
COUNT_DQ = _counter("local_dq")
COUNT_DKV = _counter("local_dkv")


class LocalPlan(NamedTuple):
    """How ``local_fwd`` / ``local_dq`` / ``local_dkv`` take one shape:
    ``path`` ``"tiles"`` (tensor cores: ``local_fwd_mma``, ``local_dq_mma``,
    ``local_dkv_mma``) or ``"lanes"`` (FMA pipes: ``local_fwd_rows``, one
    thread a row in blocks of 128, and the backward's 4 lanes a row or
    key); ``rows``: positions a ``local_dq`` block (and a tiled
    ``local_fwd`` block); ``keys``: keys a ``local_dkv`` block;
    ``key_tile``: keys a staged tile of ``local_dq`` and ``local_fwd``;
    ``row_tile``: rows a staged tile of ``local_dkv``."""
    path: str
    rows: int
    keys: int
    key_tile: int
    row_tile: int


TILE = 64                   # the tiled path's rows a local_dq block, keys a local_dkv block


def local_plan(window: int, D: int, dtype: torch.dtype) -> LocalPlan:
    """The path and tiles of the local kernels at this window and head dim
    (the constants of ``csrc/local_fwd.cu`` and ``csrc/local_bwd.cu``).
    bf16 with a window that is a multiple of 64 takes the tiled path
    (``FwdMma`` and ``DqMma``: 64 rows against 64-key tiles; ``DkvMma``: 64
    keys against 64-row tiles, 32 at D 128); the rest the lanes path (the
    backward 64 rows or keys a block, the forward 128 rows; staged tiles of
    64, ``4096 / D`` at D 128).  A shape no path takes raises."""
    if (dtype not in (torch.float32, torch.bfloat16) or D not in HEAD_DIMS["local_dq"]
            or window < 1):
        raise ValueError(f"local kernels: no path takes window {window}, D {D}, {dtype} "
                         f"(window ≥ 1; D in {HEAD_DIMS['local_dq']}; float32 or bfloat16)")
    if dtype == torch.bfloat16 and window % TILE == 0:
        return LocalPlan("tiles", TILE, TILE, TILE, 32 if D > 64 else 64)
    staged = 4096 // D if D > 64 else 64
    return LocalPlan("lanes", 64, 64, staged, staged)


def dq_walk(window: int, D: int, dtype: torch.dtype, *, live_prev: bool = True,
            live_self: bool = True) -> list[tuple[int, int, list[tuple[int, int, bool]]]]:
    """The walk of one block i of the tiled ``local_fwd`` and ``local_dq``
    (``csrc/local_fwd.cu``: ``local_fwd_mma``; ``csrc/local_bwd.cu``:
    ``local_dq_mma``), positions counted from block i's start: for each
    block of rows [t0, t1), the key tiles [j0, j1) it stages, block i−1's at
    −w..0, each with whether it is masked causally (the diagonal tile).  A
    row block with no tile (both halves dead) writes zeros (and, forward,
    ``LSE_EMPTY``) without reading K or V."""
    plan = local_plan(window, D, dtype)
    if plan.path != "tiles":
        raise ValueError(f"dq_walk: window {window}, {dtype} takes the lanes path")
    w, kt = window, plan.key_tile
    prev = [(j, j + kt, False) for j in range(-w, 0, kt)] if live_prev else []
    return [(t0, t0 + plan.rows,
             prev + ([(j, j + kt, j == t0) for j in range(0, t0 + plan.rows, kt)]
                     if live_self else []))
            for t0 in range(0, w, plan.rows)]


def dkv_walk(window: int, D: int, dtype: torch.dtype, *, live_next: bool = True
             ) -> list[tuple[int, int, list[tuple[int, int, bool]]]]:
    """The tiled ``local_dkv``'s walk of one block i and one query head
    (``csrc/local_bwd.cu``: ``local_dkv_mma``), positions counted from block
    i's start: for each block of keys [j0, j1), the row tiles [t0, t1) it
    stages, block i+1's rows at w..2w (when its prev half is live), each
    with whether it is masked causally."""
    plan = local_plan(window, D, dtype)
    if plan.path != "tiles":
        raise ValueError(f"dkv_walk: window {window}, {dtype} takes the lanes path")
    w, rt_ = window, plan.row_tile
    out = []
    for j0 in range(0, w, plan.keys):
        tiles = [(t0, t0 + rt_, t0 < j0 + plan.keys) for t0 in range(j0, w, rt_)]
        if live_next:
            tiles += [(t0, t0 + rt_, False) for t0 in range(w, 2 * w, rt_)]
        out.append((j0, j0 + plan.keys, tiles))
    return out


def live_map(key_bias, blk_seg, window: int) -> torch.Tensor:
    """The kernels' (B, N/w, 2) int32 liveness of each block's two halves
    (``occupancy.local_half_live``)."""
    return local_half_live(key_bias, window, blk_seg).to(torch.int32).contiguous()


def _check_shapes(name, q, k, v, key_bias, blk_seg, window, n_heads):
    BH, rep, N, D = q.shape
    B = BH // n_heads
    if window <= 0 or N % window:
        raise ValueError(f"{name}: N={N} is not a multiple of the window {window}")
    if k.shape != (BH, N, D) or v.shape != k.shape or key_bias.shape != (B, N):
        raise ValueError(f"{name}: k/v must be {(BH, N, D)} and key_bias {(B, N)}, "
                         f"got {tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(key_bias.shape)}")
    if blk_seg is not None and blk_seg.shape != (B, N // window):
        raise ValueError(f"{name}: blk_seg must be {(B, N // window)}, "
                         f"got {tuple(blk_seg.shape)}")


def _with_prev(t, w: int):
    """(BH, N, D) → (BH, N/w, 2w, D): each block's keys after its
    predecessor's (zeros before block 0)."""
    BH, N, D = t.shape
    tb = t.reshape(BH, N // w, w, D)
    return torch.cat([torch.cat([torch.zeros_like(tb[:, :1]), tb[:, :-1]], 1), tb], 2)


def _window_bias(key_bias, blk_seg, w: int, n_heads: int):
    """(B·Hkv, N/w, 1, w, 2w) additive bias of each block's rows against
    [prev block, own block]: the key bias, NEG_INF on the prev half of block
    0 and of a block whose predecessor lies in another segment, and the
    causal rule on the self half."""
    B, N = key_bias.shape
    nb = N // w
    kbias = key_bias.reshape(B, nb, w)
    neg = torch.full_like(kbias[:, :1], NEG_INF)
    pbias = torch.cat([neg, kbias[:, :-1]], dim=1)
    if blk_seg is not None:
        same = torch.cat([torch.zeros_like(blk_seg[:, :1], dtype=torch.bool),
                          blk_seg[:, 1:] == blk_seg[:, :-1]], dim=1)
        pbias = torch.where(same[..., None], pbias, NEG_INF)
    ok = torch.ones((w, 2 * w), dtype=torch.bool, device=key_bias.device)
    ok[:, w:] = torch.tril(ok[:, w:])                              # self half: causal
    bias = torch.where(ok, torch.cat([pbias, kbias], dim=2)[:, :, None, :], NEG_INF)
    return bias.repeat_interleave(n_heads, dim=0)[:, :, None]      # (BH,nb,1,w,2w)


def _blocks(t, w: int):
    """(BH, rep, N, ·) → (BH, N/w, rep, w, ·)."""
    BH, rep, N = t.shape[:3]
    return t.reshape(BH, rep, N // w, w, *t.shape[3:]).transpose(1, 2)


def _unblocks(t):
    """Inverse of :func:`_blocks`."""
    BH, nb, rep, w = t.shape[:4]
    return t.transpose(1, 2).reshape(BH, rep, nb * w, *t.shape[4:])


def local_window_fwd_plain(q, k, v, key_bias, blk_seg=None, *, window: int,
                           n_heads: int):
    """Plain PyTorch version of the forward kernel: same inputs, same
    (o, lse).  Each block's rows attend the 2w keys [prev block, own block]
    under one (w, 2w) bias (:func:`_window_bias`)."""
    w = window
    bias = _window_bias(key_bias, blk_seg, w, n_heads)
    o, lse = sdpa(_blocks(q, w), _with_prev(k, w)[:, :, None], _with_prev(v, w)[:, :, None],
                  bias, return_lse=True)
    return _unblocks(o), _unblocks(lse)


def local_window_fwd(q, k, v, key_bias, blk_seg=None, *, window: int, n_heads: int):
    """(o, lse) of blocked local causal attention: the CUDA kernel on CUDA
    tensors (on the path :func:`local_plan` picks), the plain version on CPU
    tensors."""
    _check_shapes("local_fwd", q, k, v, key_bias, blk_seg, window, n_heads)
    side = () if blk_seg is None else (blk_seg,)
    if on_cpu(q, k, v, key_bias, *side):
        return local_window_fwd_plain(q, k, v, key_bias, blk_seg, window=window,
                                      n_heads=n_heads)
    BH, rep, N, D = q.shape
    live = live_map(key_bias, blk_seg, window)
    check_cuda_inputs("local_fwd", data=(q, k, v), f32=(key_bias,), i32=(live,),
                      head_dim=D)
    plan = local_plan(window, D, q.dtype)
    o = torch.empty_like(q)
    lse = torch.empty((BH, rep, N), dtype=torch.float32, device=q.device)
    _build.launch("local_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  key_bias.data_ptr(), live.data_ptr(), o.data_ptr(), lse.data_ptr(),
                  BH, rep, N, D, window, n_heads, int(q.dtype == torch.bfloat16),
                  int(plan.path == "tiles"), torch.cuda.current_stream(q.device).cuda_stream)
    COUNT.hit()
    return o, lse


def local_window_bwd_plain(q, k, v, key_bias, blk_seg, do, lse, delta, *, window: int,
                           n_heads: int):
    """Plain PyTorch version of the two backward kernels, on the forward's
    (w, 2w) blocked layout: p recomputed from lse, dP = dO·Vᵀ,
    dS = p(dP − δ)·scale, dQ = dS·K, dK = dSᵀQ, dV = pᵀdO; block i's keys
    collect its own rows' (self half) and block i+1's rows' (prev half)
    contributions, summed over the group's rep query heads; p and dS rounded
    to the operand dtype before their products.  Returns (dq, dk, dv)."""
    BH, rep, N, D = q.shape
    w = window
    scale = D ** -0.5
    adt = q.dtype
    bias = _window_bias(key_bias, blk_seg, w, n_heads)
    qb, dob = _blocks(q.float(), w), _blocks(do.float(), w)        # (BH,nb,rep,w,D)
    lb, db = (_blocks(t, w)[..., None] for t in (lse, delta))       # (BH,nb,rep,w,1)
    kk, vv = (_with_prev(t.float(), w)[:, :, None] for t in (k, v))  # (BH,nb,1,2w,D)
    s = torch.matmul(qb, kk.transpose(-1, -2)) * scale + bias
    p = p_from_lse(s, lb)                                           # (BH,nb,rep,w,2w)
    dp = torch.matmul(dob, vv.transpose(-1, -2))
    ds = (p * (dp - db) * scale).to(adt).float()
    dq = torch.matmul(ds, kk)

    def own_keys(g):                       # (BH, nb, 2w, D) → block i's keys
        out = g[:, :, w:].clone()
        out[:, :-1] += g[:, 1:, :w]        # block i+1's prev half is block i
        return out.reshape(BH, N, D)

    dk = own_keys(torch.einsum("bnrtj,bnrtd->bnjd", ds, qb))
    dv = own_keys(torch.einsum("bnrtj,bnrtd->bnjd", p.to(adt).float(), dob))
    return _unblocks(dq).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_launch(name, outs, q, k, v, key_bias, live, do, lse, delta, *, window, n_heads):
    BH, rep, N, D = q.shape
    if do.shape != q.shape or lse.shape != (BH, rep, N) or delta.shape != lse.shape:
        raise ValueError(f"{name}: dO must be {tuple(q.shape)} and lse / delta "
                         f"{(BH, rep, N)}")
    if live.shape != (BH // n_heads, N // window, 2):
        raise ValueError(f"{name}: live must be {(BH // n_heads, N // window, 2)}, "
                         f"got {tuple(live.shape)}")
    check_cuda_inputs(name, data=(q, k, v, do), f32=(key_bias, lse, delta), i32=(live,),
                      head_dim=D)
    plan = local_plan(window, D, q.dtype)
    _build.launch(name, q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
                  live.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                  *(t.data_ptr() for t in outs), BH, rep, N, D, window, n_heads,
                  int(q.dtype == torch.bfloat16), int(plan.path == "tiles"),
                  torch.cuda.current_stream(q.device).cuda_stream)


def local_window_dq(q, k, v, key_bias, blk_seg, do, lse, delta, *, window: int,
                    n_heads: int, live=None):
    """dq from the forward's lse and δ = rowsum(dO·O): the ``local_dq``
    kernel on CUDA tensors (``live``: the halves' int32 liveness, computed
    here when None), the plain version on CPU tensors."""
    kw = dict(window=window, n_heads=n_heads)
    _check_shapes("local_dq", q, k, v, key_bias, blk_seg, window, n_heads)
    side = () if blk_seg is None else (blk_seg,)
    if on_cpu(q, k, v, key_bias, do, lse, delta, *side):
        return local_window_bwd_plain(q, k, v, key_bias, blk_seg, do, lse, delta, **kw)[0]
    live = live_map(key_bias, blk_seg, window) if live is None else live
    dq = torch.empty_like(q)
    _bwd_launch("local_dq", (dq,), q, k, v, key_bias, live, do, lse, delta, **kw)
    COUNT_DQ.hit()
    return dq


def local_window_dkv(q, k, v, key_bias, blk_seg, do, lse, delta, *, window: int,
                     n_heads: int, live=None):
    """(dk, dv) from the forward's lse and δ: the ``local_dkv`` kernel on
    CUDA tensors (``live`` as for :func:`local_window_dq`), the plain
    version on CPU tensors."""
    kw = dict(window=window, n_heads=n_heads)
    _check_shapes("local_dkv", q, k, v, key_bias, blk_seg, window, n_heads)
    side = () if blk_seg is None else (blk_seg,)
    if on_cpu(q, k, v, key_bias, do, lse, delta, *side):
        return local_window_bwd_plain(q, k, v, key_bias, blk_seg, do, lse, delta, **kw)[1:]
    live = live_map(key_bias, blk_seg, window) if live is None else live
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("local_dkv", (dk, dv), q, k, v, key_bias, live, do, lse, delta, **kw)
    COUNT_DKV.hit()
    return dk, dv


def local_window_bwd(q, k, v, key_bias, blk_seg, do, lse, delta, *, window: int,
                     n_heads: int):
    """(dq, dk, dv): the two backward kernels (``local_dq``, ``local_dkv``)
    on CUDA tensors, sharing one liveness map, the plain version on CPU
    tensors."""
    kw = dict(window=window, n_heads=n_heads)
    side = () if blk_seg is None else (blk_seg,)
    if on_cpu(q, k, v, key_bias, do, lse, delta, *side):
        return local_window_bwd_plain(q, k, v, key_bias, blk_seg, do, lse, delta, **kw)
    _check_shapes("local_dq", q, k, v, key_bias, blk_seg, window, n_heads)
    live = live_map(key_bias, blk_seg, window)
    return (local_window_dq(q, k, v, key_bias, blk_seg, do, lse, delta, live=live, **kw),
            *local_window_dkv(q, k, v, key_bias, blk_seg, do, lse, delta, live=live, **kw))


class LocalWindowFn(torch.autograd.Function):
    """Differentiable blocked local attention in q, k, v (bias and segment
    ids take no gradient)."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, blk_seg, window: int, n_heads: int):
        o, lse = local_window_fwd(q, k, v, key_bias, blk_seg, window=window,
                                  n_heads=n_heads)
        ctx.save_for_backward(q, k, v, key_bias, blk_seg, o, lse)
        ctx.kw = dict(window=window, n_heads=n_heads)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, key_bias, blk_seg, o, lse = ctx.saved_tensors
        do = do.contiguous()
        dq, dk, dv = local_window_bwd(q, k, v, key_bias, blk_seg, do, lse,
                                      row_delta(do, o), **ctx.kw)
        return dq, dk, dv, None, None, None, None
