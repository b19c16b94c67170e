"""Flash-attention kernels with the mask modes BSA needs, forward and
backward.

Replaces ``repro/kernels/flash.py::_fwd_kernel``, ``::_dq_kernel`` and
``::_dkv_kernel`` (Pallas, TPU), with the index masks of
``flash.py::_mask_logits``.  The CUDA sources are ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu`` (``flash_dq`` and ``flash_dkv``, one file: they share
their inputs, the mask code and the recompute of p).

What bounds them on the H100.  Per visible (row, key) pair the forward
does 4·D FLOP, ``flash_dq`` 6·D and ``flash_dkv`` 8·D.  In the compression
branch of ``shapenet-bsa`` (N = 3840 queries against L = 480 pooled keys,
D 32, fp32) that arithmetic bounds them on the FMA pipes; at the LM
prefill (one 32,768-token sequence against 512 pooled keys, bf16) the
bytes of Q and O bound the forward, and in the LM's train step (B·Hkv 8,
rep 8, N 4096 against L 64 pooled keys, D 64, bf16) the bytes of Q and dO
bound the backward, and parallelism: its 64 keys alone give ``flash_dkv``
one block per (batch, KV head).  The TPU carried the running softmax state
(and the backward's dQ / dK, dV sums) across sequential grid steps; Hopper
blocks run in no order.

- The forward (``csrc/flash_fwd.cu``, one rule: :func:`flash_fwd_plan`)
  gives a block 64 positions of one query head and walks the key tiles up
  to the last one its last position sees (:func:`fwd_walk`), the late
  (heavy) tiles launched first; a tile that sees no key (block-causal: every
  position t < ℓ) writes zeros and ``LSE_EMPTY`` and stops.  bf16 runs on
  the tensor cores (``mma.sync``, the online softmax in the accumulator's
  registers; the walk and tile step of ``csrc/mma_fwd.cuh``, shared with
  the tiled ``local_fwd``), fp32 on the FMA pipes in register tiles.

The backward (``csrc/flash_bwd.cu``):

- ``flash_dkv`` runs on (key tiles of 64, B·Hkv, S row splits): a block
  owns one key tile and one range of positions, walks the GQA group's rep
  heads over it in staged row tiles and keeps the group's dK, dV sum in
  registers.  A key tile's ranges start at its first visible position
  (:func:`dkv_ranges`), and a staged tile of ``LSE_EMPTY`` rows is
  skipped.  S (:func:`dkv_splits`) gives about four blocks per SM; with
  S > 1 the splits write fp32 partials into a (2, S, B·Hkv, L, D)
  workspace that this wrapper allocates, and a second pass behind the same
  entry point sums them in split order and casts (no atomics,
  deterministic).  Its fp32 block (``csrc/fma_bwd.cuh``) is shared with
  the packed-varlen ``varlen_dkv``.
- ``flash_dq`` gives a block 64 query rows and stages only the key tiles
  its last row can see.
- Tiles are staged by ``cp.async``, double-buffered, in the operand dtype;
  bf16 runs its products on the tensor cores (``mma.sync`` m16n8k16, fp32
  accumulation), fp32 on the FMA pipes in register micro-tiles with the
  dK/dV (dQ) sums split over threads by dims.

The ragged last key tile (L = 480) and row tile are masked in the kernels,
so nothing is padded here.  Query rows the forward skipped (a 64-row tile
none of whose rows is a valid query, ``q_valid``) carry o = 0 and lse =
``LSE_EMPTY``; the backward kernels read that residual, so their dQ is
exactly 0 and they add nothing to dK, dV.

Layout: q (B·Hkv, rep, N, D); k, v (B·Hkv, L, D); key_bias (B, L) fp32;
q_valid (B, N) bool or None.  ``causal``: key j visible to query t iff
j ≤ t; ``block_causal``: coarse key j visible iff (j+1)·ℓ − 1 < t.
The forward returns o like q and lse (B·Hkv, rep, N) fp32.
:class:`FlashAttentionFn` is the differentiable op.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch.core.branches import sdpa
from repro_torch.kernels import _build
from repro_torch.kernels.common import (HEAD_DIMS, _counter, check_cuda_inputs, on_cpu,
                                        p_from_lse, row_delta)
from repro_torch.numerics import NEG_INF

__all__ = ["flash_attention_fwd", "flash_attention_fwd_plain", "flash_attention_bwd",
           "flash_attention_bwd_plain", "flash_attention_dq", "flash_attention_dkv",
           "flash_fwd_plan", "FlashFwdPlan", "fwd_walk", "dkv_splits", "dkv_ranges",
           "FlashAttentionFn", "COUNT", "COUNT_DQ", "COUNT_DKV"]

COUNT = _counter("flash_fwd")
COUNT_DQ = _counter("flash_dq")
COUNT_DKV = _counter("flash_dkv")


class FlashFwdPlan(NamedTuple):
    """How ``flash_fwd`` takes one shape: ``path`` ``"mma"`` (bf16, tensor
    cores) or ``"fma"`` (fp32, register tiles); ``rows``: positions of one
    query head a block; ``keys``: keys a staged tile."""
    path: str
    rows: int
    keys: int


def flash_fwd_plan(D: int, dtype: torch.dtype) -> FlashFwdPlan:
    """The path and tiles of ``flash_fwd`` at head dim D: the rule its CUDA
    entry point applies by dtype, with the constants of
    ``csrc/flash_fwd.cu`` (``FwdMma``, ``FwdFma``).  bf16 takes the tensor
    cores, 64 positions against 64-key tiles; fp32 the FMA pipes, 64
    positions against 32-key tiles (at shapenet's shape faster than one
    thread a row).  A shape no path takes raises."""
    if dtype not in (torch.float32, torch.bfloat16) or D not in HEAD_DIMS["flash_fwd"]:
        raise ValueError(f"flash_fwd: no path takes D {D}, {dtype} (D in "
                         f"{HEAD_DIMS['flash_fwd']}; float32 or bfloat16)")
    if dtype == torch.bfloat16:
        return FlashFwdPlan("mma", 64, 64)
    return FlashFwdPlan("fma", 64, 32)


def keys_seen(t: int, L: int, *, causal: bool, block_causal: bool, ell: int) -> int:
    """How many keys (0, 1, …) query position t sees."""
    if block_causal:
        return min(L, t // ell)
    return min(L, t + 1) if causal else L


def fwd_walk(N: int, L: int, D: int, dtype: torch.dtype, *, causal: bool = False,
             block_causal: bool = False, ell: int = 1) -> list[tuple[int, int, int]]:
    """The tiled forward's walk of one query head, as ``csrc/flash_fwd.cu``
    (``row_tile``, ``tile_kmax``) runs it: for each tile of positions
    [t0, t1), the number of key tiles it stages, those up to the one holding
    the last key its last position sees (0: the tile writes zeros and
    ``LSE_EMPTY``)."""
    plan = flash_fwd_plan(D, dtype)
    kw = dict(causal=causal, block_causal=block_causal, ell=ell)
    out = []
    for t0 in range(0, N, plan.rows):
        t1 = min(N, t0 + plan.rows)
        out.append((t0, t1, -(-keys_seen(t1 - 1, L, **kw) // plan.keys)))
    return out


# flash_dkv's tiles (csrc/flash_bwd.cu: DkvMma, DkvFma): 64 keys a block,
# staged row tiles of 64 positions (32 at D 128)
DKV_KEYS = 64


def dkv_row_tile(D: int) -> int:
    """Positions per staged row tile of ``flash_dkv`` at head dim D."""
    return 32 if D > 64 else 64


def first_visible(j: int, *, causal: bool, block_causal: bool, ell: int) -> int:
    """The first query position that sees key j."""
    if block_causal:
        return (j + 1) * ell
    return j if causal else 0


def dkv_splits(N: int, L: int, BH: int, D: int, *, causal: bool = False,
               block_causal: bool = False, ell: int = 1, sms: int = 132) -> int:
    """S, the row splits of ``flash_dkv``: enough for about four blocks on
    each of the ``sms`` SMs, never more than the first key tile has row
    tiles of live positions, at least 1."""
    blocks = -(-L // DKV_KEYS) * BH
    live = N - min(N, first_visible(0, causal=causal, block_causal=block_causal, ell=ell))
    return max(1, min(-(-4 * sms // max(blocks, 1)), -(-live // dkv_row_tile(D))))


def dkv_ranges(kt: int, S: int, N: int, D: int, *, causal: bool = False,
               block_causal: bool = False, ell: int = 1) -> list[tuple[int, int]]:
    """The positions [lo, hi) each of the S splits of key tile ``kt`` walks:
    [first visible position, N) cut into S chunks of whole row tiles, as
    ``csrc/flash_bwd.cu::split_range`` cuts it (trailing splits may be
    empty)."""
    first = min(N, first_visible(kt * DKV_KEYS, causal=causal, block_causal=block_causal,
                                 ell=ell))
    bm = dkv_row_tile(D)
    chunk = -(-(-(-(N - first) // S)) // bm) * bm
    out = []
    for s in range(S):
        lo = min(N, first + s * chunk)
        out.append((lo, min(N, lo + chunk)))
    return out


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


def _bwd_check(name, q, lse, delta, do, k, v, key_bias):
    BH, rep, N, D = q.shape
    if do.shape != q.shape or lse.shape != (BH, rep, N) or delta.shape != lse.shape:
        raise ValueError(f"{name}: dO must be {tuple(q.shape)} and lse / delta "
                         f"{(BH, rep, N)}")
    check_cuda_inputs(name, data=(q, k, v, do), f32=(key_bias, lse, delta), head_dim=D)


def flash_attention_dq(q, k, v, key_bias, do, lse, delta, *, n_heads: int,
                       causal: bool = False, block_causal: bool = False, ell: int = 1):
    """dq from the forward's lse and δ = rowsum(dO·O): the ``flash_dq``
    kernel on CUDA tensors, the plain version on CPU tensors."""
    kw = dict(n_heads=n_heads, causal=causal, block_causal=block_causal, ell=ell)
    _check_shapes("flash_dq", q, k, v, key_bias, n_heads)
    if on_cpu(q, k, v, key_bias, do, lse, delta):
        return flash_attention_bwd_plain(q, k, v, key_bias, do, lse, delta, **kw)[0]
    _bwd_check("flash_dq", q, lse, delta, do, k, v, key_bias)
    BH, rep, N, D = q.shape
    dq = torch.empty_like(q)
    _build.launch("flash_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
                  do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), BH, rep,
                  N, k.shape[1], D, n_heads, int(causal), int(block_causal), ell,
                  int(q.dtype == torch.bfloat16),
                  torch.cuda.current_stream(q.device).cuda_stream)
    COUNT_DQ.hit()
    return dq


def flash_attention_dkv(q, k, v, key_bias, do, lse, delta, *, n_heads: int,
                        causal: bool = False, block_causal: bool = False, ell: int = 1):
    """(dk, dv) from the forward's lse and δ: the ``flash_dkv`` kernel on
    CUDA tensors (its row splits from :func:`dkv_splits` for the card), the
    plain version on CPU tensors."""
    kw = dict(n_heads=n_heads, causal=causal, block_causal=block_causal, ell=ell)
    _check_shapes("flash_dkv", q, k, v, key_bias, n_heads)
    if on_cpu(q, k, v, key_bias, do, lse, delta):
        return flash_attention_bwd_plain(q, k, v, key_bias, do, lse, delta, **kw)[1:]
    _bwd_check("flash_dkv", q, lse, delta, do, k, v, key_bias)
    BH, rep, N, D = q.shape
    L = k.shape[1]
    S = dkv_splits(N, L, BH, D, causal=causal, block_causal=block_causal, ell=ell,
                   sms=torch.cuda.get_device_properties(q.device).multi_processor_count)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ws = (torch.empty((2, S, BH, L, D), dtype=torch.float32, device=q.device)
          if S > 1 else None)
    _build.launch("flash_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
                  do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), None if ws is None else ws.data_ptr(), BH, rep, N, L, D,
                  n_heads, int(causal), int(block_causal), ell, S,
                  int(q.dtype == torch.bfloat16),
                  torch.cuda.current_stream(q.device).cuda_stream)
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
