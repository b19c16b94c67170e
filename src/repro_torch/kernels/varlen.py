"""Packed-varlen flash attention (the cu_seqlens idiom), forward and backward.

Replaces ``repro/kernels/varlen.py::_fwd_kernel``, ``::_dq_kernel`` and
``::_dkv_kernel`` (Pallas, TPU).  The CUDA sources are ``csrc/varlen_fwd.cu``
and ``csrc/varlen_bwd.cu`` (``varlen_dq`` and ``varlen_dkv``).

All samples of a batch lie on one packed axis: T query positions and L key
positions, each axis cut into segments by its own offsets (the compression
branch passes ``k_offsets = offsets // ℓ`` for its pooled keys).  A query
attends only keys of its own segment; the capacity tail (positions at or
after the last offset) is segment S, which matches no real sample.

What bounds them on the H100: the work is Σᵢ Tᵢ·Lᵢ (row, key) pairs of
4·D FLOP forward and 10·D backward, a few D-wide rows of bytes each, so the
arithmetic bounds them.  The TPU kernel runs the whole (q-tile, k-tile)
grid and skips the cells whose per-tile segment ranges do not overlap.
Here every kernel has two paths, one rule by dtype (:func:`varlen_plan`):

- ``fma`` (fp32, the main path's dtype): host plans from the offsets
  (cached on their values) cut the segments into tiles that never cross a
  segment boundary, so a block does Σᵢ Tᵢ·Lᵢ work, not T·L, and no segment
  test is left inside it: the key bias and lse = ``LSE_EMPTY`` mask the
  rest.  ``varlen_fwd`` and ``varlen_dq`` walk
  :func:`repro_torch.kernels.occupancy.varlen_row_tiles` (each segment's
  rows in tiles of 64, each with its segment's keys): a block runs
  ``flash_fwd_fma``'s block (``csrc/fma_fwd.cuh``) or ``flash_dq_fma``'s
  (``csrc/fma_bwd.cuh``) on one (row tile, query head of the group, KV
  head).  ``varlen_dkv`` walks
  :func:`repro_torch.kernels.occupancy.varlen_dkv_tiles` (each segment's
  keys in tiles of 64, each tile's segment rows cut into S splits of whole
  64-row tiles, about four blocks an SM): a block runs ``flash_dkv_fma``'s
  block (``csrc/fma_bwd.cuh``) on one (tile, KV head, split), the GQA
  group's rep query heads summed in its walk.  With S > 1 the splits write
  fp32 partials into a (2, S, Hkv, L, D) workspace this wrapper allocates,
  summed in split order by a second pass behind the same entry point: no
  atomics, bit-reproducible.  The fp32 CUDA path needs the host offsets
  (``offsets=(q_offsets, k_offsets)``) and raises without them.
- ``rows`` (bf16; no main path runs it): ``varlen_fwd`` and ``varlen_dq``
  run a block of 128 query rows (one KV head, one of its rep query heads,
  one thread a row) that reads the segment ids of its first and last row
  and folds only the keys of those segments, ``[k_bounds[s_first],
  k_bounds[s_last + 1])``, with a per-(row, key) test ``qseg == kseg`` on
  top of the key bias; ``varlen_dkv`` a block of 32 keys, one a thread,
  that folds only the query rows of their segments, with the GQA group's
  rep query heads summed in that loop.

Tiles whose key range holds no valid key are skipped, and rows that saw no
valid key (o = 0, lse = ``LSE_EMPTY``, e.g. the capacity tail of the
compression branch) are skipped by the backward.

Layout (GQA-native, as the TPU kernel): q (Hkv, rep, T, D); k, v
(Hkv, L, D); key_bias (1, L) fp32 additive; qseg (1, T) / kseg (1, L)
int32 segment ids; q_bounds / k_bounds (S+2,) int32 segment boundaries
(``kernels/occupancy.py::varlen_maps``).  The forward returns o like q and
lse (Hkv, rep, T) fp32.  :class:`VarlenAttentionFn` is the differentiable
op; segment ids, boundaries and the key bias take no gradient, and the host
offsets ride along for the plans.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch.core.branches import sdpa
from repro_torch.kernels import _build
from repro_torch.kernels.common import (HEAD_DIMS, _counter, check_cuda_inputs, on_cpu,
                                        p_from_lse, row_delta)
from repro_torch.kernels.occupancy import varlen_dkv_tiles, varlen_row_tiles
from repro_torch.numerics import mask_to_bias

__all__ = ["flash_attention_varlen_fwd", "flash_attention_varlen_fwd_plain",
           "flash_attention_varlen_bwd", "flash_attention_varlen_bwd_plain",
           "flash_attention_varlen_dq", "flash_attention_varlen_dkv", "varlen_plan",
           "VarlenPlan", "VarlenAttentionFn", "COUNT", "COUNT_DQ", "COUNT_DKV",
           "PLAIN_CHUNK"]

COUNT = _counter("varlen_fwd")
COUNT_DQ = _counter("varlen_dq")
COUNT_DKV = _counter("varlen_dkv")

# query rows per chunk of the plain versions: they hold (Hkv, rep, chunk, L)
# logits at once, not (Hkv, rep, T, L)
PLAIN_CHUNK = 2048


class VarlenPlan(NamedTuple):
    """How the varlen kernels take one shape: ``path`` ``"fma"`` (fp32,
    register tiles on planned walks: ``varlen_fwd_fma``, ``varlen_dq_fma``,
    ``varlen_dkv_fma``) or ``"rows"`` (bf16, one thread a row or key:
    ``varlen_fwd_rows``, ``varlen_dq_rows``, ``varlen_dkv_rows``);
    ``rows``: query rows a ``varlen_fwd`` / ``varlen_dq`` block (the row
    tile of :func:`varlen_row_tiles`); ``keys``: keys a ``varlen_dkv``
    block; ``key_tile``: keys a staged tile of ``varlen_fwd`` /
    ``varlen_dq``; ``row_tile``: query rows a staged tile of
    ``varlen_dkv``."""
    path: str
    rows: int
    keys: int
    key_tile: int
    row_tile: int


def varlen_plan(D: int, dtype: torch.dtype) -> VarlenPlan:
    """The path and tiles of ``varlen_fwd``, ``varlen_dq`` and
    ``varlen_dkv`` at head dim D: the rule their CUDA entry points apply by
    dtype.  fp32 takes the fma path, with the constants of
    ``csrc/fma_fwd.cuh`` / ``csrc/fma_bwd.cuh`` (``FwdFma`` and ``DqFma``:
    64 rows against 32-key tiles; ``DkvFma``: 64 keys against 64-row tiles
    at D ≤ 64); bf16 the rows path, with those of ``csrc/varlen_fwd.cu`` /
    ``csrc/varlen_bwd.cu`` (``kRows`` 128 rows against ``kTile`` 64-key
    tiles; ``kKeys`` 32 keys against ``kQTile`` 64-row tiles).  A shape no
    path takes raises."""
    if dtype not in (torch.float32, torch.bfloat16) or D not in HEAD_DIMS["varlen_fwd"]:
        raise ValueError(f"varlen kernels: no path takes D {D}, {dtype} (D in "
                         f"{HEAD_DIMS['varlen_fwd']}; float32 or bfloat16)")
    if dtype == torch.float32:
        return VarlenPlan("fma", 64, 64, 32, 64)
    return VarlenPlan("rows", 128, 32, 64, 64)


def _row_plan(name, q, k, offsets):
    """The fma path's row plan (tiles, 4) of this call, None on the rows
    path."""
    T, L = q.shape[2], k.shape[1]
    plan = varlen_plan(q.shape[3], q.dtype)
    if plan.path != "fma":
        return None
    if offsets is None:
        raise ValueError(f"{name}: the fp32 path plans its walk from the host offsets; "
                         "pass offsets=(q_offsets, k_offsets)")
    return varlen_row_tiles(*offsets, T, L, q.device, rows=plan.rows)


def _check_shapes(name, q, k, v, key_bias, qseg, kseg, q_bounds, k_bounds):
    H, rep, T, D = q.shape
    L = k.shape[1]
    if (k.shape != (H, L, D) or v.shape != k.shape or key_bias.shape != (1, L)
            or qseg.shape != (1, T) or kseg.shape != (1, L)):
        raise ValueError(f"{name}: k/v must be {(H, L, D)}, key_bias and kseg "
                         f"{(1, L)}, qseg {(1, T)}; got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(key_bias.shape)}, "
                         f"{tuple(kseg.shape)}, {tuple(qseg.shape)}")
    if q_bounds.dim() != 1 or q_bounds.shape != k_bounds.shape:
        raise ValueError(f"{name}: q_bounds and k_bounds must be one (S+2,) "
                         f"shape, got {tuple(q_bounds.shape)}, {tuple(k_bounds.shape)}")


def _chunk_bias(key_bias, qseg, kseg, rows):
    """(1, 1, c, L) additive bias of the query rows ``rows``: the key bias
    plus NEG_INF on every key of another segment."""
    same = qseg[0, rows][:, None] == kseg[0][None, :]
    return (key_bias[0][None, :] + mask_to_bias(same))[None, None]


def flash_attention_varlen_fwd_plain(q, k, v, key_bias, qseg, kseg, *,
                                     chunk: int = PLAIN_CHUNK):
    """Plain PyTorch version of the forward kernel: dense attention of every
    query row against every key with the segment mask, in query chunks.
    Returns (o, lse)."""
    T = q.shape[2]
    outs, lses = [], []
    for s in range(0, T, chunk):
        rows = slice(s, min(s + chunk, T))
        o, lse = sdpa(q[:, :, rows], k[:, None], v[:, None],
                      _chunk_bias(key_bias, qseg, kseg, rows), return_lse=True)
        outs.append(o)
        lses.append(lse)
    return torch.cat(outs, 2), torch.cat(lses, 2)


def flash_attention_varlen_fwd(q, k, v, key_bias, qseg, kseg, q_bounds, k_bounds, *,
                               offsets=None):
    """(o, lse) of packed-varlen attention: the ``varlen_fwd`` kernel on
    CUDA tensors, the plain version on CPU tensors.  ``offsets``: the host
    (q_offsets, k_offsets) the maps were built from; the fma path (fp32)
    plans its walk from them (:func:`varlen_row_tiles`) and raises without
    them."""
    _check_shapes("varlen_fwd", q, k, v, key_bias, qseg, kseg, q_bounds, k_bounds)
    if on_cpu(q, k, v, key_bias, qseg, kseg, q_bounds, k_bounds):
        return flash_attention_varlen_fwd_plain(q, k, v, key_bias, qseg, kseg)
    H, rep, T, D = q.shape
    L = k.shape[1]
    check_cuda_inputs("varlen_fwd", data=(q, k, v), f32=(key_bias,),
                      i32=(qseg, kseg, k_bounds), head_dim=D)
    table = _row_plan("varlen_fwd", q, k, offsets)
    o = torch.empty_like(q)
    lse = torch.empty((H, rep, T), dtype=torch.float32, device=q.device)
    _build.launch("varlen_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  key_bias.data_ptr(), qseg.data_ptr(), kseg.data_ptr(),
                  k_bounds.data_ptr(), None if table is None else table.data_ptr(),
                  o.data_ptr(), lse.data_ptr(), H, rep, T, L,
                  0 if table is None else table.shape[0], D, int(q.dtype == torch.bfloat16),
                  torch.cuda.current_stream(q.device).cuda_stream)
    COUNT.hit()
    return o, lse


def flash_attention_varlen_bwd_plain(q, k, v, key_bias, qseg, kseg, do, lse, delta, *,
                                     chunk: int = PLAIN_CHUNK):
    """Plain PyTorch version of the two backward kernels, in query chunks:
    p recomputed from lse, dV = pᵀdO, dP = dO·Vᵀ, dS = p(dP − δ)·scale,
    dQ = dS·K, dK = dSᵀQ, dK/dV summed over the group's rep query heads; p
    and dS rounded to the operand dtype before their products.  Returns
    (dq, dk, dv)."""
    H, rep, T, D = q.shape
    scale = D ** -0.5
    adt = q.dtype
    kf, vf = k.float()[:, None], v.float()[:, None]           # (H, 1, L, D)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for s in range(0, T, chunk):
        rows = slice(s, min(s + chunk, T))
        qf, dof = q[:, :, rows].float(), do[:, :, rows].float()
        logits = (torch.matmul(qf, kf.transpose(-1, -2)) * scale
                  + _chunk_bias(key_bias, qseg, kseg, rows))
        p = p_from_lse(logits, lse[:, :, rows, None])          # (H, rep, c, L)
        dv += torch.einsum("hrnl,hrnd->hld", p.to(adt).float(), dof)
        dp = torch.matmul(dof, vf.transpose(-1, -2))
        ds = (p * (dp - delta[:, :, rows, None]) * scale).to(adt).float()
        dq[:, :, rows] = torch.matmul(ds, kf)
        dk += torch.einsum("hrnl,hrnd->hld", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_check(name, q, k, v, key_bias, qseg, kseg, q_bounds, k_bounds, do, lse, delta):
    H, rep, T, D = q.shape
    if do.shape != q.shape or lse.shape != (H, rep, T) or delta.shape != lse.shape:
        raise ValueError(f"{name}: dO must be {tuple(q.shape)} and lse / delta "
                         f"{(H, rep, T)}")
    check_cuda_inputs(name, data=(q, k, v, do), f32=(key_bias, lse, delta),
                      i32=(qseg, kseg, q_bounds, k_bounds), head_dim=D)
    return [t.data_ptr() for t in (q, k, v, key_bias, qseg, kseg, q_bounds, k_bounds, do,
                                   lse, delta)]


def flash_attention_varlen_dq(q, k, v, key_bias, qseg, kseg, q_bounds, k_bounds, do,
                              lse, delta, *, offsets=None):
    """dq from the forward's lse and δ = rowsum(dO·O): the ``varlen_dq``
    kernel on CUDA tensors, the plain version on CPU tensors.  ``offsets``
    as :func:`flash_attention_varlen_fwd` takes them (the same row plan)."""
    args = (q, k, v, key_bias, qseg, kseg, q_bounds, k_bounds)
    _check_shapes("varlen_dq", *args)
    if on_cpu(*args, do, lse, delta):
        return flash_attention_varlen_bwd_plain(q, k, v, key_bias, qseg, kseg, do,
                                                lse, delta)[0]
    ptrs = _bwd_check("varlen_dq", *args, do, lse, delta)
    H, rep, T, D = q.shape
    table = _row_plan("varlen_dq", q, k, offsets)
    dq = torch.empty_like(q)
    _build.launch("varlen_dq", *ptrs, None if table is None else table.data_ptr(),
                  dq.data_ptr(), H, rep, T, k.shape[1], 0 if table is None else table.shape[0],
                  D, int(q.dtype == torch.bfloat16),
                  torch.cuda.current_stream(q.device).cuda_stream)
    COUNT_DQ.hit()
    return dq


def flash_attention_varlen_dkv(q, k, v, key_bias, qseg, kseg, q_bounds, k_bounds, do,
                               lse, delta, *, offsets=None):
    """(dk, dv) from the forward's lse and δ: the ``varlen_dkv`` kernel on
    CUDA tensors, the plain version on CPU tensors.  ``offsets``: the host
    (q_offsets, k_offsets) the maps were built from; the fma path (fp32)
    plans its walk from them (:func:`varlen_dkv_tiles`, splits for the
    card's SM count) and raises without them."""
    args = (q, k, v, key_bias, qseg, kseg, q_bounds, k_bounds)
    _check_shapes("varlen_dkv", *args)
    if on_cpu(*args, do, lse, delta):
        return flash_attention_varlen_bwd_plain(q, k, v, key_bias, qseg, kseg, do,
                                                lse, delta)[1:]
    ptrs = _bwd_check("varlen_dkv", *args, do, lse, delta)
    H, rep, T, D = q.shape
    L = k.shape[1]
    plan = varlen_plan(D, q.dtype)
    table, ws, S = None, None, 0
    if plan.path == "fma":
        if offsets is None:
            raise ValueError("varlen_dkv: the fp32 path plans its walk from the host "
                             "offsets; pass offsets=(q_offsets, k_offsets)")
        tiles = varlen_dkv_tiles(*offsets, T, L, q.device, keys=plan.keys,
                                 rows=plan.row_tile, heads=H,
                                 sms=torch.cuda.get_device_properties(
                                     q.device).multi_processor_count)
        table, S = tiles.table, tiles.splits
        if S > 1:
            ws = torch.empty((2, S, H, L, D), dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _build.launch("varlen_dkv", *ptrs, None if table is None else table.data_ptr(),
                  None if ws is None else ws.data_ptr(), dk.data_ptr(), dv.data_ptr(), H,
                  rep, T, L, 0 if table is None else table.shape[0], S, D,
                  int(q.dtype == torch.bfloat16),
                  torch.cuda.current_stream(q.device).cuda_stream)
    COUNT_DKV.hit()
    return dk, dv


def flash_attention_varlen_bwd(q, k, v, key_bias, qseg, kseg, q_bounds, k_bounds, do,
                               lse, delta, *, offsets=None):
    """(dq, dk, dv): the two backward kernels on CUDA tensors (``offsets``
    as they take them), the plain version on CPU tensors."""
    args = (q, k, v, key_bias, qseg, kseg, q_bounds, k_bounds, do, lse, delta)
    if on_cpu(*args):
        return flash_attention_varlen_bwd_plain(q, k, v, key_bias, qseg, kseg, do,
                                                lse, delta)
    return (flash_attention_varlen_dq(*args, offsets=offsets),
            *flash_attention_varlen_dkv(*args, offsets=offsets))


class VarlenAttentionFn(torch.autograd.Function):
    """Differentiable packed-varlen attention in q, k, v (the key bias,
    segment ids and boundaries take no gradient; ``offsets``, the host
    (q_offsets, k_offsets), go to the kernels' plans)."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, qseg, kseg, q_bounds, k_bounds, offsets=None):
        o, lse = flash_attention_varlen_fwd(q, k, v, key_bias, qseg, kseg,
                                            q_bounds, k_bounds, offsets=offsets)
        ctx.save_for_backward(q, k, v, key_bias, qseg, kseg, q_bounds, k_bounds, o, lse)
        ctx.offsets = offsets
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, key_bias, qseg, kseg, q_bounds, k_bounds, o, lse = ctx.saved_tensors
        do = do.contiguous()
        dq, dk, dv = flash_attention_varlen_bwd(q, k, v, key_bias, qseg, kseg, q_bounds,
                                                k_bounds, do, lse, row_delta(do, o),
                                                offsets=ctx.offsets)
        return dq, dk, dv, None, None, None, None, None, None
