"""Ball-Tree Attention kernels (block-diagonal fused attention), forward and
backward.

Replaces ``repro/kernels/bta.py::_fwd_kernel`` and ``::_bwd_kernel``
(Pallas, TPU).  The CUDA sources are ``csrc/bta_fwd.cu`` (``bta_fwd_mma``,
``bta_fwd_fma``, ``bta_fwd_rows``) and ``csrc/bta_bwd.cu``
(``bta_bwd_mma``, ``bta_bwd_fma``, ``bta_bwd_rows``).

What bounds them on the H100: the forward does 4·m·D FLOP per query row
and the backward 10·m·D (five products) against a few D-wide rows of
bytes, so the products bound both: the bf16 tensor cores in bf16, the fp32
FMA rate at the paper's shapes (ball m = 256, D = 32, fp32).  One rule
picks the path of both (:func:`bta_plan`, a pure function of the ball
size, head dim, rep and dtype; a CUDA tensor never goes to the plain
version):

- ``mma`` for bf16 with D 16–128 and a ball that is a multiple of 64 keys
  (seamless's encoder, 256 × 64; no upper limit on the ball, since every
  block streams 64-key tiles): the tensor cores (``mma.sync`` m16n8k16,
  bf16 operands, fp32 sums), tiles staged in bf16 by ``cp.async`` and
  double-buffered.  The forward gives a block 64 of a ball's rep·m rows
  and walks the ball's 64-key tiles with ``flash_fwd_mma``'s step
  (``csrc/mma_fwd.cuh``).  The backward is one launch with two block
  roles: a dK/dV block owns 64 of the ball's keys and walks the ball's
  rep·m query rows in staged tiles (the GQA sum in its registers); a dQ
  block owns 64 rows and walks the ball's key tiles.  Both recompute S and
  dP (seven products instead of five): no staging buffer, no atomics, a
  fixed order of sums (:func:`bwd_walk`).
- ``fma`` for fp32 with D 16 or 32 and a ball that is a multiple of 64 keys
  up to 256 (shapenet): register tiles on the FMA pipes, tiles staged by
  ``cp.async``.  The forward gives a block 64 of a ball's rep·m rows and
  walks the ball's 32-key tiles with ``flash_fwd_fma``'s tile step
  (``csrc/fma_fwd.cuh``); the backward gives a block one ball, as on the TPU
  (the ball is the tile, so a ball's dQ, dK, dV depend on that ball alone):
  it stages the ball's K and V once, keeps the ball's dK and dV in
  registers, and walks the rep·m query rows in 32-row tiles, each computing
  Sᵀ and dPᵀ, P and dS, dV += PᵀdO, dK += dSᵀQ and its dQ = dS·K — five
  products, none recomputed, no atomics (:func:`bwd_walk`).
- ``rows`` for the rest (fp32 at D 64, the balls that are no multiple of
  64: the tests' 16, the smoke config's 32): one thread a query row over
  the ball's keys staged whole as fp32, and a backward that runs each
  query row for dQ and then each key for dK and dV (summing the GQA
  group's rep heads in that loop).

A ball with no valid key skips everything and writes zeros (lse =
``LSE_EMPTY`` forward, zero gradients backward).

Layout (GQA-native, as the TPU kernel): q (B·Hkv, rep, N, D); k, v
(B·Hkv, N, D); key_bias (B, N) fp32 additive (0 / NEG_INF).  The forward
returns o like q and lse (B·Hkv, rep, N) fp32.  :class:`BallAttentionFn` is
the differentiable op, as ``jax.custom_vjp`` wraps the Pallas pair.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch.core.branches import sdpa
from repro_torch.kernels import _build
from repro_torch.kernels.common import (BF16_HEAD_DIMS, HEAD_DIMS, _counter,
                                        check_cuda_inputs, on_cpu, p_from_lse, row_delta)
from repro_torch.kernels.occupancy import key_tile_live

__all__ = ["ball_attention_fwd", "ball_attention_fwd_plain", "ball_attention_bwd",
           "ball_attention_bwd_plain", "bta_plan", "BtaPlan", "fwd_walk", "bwd_walk",
           "BallAttentionFn", "COUNT", "COUNT_BWD"]

COUNT = _counter("bta_fwd")
COUNT_BWD = _counter("bta_bwd")


class BtaPlan(NamedTuple):
    """How ``bta_fwd`` / ``bta_bwd`` take one shape: ``path`` ``"mma"``
    (tensor cores: ``bta_fwd_mma``, ``bta_bwd_mma``), ``"fma"`` (register
    tiles: ``bta_fwd_fma``, ``bta_bwd_fma``) or ``"rows"`` (one thread a row
    or key: ``bta_fwd_rows``, ``bta_bwd_rows``); ``rows``: query rows a
    forward block (mma: also a dQ block's; rows: up to 256, one a thread);
    ``key_tile``: keys a staged tile of the forward (mma: also of a dQ
    block, and the keys a dK/dV block owns; rows: the ball); ``row_tile``:
    query rows a staged tile of the backward (mma: of a dK/dV block; rows:
    one rep head's m)."""
    path: str
    rows: int
    key_tile: int
    row_tile: int


PATH_CODES = {"rows": 0, "fma": 1, "mma": 2}   # the C entry points' last int
TILE = 64                   # the mma and fma paths take balls that are multiples of 64
FMA_MAX_BALL = 256          # the fma path's largest: the keys a bta_bwd_fma block holds
FMA_DIMS = (16, 32)         # D 64 would hold 128 floats of dK, dV a thread


def bta_plan(m: int, D: int, rep: int, dtype: torch.dtype) -> BtaPlan:
    """The path and tiles of the ball kernels for balls of m keys at head
    dim D with rep query heads a KV head (the constants of
    ``csrc/bta_fwd.cu``'s ``FwdMma`` / ``FwdFma`` and ``csrc/bta_bwd.cu``'s
    ``BwdMma`` / ``BwdFma``).  bf16 with m a multiple of 64 takes the mma
    path: 64 rows a forward or dQ block against 64-key tiles, dK/dV blocks of
    64 keys walking row tiles of 64 (32 at D 128).  fp32 with D 16 or 32 and
    m a multiple of 64 up to 256 (shapenet's 256 × 32) takes the fma path:
    64 rows a forward block against 32-key tiles, a backward block a ball
    walking 32-row tiles.  The rest (fp32 at D 64, balls that are no
    multiple of 64) takes the rows path.  A shape no path takes raises:
    D 128 is bf16's alone."""
    dims = (BF16_HEAD_DIMS if dtype == torch.bfloat16 else HEAD_DIMS)["bta_fwd"]
    if dtype not in (torch.float32, torch.bfloat16) or D not in dims or m < 1 or rep < 1:
        raise ValueError(f"bta: no path takes ball {m}, D {D}, rep {rep}, {dtype} "
                         f"(ball ≥ 1; rep ≥ 1; D in {HEAD_DIMS['bta_fwd']}, or "
                         f"{BF16_HEAD_DIMS['bta_fwd']} in bfloat16; float32 or bfloat16)")
    if dtype == torch.bfloat16 and m % TILE == 0:
        return BtaPlan("mma", TILE, TILE, 32 if D > 64 else TILE)
    if D > 64:
        raise ValueError(f"bta: no path takes ball {m}, D {D}, rep {rep}, {dtype} "
                         f"(D 128 runs on the mma path alone: bf16, ball a "
                         f"multiple of {TILE})")
    if dtype == torch.float32 and D in FMA_DIMS and m % TILE == 0 and m <= FMA_MAX_BALL:
        return BtaPlan("fma", 64, 32, 32)
    return BtaPlan("rows", min(256, -(-rep * m // 32) * 32), m, m)


def fwd_walk(m: int, D: int, rep: int, dtype: torch.dtype
             ) -> list[tuple[int, int, list[tuple[int, int]]]]:
    """The tiled forward's blocks of one live ball (``csrc/bta_fwd.cu``:
    ``bta_fwd_mma``, ``bta_fwd_fma``): for each block of the ball's rep·m
    rows [t0, t1) (row r·m + i is query head r's position i of the ball),
    the key tiles [j0, j1) it stages, in order."""
    plan = bta_plan(m, D, rep, dtype)
    if plan.path == "rows":
        raise ValueError(f"fwd_walk: ball {m}, D {D}, {dtype} takes the rows path")
    keys = [(j, j + plan.key_tile) for j in range(0, m, plan.key_tile)]
    return [(t0, t0 + plan.rows, keys) for t0 in range(0, rep * m, plan.rows)]


BWD_KEY_WARP = 32           # keys of S^T, dP^T a warp computes (BwdFma's key warps)


def bwd_walk(m: int, D: int, rep: int, dtype: torch.dtype, role: str = "dkv"
             ) -> list[tuple[int, int, list[tuple[int, int]]]]:
    """The tiled backward's walk of one live ball (``csrc/bta_bwd.cu``).

    fma (``bta_bwd_fma``, one block a ball): for each staged tile of the
    ball's rep·m rows [t0, t1) (one query head's, since the tile divides
    m), the key ranges [j0, j1) whose Sᵀ and dPᵀ the block's key warps
    compute against it (each pair's P and dS then feed dV, dK and the
    tile's dQ); ``role`` is ignored.

    mma (``bta_bwd_mma``, two block roles in one grid), as the same
    (rows, key ranges) triples: ``role="dkv"``, for each dK/dV block's 64
    keys, the staged row tiles it walks, in order, each with that block's
    key range; ``role="dq"``, for each dQ block's 64 rows, the key tiles
    it walks, in order."""
    plan = bta_plan(m, D, rep, dtype)
    if plan.path == "rows":
        raise ValueError(f"bwd_walk: ball {m}, D {D}, {dtype} takes the rows path")
    if plan.path == "fma":
        keys = [(j, j + BWD_KEY_WARP) for j in range(0, m, BWD_KEY_WARP)]
        return [(t0, t0 + plan.row_tile, keys) for t0 in range(0, rep * m, plan.row_tile)]
    if role == "dq":
        return fwd_walk(m, D, rep, dtype)
    if role != "dkv":
        raise ValueError(f"bwd_walk: role {role!r} (dkv or dq)")
    return [(t0, t0 + plan.row_tile, [(j0, j0 + plan.key_tile)])
            for j0 in range(0, m, plan.key_tile)
            for t0 in range(0, rep * m, plan.row_tile)]


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
    """(o, lse) of ball attention: the CUDA kernel on CUDA tensors (on the
    path :func:`bta_plan` picks; one launch), the plain version on CPU
    tensors.  ``live``: the (B, N/m) int32 ball liveness of ``key_bias``
    when the caller already has it."""
    BH, rep, N, D = q.shape
    _check_shapes("bta_fwd", q, k, v, key_bias, ball_size, n_heads)
    if on_cpu(q, k, v, key_bias):
        return ball_attention_fwd_plain(q, k, v, key_bias, ball_size=ball_size,
                                        n_heads=n_heads)
    live = _live(key_bias, ball_size) if live is None else live
    check_cuda_inputs("bta_fwd", data=(q, k, v), f32=(key_bias,), i32=(live,),
                      head_dim=D)
    plan = bta_plan(ball_size, D, rep, q.dtype)
    o = torch.empty_like(q)
    lse = torch.empty((BH, rep, N), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.launch("bta_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  key_bias.data_ptr(), live.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), BH, rep, N, D, ball_size, n_heads,
                  int(q.dtype == torch.bfloat16), PATH_CODES[plan.path], stream)
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
    δ = rowsum(dO·O): the CUDA kernel on CUDA tensors (on the path
    :func:`bta_plan` picks; one launch), the plain version on CPU tensors."""
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
    plan = bta_plan(ball_size, D, rep, q.dtype)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.launch("bta_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  key_bias.data_ptr(), live.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), BH, rep, N, D, ball_size, n_heads,
                  int(q.dtype == torch.bfloat16), PATH_CODES[plan.path], stream)
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
