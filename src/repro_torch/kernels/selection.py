"""Group-selected sparse attention kernels (the NSA/BSA hot path), forward
and backward.

Replaces ``repro/kernels/selection.py::_fwd_kernel`` and ``::_bwd_kernel``
with its jnp scatter ``_scatter_blocks`` (Pallas, TPU).  The CUDA sources
are ``csrc/selection_fwd.cu`` and ``csrc/selection_bwd.cu``.

What bounds them on the H100: each query group of M = g·rep rows gathers
its k* selected blocks of ℓ keys and values for 4·M·k*·ℓ·D FLOP forward
and 10·M·k*·ℓ·D backward.  At the paper's shapes (M = 8, ℓ = 8, fp32)
memory traffic bounds them; at the LM's (M = 512, ℓ = 64, bf16) a group
does 64 FLOP a byte of K/V, so the selected blocks must stay on chip and
the products run on the tensor cores.  The TPU scalar-prefetched the
indices to drive its block fetches; here a block loads its own group's
indices and gathers the selected blocks itself.

Three paths, one rule (:func:`selection_plan`, a pure function of M, ℓ, D,
the dtype and, for the forward, k*; the wrappers follow it, a CUDA tensor
never goes to the plain version):

- ``groups``, the forward only, for fp32 groups of M < 16 rows at D ≤ 64
  whose k*·ℓ keys fit one stage of 32 (shapenet: 8 rows against 4 blocks of
  8 keys): a block of one warp owns one group; it stages the group's
  valid selections, their K and V rows and token bias and Q (``cp.async``,
  16 bytes a copy; 9.6 KB a group at D 32, so some 21 groups an SM are in
  flight) and scores all of the group's keys in one pass (one max and one
  sum a row, no rescale), S and P V register-tiled, P through shared
  memory.
- ``warp`` for the other M < 16 shapes (the forward in bf16, at D 128 or
  with more keys; the backward at every M < 16): one warp owns one
  (batch, KV head, group), 8 rows × 4 lanes, D/4 dims a lane, shuffles sum
  a row's dot products.  Its backward (``selection_bwd``) accumulates dQ in registers
  and stores each selection's dK, dV (summed over the group's rows by a
  shuffle reduce-scatter), fp32 and coalesced, into a staging buffer
  (2, B·Hkv·G·k*, ℓ, D) at the selection's slot; a first pass gives the
  slots (a stable counting sort of each head's selections by block, one
  warp a head: :func:`scatter_ranks` is its plain version) and a last pass
  sums each block's slots in that order and casts, all behind the one
  entry point: no atomics, bit-reproducible.  The buffer is 252 MB at
  shapenet's train shape (B 8 × Hkv 8 × G 480 × k* 4 = 122,880 slots of
  8 × 32 fp32, for dK and dV; packed, B 1 × G 3,840, the same count).
- ``tiles`` for M ≥ 16: a block owns 64 rows of one group and walks the
  group's valid selections in staged chunks of keys (``cp.async``,
  double-buffered); bf16 on the tensor cores (``mma.sync`` m16n8k16, fp32
  accumulation, exponentials on the MUFU unit: ``__expf``), fp32 on the FMA
  pipes in register micro-tiles (the exact ``expf``).  The
  backward is the TPU's own split, no atomics: ``selection_dq`` on the
  forward's grid, and ``selection_dkv`` with one block per (valid
  selection, chunk of keys) that streams the group's rows and writes its
  dK, dV tile (fp32) into a staging buffer (2, B·Hkv·G·k*, ℓ, D), in the
  order of an inverse index of ``idx`` (:func:`scatter_plan`); a second
  pass behind the same entry point sums each block's tiles in that order
  (deterministic) and casts.  The staging buffer is 268 MB at the LM's
  train shape (B 2 × 4,096 tokens).

Invalid selections (−1, or ≥ NB) cost nothing; a group with no valid
selection writes zeros (and lse = ``LSE_EMPTY``); p and dS are rounded to
the operand dtype before their products.

Layout: q (B, Hkv, G, M, D); kb, vb (B, Hkv, NB, ℓ, D); idx (B, Hkv, G, k*)
int32 (−1 = invalid); tok_bias (B, NB, ℓ) fp32.  The forward returns o like
q and lse (B, Hkv, G, M) fp32.  :class:`SelectionAttentionFn` is the
differentiable op (in q, kb, vb).
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

__all__ = ["selection_attention_fwd", "selection_attention_fwd_plain",
           "selection_attention_bwd", "selection_attention_bwd_plain",
           "selection_attention_dq", "selection_attention_dkv", "selection_plan",
           "SelectionPlan", "scatter_plan", "scatter_ranks", "reduce_staged_plain",
           "SelectionAttentionFn",
           "COUNT", "COUNT_BWD", "COUNT_DQ", "COUNT_DKV"]

COUNT = _counter("selection_fwd")
COUNT_BWD = _counter("selection_bwd")           # the warp path's backward
COUNT_DQ = _counter("selection_dq")             # the tiled path's backward: dQ
COUNT_DKV = _counter("selection_dkv")           # and dK, dV


class SelectionPlan(NamedTuple):
    """How the CUDA kernels take one shape: ``path`` ``"groups"``,
    ``"warp"`` or ``"tiles"``; ``rows``: query rows a block (forward,
    ``selection_dq``) or a pass of the warp; ``keys``: keys a staged chunk
    (``groups``: the keys one stage holds); ``dkv_rows``: rows a staged tile
    of ``selection_dkv`` (0 on the other paths)."""
    path: str
    rows: int
    keys: int
    dkv_rows: int


TILE_MIN_ROWS = 16          # one m16n8k16 tile of rows
GROUPS_KEYS = 32            # keys of one group's stage (FwdGroups::KEYS)
GROUPS_DIMS = (16, 32, 64)  # the groups kernel's instantiations


def selection_plan(M: int, ell: int, D: int, dtype: torch.dtype,
                   k_star: int | None = None) -> SelectionPlan:
    """The path and tiles of the selection kernels for groups of M rows
    against blocks of ℓ keys at head dim D (the constants of
    ``csrc/selection_{fwd,bwd}.cu``).  M < 16 takes the warp path (one warp
    a group, 8 rows a pass, keys in chunks of 8); M ≥ 16 the tiled path
    (blocks of 64 rows; chunks of 64 keys in bf16, 32 in fp32;
    ``selection_dkv`` stages 64 rows, 32 at D 128).  ``k_star``, the
    forward's picks a group: given, an fp32 group of M < 16 rows at D ≤ 64
    whose k*·ℓ keys fit one stage of 32 takes the forward's ``groups`` path
    (8 rows a pass, all of its keys in one stage); the backward passes no
    k*.  A shape no path takes raises, naming the kernel and the shape."""
    if (dtype not in (torch.float32, torch.bfloat16) or D not in HEAD_DIMS["selection_fwd"]
            or M < 1 or ell < 1):
        raise ValueError(f"selection kernels: no path takes M {M}, ℓ {ell}, D {D}, {dtype} "
                         f"(M, ℓ ≥ 1; D in {HEAD_DIMS['selection_fwd']}; float32 or "
                         "bfloat16)")
    if M < TILE_MIN_ROWS:
        if (k_star and dtype == torch.float32 and D in GROUPS_DIMS
                and k_star * ell <= GROUPS_KEYS):
            return SelectionPlan("groups", 8, GROUPS_KEYS, 0)
        return SelectionPlan("warp", 8, 8, 0)
    return SelectionPlan("tiles", 64, 64 if dtype == torch.bfloat16 else 32,
                         32 if D > 64 else 64)


def scatter_plan(idx: torch.Tensor, NB: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The inverse index of ``idx`` (B, Hkv, G, k*) that ``selection_dkv``
    runs in: ``order`` (B·Hkv·G·k*,) int32, the flat (b, h, g, j) positions
    of the valid selections (0 ≤ idx < NB) sorted by block b·Hkv·NB + h·NB +
    idx, stably (a block's selections in (g, j) order), the invalid ones
    last; ``offsets`` (B·Hkv·NB + 1,) int32, block i's selections at
    ``order[offsets[i]:offsets[i+1]]``, ``offsets[-1]`` the valid count."""
    B, Hkv, G, k_star = idx.shape
    n_blocks = B * Hkv * NB
    head = torch.arange(B * Hkv, device=idx.device).reshape(B, Hkv, 1, 1) * NB
    valid = (idx >= 0) & (idx < NB)
    key = torch.where(valid, head + idx.long(), n_blocks).reshape(-1)
    sorted_key, order = torch.sort(key, stable=True)
    # no host sync (bincount would read the keys' range back first)
    offsets = torch.searchsorted(sorted_key, torch.arange(n_blocks + 1, device=idx.device))
    return order.to(torch.int32), offsets.to(torch.int32)


def scatter_ranks(idx: torch.Tensor, NB: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the warp path's first pass (``selection_bwd_ranks``
    in ``csrc/selection_bwd.cu``): where ``selection_bwd`` stages each
    selection.  ``rank`` (B·Hkv·G·k*,) int32: a valid selection (b, h, g, j)
    goes to slot ``rank[flat position]``, an invalid one gets −1 and is
    never staged; ``offsets`` (B·Hkv, NB + 1) int32: block blk of head bh
    owns slots ``[offsets[bh, blk], offsets[bh, blk + 1])``.  Each head's
    selections are sorted by block, stably ((g, j) order within a block, as
    :func:`scatter_plan`), and a head's slots start at its first
    selection's flat position bh·G·k*."""
    B, Hkv, G, k_star = idx.shape
    n = G * k_star
    flat = idx.reshape(B * Hkv, n)
    valid = (flat >= 0) & (flat < NB)
    sorted_key, order = torch.sort(torch.where(valid, flat.long(), NB), dim=1, stable=True)
    base = torch.arange(B * Hkv, device=idx.device)[:, None] * n
    rank = torch.empty_like(order)
    rank.scatter_(1, order, base + torch.arange(n, device=idx.device))
    offsets = base + torch.searchsorted(
        sorted_key, torch.arange(NB + 1, device=idx.device).repeat(B * Hkv, 1))
    return (torch.where(valid, rank, -1).reshape(-1).to(torch.int32),
            offsets.to(torch.int32))


def reduce_staged_plain(staged: torch.Tensor, offsets: torch.Tensor,
                        shape: tuple[int, ...]) -> torch.Tensor:
    """Plain version of the second pass of ``selection_dkv`` and of the warp
    path's ``selection_bwd``: block i of the (B, Hkv, NB, ℓ, D) result is
    the sum of its staged tiles (``staged`` (slots, ℓ, D) fp32), zeros
    where a block has none.  ``offsets`` (n_blocks + 1,) as
    :func:`scatter_plan` gives them (block i's tiles at
    ``[offsets[i], offsets[i+1])``), or (B·Hkv, NB + 1) as
    :func:`scatter_ranks` gives them (a head's row of ranges)."""
    if offsets.dim() == 2:
        lo, hi = offsets[:, :-1].reshape(-1), offsets[:, 1:].reshape(-1)
    else:
        lo, hi = offsets[:-1], offsets[1:]
    counts = (hi - lo).long()
    n_blocks = counts.numel()
    target = torch.repeat_interleave(torch.arange(n_blocks, device=staged.device), counts)
    starts = torch.repeat_interleave(lo.long() - (torch.cumsum(counts, 0) - counts), counts)
    src = starts + torch.arange(target.numel(), device=staged.device)
    out = torch.zeros((n_blocks,) + tuple(staged.shape[1:]), dtype=torch.float32,
                      device=staged.device)
    out.index_add_(0, target, staged[src].float())
    return out.reshape(shape)


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


PATH_CODES = {"warp": 0, "tiles": 1, "groups": 2}       # selection_fwd's `path`


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
    plan = selection_plan(M, ell, D, q.dtype, idx.shape[-1])
    o = torch.empty_like(q)
    lse = torch.empty((B, Hkv, G, M), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.launch("selection_fwd", q.data_ptr(), kb.data_ptr(), vb.data_ptr(),
                  idx.data_ptr(), tok_bias.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), B, Hkv, G, M, NB, ell, idx.shape[-1], D,
                  int(q.dtype == torch.bfloat16), PATH_CODES[plan.path], stream)
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


def _bwd_check(name, q, kb, vb, idx, tok_bias, do, lse, delta):
    B, Hkv, G, M, D = q.shape
    _check_shapes(name, q, kb, vb, idx, tok_bias)
    if do.shape != q.shape or lse.shape != (B, Hkv, G, M) or delta.shape != lse.shape:
        raise ValueError(f"{name}: dO must be {tuple(q.shape)} and lse / "
                         f"delta {(B, Hkv, G, M)}")
    if on_cpu(q, kb, vb, idx, tok_bias, do, lse, delta):
        return None
    check_cuda_inputs(name, data=(q, kb, vb, do), f32=(tok_bias, lse, delta), i32=(idx,),
                      head_dim=D)
    plan = selection_plan(M, kb.shape[3], D, q.dtype)
    if name != "selection_bwd" and plan.path != "tiles":
        raise ValueError(f"{name}: groups of {M} rows take the warp path "
                         "(selection_bwd), not the tiled backward")
    ptrs = (q.data_ptr(), kb.data_ptr(), vb.data_ptr(), idx.data_ptr(),
            tok_bias.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr())
    shape = (B, Hkv, G, M, kb.shape[2], kb.shape[3], idx.shape[-1], D,
             int(q.dtype == torch.bfloat16))
    return plan, ptrs, shape, torch.cuda.current_stream(q.device).cuda_stream


def selection_attention_dq(q, kb, vb, idx, tok_bias, do, lse, delta):
    """dq of the tiled path: the ``selection_dq`` kernel on CUDA tensors (M
    ≥ 16 rows a group), the plain version on CPU tensors."""
    launch = _bwd_check("selection_dq", q, kb, vb, idx, tok_bias, do, lse, delta)
    if launch is None:
        return selection_attention_bwd_plain(q, kb, vb, idx, tok_bias, do, lse, delta)[0]
    _, ptrs, shape, stream = launch
    dq = torch.empty_like(q)
    _build.launch("selection_dq", *ptrs, dq.data_ptr(), *shape, stream)
    COUNT_DQ.hit()
    return dq


def selection_attention_dkv(q, kb, vb, idx, tok_bias, do, lse, delta):
    """(dkb, dvb) of the tiled path: the ``selection_dkv`` kernel on CUDA
    tensors (per-selection tiles staged in :func:`scatter_plan` order, then
    each block's summed in that order), the plain version on CPU tensors."""
    launch = _bwd_check("selection_dkv", q, kb, vb, idx, tok_bias, do, lse, delta)
    if launch is None:
        return selection_attention_bwd_plain(q, kb, vb, idx, tok_bias, do, lse, delta)[1:]
    _, ptrs, shape, stream = launch
    B, Hkv, G, _, NB, ell, k_star, D, _ = shape
    order, offsets = scatter_plan(idx, NB)
    ws = torch.empty((2, B * Hkv * G * k_star, ell, D), dtype=torch.float32,
                     device=q.device)
    dkb, dvb = torch.empty_like(kb), torch.empty_like(vb)
    _build.launch("selection_dkv", *ptrs, order.data_ptr(), offsets.data_ptr(),
                  ws.data_ptr(), dkb.data_ptr(), dvb.data_ptr(), *shape, stream)
    COUNT_DKV.hit()
    return dkb, dvb


def selection_attention_bwd(q, kb, vb, idx, tok_bias, do, lse, delta):
    """(dq, dkb, dvb) from the forward's lse and δ = rowsum(dO·O): on CUDA
    tensors the warp path's ``selection_bwd`` kernel or the tiled path's
    ``selection_dq`` and ``selection_dkv`` (:func:`selection_plan`), the
    plain version on CPU tensors."""
    launch = _bwd_check("selection_bwd", q, kb, vb, idx, tok_bias, do, lse, delta)
    if launch is None:
        return selection_attention_bwd_plain(q, kb, vb, idx, tok_bias, do, lse, delta)
    plan, ptrs, shape, stream = launch
    if plan.path == "tiles":
        return (selection_attention_dq(q, kb, vb, idx, tok_bias, do, lse, delta),
                *selection_attention_dkv(q, kb, vb, idx, tok_bias, do, lse, delta))
    B, Hkv, G, _, NB, ell, k_star, D, _ = shape
    n_slots = B * Hkv * G * k_star
    # the kernel's first pass fills rank and offsets (scatter_ranks' layout)
    rank = torch.empty((n_slots,), dtype=torch.int32, device=q.device)
    offsets = torch.empty((B * Hkv, NB + 1), dtype=torch.int32, device=q.device)
    ws = torch.empty((2, n_slots, ell, D), dtype=torch.float32, device=q.device)
    dq, dkb, dvb = torch.empty_like(q), torch.empty_like(kb), torch.empty_like(vb)
    _build.launch("selection_bwd", *ptrs, rank.data_ptr(), offsets.data_ptr(), ws.data_ptr(),
                  dq.data_ptr(), dkb.data_ptr(), dvb.data_ptr(), *shape, stream)
    COUNT_BWD.hit()
    return dq, dkb, dvb


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
