"""Collectives of the sharded ops, and their differentiable forms.

Every rank runs the replicated glue and calls a sharded op on the full
tensors; the op takes its shard, computes, and gathers the output.  JAX's
``shard_map`` transposes its collectives by itself; here four
``torch.autograd.Function``s carry the gradients:

  * :func:`shard`: forward takes this rank's slice along ``dim``, backward
    all-gathers the gradient slices;
  * :func:`gather`: forward all-gathers the slices, backward takes this
    rank's slice of the gradient;
  * :func:`replicated`: an input every rank uses whole (the compression
    branch's pooled K/V): forward the identity, backward sums the
    gradient over the ranks;
  * :func:`rotate`: forward sends to the next rank on the ring and
    receives from the previous one, backward rotates the gradient back.

Sums over ranks all-gather and add in rank order (:func:`all_reduce_sum`),
so every rank holds the same bits and two calls give equal bits, whatever
reduction order the transport would pick.  Each multi-tensor function is
one autograd node: its collectives run in one fixed order on every rank,
and a rank on which one of its outputs got no gradient still takes part
(the gradient counts as zero).

Transport: a rotation is ``all_to_all_single`` with empty splits, which
NCCL (one card a rank, the intended deployment) and gloo (CPU ranks, or
ranks that share one card, staged through the host) both take for CUDA
tensors; gathers are ``all_gather``.  Nothing here moves a tensor to
another device on its own.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_gather", "all_reduce_sum", "all_reduce_max", "rotate_plain", "shard",
           "local_slice", "gather", "replicated", "rotate", "touch"]

# dtypes moved as another of the same width (every collective here only
# moves bits, the sums are taken locally in rank order): gloo takes neither
# bool nor bfloat16 (nor int16) for every collective
_AS_BITS = {torch.bool: torch.uint8, torch.bfloat16: torch.float16}


def all_gather(x: torch.Tensor, ax) -> list[torch.Tensor]:
    """Every rank's ``x`` (same shape on each), in rank order."""
    dtype = x.dtype
    x = x.contiguous().view(_AS_BITS.get(dtype, dtype))   # a gather moves bits only
    parts = [torch.empty_like(x) for _ in range(ax.size)]
    dist.all_gather(parts, x, group=ax.group)
    return [t.view(dtype) for t in parts]


def all_reduce_sum(x: torch.Tensor, ax) -> torch.Tensor:
    """Σ over the ranks, added in rank order: the same bits on every rank."""
    parts = all_gather(x, ax)
    out = parts[0]
    for t in parts[1:]:
        out = out + t
    return out


def all_reduce_max(x: torch.Tensor, ax) -> torch.Tensor:
    parts = all_gather(x, ax)
    out = parts[0]
    for t in parts[1:]:
        out = torch.maximum(out, t)
    return out


def rotate_plain(x: torch.Tensor, ax, *, wrap: bool = True, back: bool = False):
    """Rank i's ``x`` to rank i + 1 (i − 1 with ``back``); the ring closes
    with ``wrap``, else the first rank in the direction of travel receives
    zeros and the last sends nothing (the local window's halo)."""
    p, i = ax.size, ax.index
    step = -1 if back else 1
    dst, src = (i + step) % p, (i - step) % p
    sends = wrap or 0 <= i + step < p
    gets = wrap or 0 <= i - step < p
    flat = x.contiguous().view(_AS_BITS.get(x.dtype, x.dtype)).reshape(-1)
    ins, outs = [0] * p, [0] * p
    if sends:
        ins[dst] = flat.numel()
    if gets:
        outs[src] = flat.numel()
    recv = torch.empty(flat.numel() if gets else 0, dtype=flat.dtype, device=x.device)
    dist.all_to_all_single(recv, flat if sends else flat[:0], output_split_sizes=outs,
                           input_split_sizes=ins, group=ax.group)
    return recv.view(x.dtype).reshape(x.shape) if gets else torch.zeros_like(x)


def local_slice(x, ax, dim: int):
    """This rank's slice of ``x`` along ``dim`` (no gradient bookkeeping:
    masks, indices)."""
    if x is None:
        return None
    n = x.shape[dim] // ax.size
    return x.narrow(dim, ax.index * n, n)


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, dim, *xs):
        ctx.ax, ctx.dim = ax, dim
        return tuple(local_slice(x, ax, dim) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *(torch.cat(all_gather(g, ctx.ax), ctx.dim) for g in grads))


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, dim, x):
        ctx.ax, ctx.dim = ax, dim
        return torch.cat(all_gather(x, ax), dim)

    @staticmethod
    def backward(ctx, g):
        return None, None, local_slice(g, ctx.ax, ctx.dim).contiguous()


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, *xs):
        ctx.ax = ax
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *(all_reduce_sum(g, ctx.ax) for g in grads))


class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, wrap, *xs):
        ctx.ax, ctx.wrap = ax, wrap
        return tuple(rotate_plain(x, ax, wrap=wrap) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *(rotate_plain(g, ctx.ax, wrap=ctx.wrap, back=True)
                              for g in grads))


class _Touch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, *xs):
        ctx.like = [(x.shape, x.dtype, x.device) for x in xs]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=v) for s, d, v in ctx.like))


def _one(out):
    return out[0] if len(out) == 1 else out


def shard(ax, dim: int, *xs):
    """This rank's slices of ``xs`` along ``dim``; their gradients are
    all-gathered back to full tensors."""
    return _one(_Shard.apply(ax, dim, *xs))


def gather(ax, dim: int, x):
    """The ranks' slices concatenated along ``dim`` (rank order)."""
    return _Gather.apply(ax, dim, x)


def replicated(ax, *xs):
    """``xs`` unchanged; their gradients summed over the ranks."""
    return _one(_Replicated.apply(ax, *xs))


def rotate(ax, *xs, wrap: bool = True):
    """``xs`` from the previous rank on the ring (see :func:`rotate_plain`);
    the gradients travel back."""
    return _one(_Rotate.apply(ax, wrap, *xs))


def touch(out, *xs):
    """``out`` unchanged, with ``xs`` given a zero gradient: every rotation
    that produced them then runs its backward on every rank, also where a
    rank used none of their values (a skipped hop)."""
    return _Touch.apply(out, *xs)
