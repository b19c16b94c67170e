"""GPipe-style pipeline parallelism over a ``stage`` mesh axis.

Counterpart of ``repro/distributed/pipeline.py``.  The layer stack splits
into S stages, one a rank of the axis; microbatches stream through with
:func:`comm.rotate_plain` handoffs.  T = n_micro + S − 1 ticks; stage s
computes microbatch m = t − s when 0 ≤ m < n_micro (the usual fill/drain
bubble, fraction (S−1)/T).  Each rank calls :func:`pipeline_apply` with
the full stacked stage parameters and the full input, as every rank of
the port runs the same program on the same full tensors, and takes its
stage's slice ``leaf[index]``.

JAX's ``shard_map`` runs every tick on every stage and masks the idle
ones; a rank here knows its stage, so it skips the compute of an idle
tick and only takes part in the handoff.  The schedule is one autograd
node: its backward walks the ticks in reverse, every rank handing the
gradient back one stage a tick, as the transpose of JAX's loop does, so
the collectives run in one order on every rank.  The stage slices'
gradients are all-gathered back to the stacked shape, the input's summed
over the stages (only stage 0 reads it), and the output, which the last
stage computes and every rank receives, passes its gradient to the last
stage.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import comm

__all__ = ["pipeline_apply"]


def _flatten(tree) -> tuple[list, object]:
    """(leaves, a function rebuilding the tree from a list of leaves)."""
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(v) for v in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    leaves, sizes = [], []
    for sub, _ in parts:
        leaves += sub
        sizes.append(len(sub))

    def rebuild(flat):
        out, at = [], 0
        for (_, build), n in zip(parts, sizes):
            out.append(build(flat[at:at + n]))
            at += n
        return dict(zip(keys, out)) if keys is not None else type(tree)(out)
    return leaves, rebuild


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, rebuild, ax, x_micro, *leaves):
        S, sid = ax.size, ax.index
        n_micro = x_micro.shape[0]
        mine = [t[sid].detach().requires_grad_(t.requires_grad) for t in leaves]
        params = rebuild(mine)
        buf = torch.zeros_like(x_micro[0])           # inter-stage register
        outs = torch.zeros_like(x_micro)
        ticks = {}                                   # t → (x_in, y) of an active tick
        for t in range(n_micro + S - 1):
            m = t - sid                              # microbatch index at this stage
            if 0 <= m < n_micro:
                # stage 0 reads fresh input; others read the handoff register
                x_in = (x_micro[m] if sid == 0 else buf).detach().requires_grad_()
                with torch.enable_grad():
                    y = stage_fn(params, x_in)
                ticks[t] = (x_in, y)
                buf = y.detach()
                if sid == S - 1:                     # last stage writes output
                    outs[m] = buf
            buf = comm.rotate_plain(buf, ax)         # hand off to the next stage
        ctx.ax, ctx.ticks, ctx.mine, ctx.n_micro = ax, ticks, mine, n_micro
        ctx.x_shape = x_micro.shape
        # outputs live on the last stage; the sum carries them to every stage
        return comm.all_reduce_sum(outs, ax)

    @staticmethod
    def backward(ctx, g_out):
        ax, ticks, mine, n_micro = ctx.ax, ctx.ticks, ctx.mine, ctx.n_micro
        S, sid = ax.size, ax.index
        g_params = [torch.zeros_like(p) for p in mine]
        g_x = g_out.new_zeros(ctx.x_shape)
        g_buf = torch.zeros_like(g_out[0])
        for t in reversed(range(n_micro + S - 1)):
            g_buf = comm.rotate_plain(g_buf, ax, back=True)   # the handoff's transpose
            if t not in ticks:
                continue                             # an idle tick passes the register on
            m = t - sid
            if sid == S - 1:
                g_buf = g_buf + g_out[m]
            x_in, y = ticks[t]
            want = [x_in] + [p for p in mine if p.requires_grad]
            grads = torch.autograd.grad(y, want, g_buf, allow_unused=True)
            g_in = grads[0] if grads[0] is not None else torch.zeros_like(x_in)
            it = iter(grads[1:])
            for i, p in enumerate(mine):
                if p.requires_grad:
                    g = next(it)
                    if g is not None:
                        g_params[i] = g_params[i] + g
            if sid == 0:
                g_x[m] = g_in
                g_buf = torch.zeros_like(g_buf)
            else:
                g_buf = g_in
        ctx.ticks = None
        g_leaves = [torch.stack(comm.all_gather(g.contiguous(), ax)) if p.requires_grad
                    else None for p, g in zip(mine, g_params)]
        return (None, None, None, comm.all_reduce_sum(g_x, ax), *g_leaves)


def pipeline_apply(stage_fn, stage_params, x_micro: torch.Tensor, *, mesh,
                   axis_name: str = "stage") -> torch.Tensor:
    """Run a pipelined stack.

    stage_fn(params_s, x) -> y   (same shape), applied S times in sequence;
    stage_params: a tensor, or a dict / list / tuple of them, with leading
    STAGE dim S on every leaf; x_micro: (n_micro, B, ...) microbatches.
    Returns (n_micro, B, ...) outputs, exactly stage_{S-1}∘…∘stage_0, on
    every rank of the axis; differentiable in ``stage_params`` and
    ``x_micro``.  Every rank of the axis must call it.
    """
    ax = mesh.axis_group(axis_name)
    leaves, rebuild = _flatten(stage_params)
    for t in leaves:
        if t.shape[0] != ax.size:
            raise ValueError(f"pipeline_apply: a stage leaf of shape {tuple(t.shape)} for "
                             f"{ax.size} stages on axis {axis_name!r}")
    return _Pipeline.apply(stage_fn, rebuild, ax, x_micro, *leaves)
