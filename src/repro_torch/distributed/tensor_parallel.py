"""Megatron-style tensor parallelism over the mesh's ``model`` axis.

JAX has no counterpart of this module: there the train step is jitted
with ``param_shardings`` and GSPMD splits the compute by itself, so that
each rank of ``model`` computes its own heads, FFN columns, vocabulary
slice and experts.  PyTorch has no GSPMD, so the port says it here.

A weight is *cut* when ``runtime.Trainer`` holds only this rank's part of
it along one dim (:func:`cut`, from the spec ``param_shardings`` gives it:
:func:`model_dim`).  The model code asks :func:`cut_dim` and computes on
the part; nothing else in the models names the rule tables.  The conjugate
pair of collectives on ``model`` carries the gradients (Megatron's f and
g):

  * :func:`copy_to_model`: forward the identity, backward the sum over
    ``model`` (``comm.replicated``): the input of a column product, whose
    gradient each rank knows only for its own columns;
  * :func:`reduce_from_model`: forward the sum over ``model``, backward
    the identity: the output of a row product, or of a rank's experts.

A statistic of every rank's part that every rank's own output then
reads (mamba's gated norm's sum of squares over heads split across
ranks) is summed in both directions (:func:`reduce_statistic`): each
rank knows its gradient only through its own outputs.

Every sum all-gathers and adds in rank order (``comm.all_reduce_sum``), so
the ranks hold equal bits.  The column and row products built on them
are ``layers.nn.column_dense`` / ``row_dense``, beside ``dense``.  A
weight that is replicated over ``model`` but used in head-split compute
(a φ operator, a gate) reaches the model through :func:`shared`: its
gradient is summed over ``model``, the whole gradient on every rank.

The axis is the ``model`` group of the mesh of the active
``sharding.axis_rules`` (the ``Trainer``'s step; a recompute re-enters
them through ``sharding.forward_context``).  A cut weight outside such a
step raises.
"""

from __future__ import annotations

import types

import torch
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.distributed import comm

__all__ = ["MODEL", "model_dim", "cut", "uncut", "cut_dim", "axis", "vocab_part",
           "copy_to_model", "reduce_from_model", "reduce_statistic", "gather_summed",
           "shared", "whole"]

MODEL = "model"

# parameter → the dim of it that holds only this rank's part over ``model``
_CUT = WeakIdKeyDictionary()


def model_dim(spec) -> int | None:
    """The dim a ``param_shardings`` spec cuts over ``model``, None where it
    cuts none.  A leaf that JAX cuts on its layer axis (a stacked vector,
    ``Spec.owner`` over ``model``) stays whole here: it has no dim of its
    own to cut."""
    for dim, entry in enumerate(spec):
        if entry == MODEL:
            return dim
    return None


def cut(p: torch.Tensor, dim: int) -> None:
    """Mark ``p`` as holding only this rank's part along ``dim``."""
    _CUT[p] = dim


def uncut(p: torch.Tensor) -> None:
    _CUT.pop(p, None)


def cut_dim(p) -> int | None:
    """The dim of ``p`` cut over ``model``, None where ``p`` is whole."""
    return _CUT.get(p) if isinstance(p, torch.Tensor) else None


def axis():
    """The ``model`` axis group (``launch.mesh.AxisGroup``) of the active
    ``axis_rules``' mesh, for a cut weight in use: outside them, or where
    ``model`` has one rank, a cut weight is an error."""
    from repro_torch.distributed.sharding import current_rules
    ctx = current_rules()
    mesh = ctx[0] if ctx is not None else None
    if not hasattr(mesh, "axis_group") or mesh.shape.get(MODEL, 1) <= 1:
        raise RuntimeError("a weight cut over 'model' used outside a mesh step "
                           "(runtime.Trainer(mesh=...) holds the parts)")
    return mesh.axis_group(MODEL)


def vocab_part(w: torch.Tensor):
    """(the ``model`` axis group, this rank's first vocabulary id) where the
    logits' weight ``w`` (vocabulary on dim 0) is cut over ``model``, else
    None.  A whole ``w`` in a step over a ``model`` axis of several ranks
    is JAX's replication fallback (a vocabulary that does not divide): its
    one-shot warning."""
    if cut_dim(w) is None:
        from repro_torch.distributed.sharding import current_rules, logical_to_spec
        ctx = current_rules()
        if ctx is not None and hasattr(ctx[0], "axis_group"):
            logical_to_spec(("vocab",), (w.shape[0],), *ctx)
        return None
    ax = axis()
    return ax, ax.index * w.shape[0]


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, x):
        return comm.all_reduce_sum(x, ax)

    @staticmethod
    def backward(ctx, g):
        return None, g


class _ReduceBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, x):
        ctx.ax = ax
        return comm.all_reduce_sum(x, ax)

    @staticmethod
    def backward(ctx, g):
        return None, comm.all_reduce_sum(g.contiguous(), ctx.ax)


class _GatherSummed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, dim, x):
        ctx.ax, ctx.dim = ax, dim
        return torch.cat(comm.all_gather(x, ax), dim)

    @staticmethod
    def backward(ctx, g):
        g = comm.all_reduce_sum(g.contiguous(), ctx.ax)
        return None, None, comm.local_slice(g, ctx.ax, ctx.dim).contiguous()


def copy_to_model(ax, *xs):
    """``xs`` unchanged; their gradients summed over ``model``."""
    return comm.replicated(ax, *xs)


def reduce_from_model(ax, x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over ``model`` (rank order); the gradient passes as it
    is."""
    return _Reduce.apply(ax, x)


def reduce_statistic(ax, x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over ``model`` (rank order), its gradient summed over
    ``model`` too: a statistic of the ranks' parts that each rank's own
    outputs read, so that each rank holds only its share of its
    gradient."""
    return _ReduceBoth.apply(ax, x)


def gather_summed(ax, dim: int, x: torch.Tensor) -> torch.Tensor:
    """The ranks' parts concatenated along ``dim``, where each rank then
    uses the whole in its own part of the compute: the gradient of the
    whole is summed over ``model`` and this rank's slice of it returned."""
    return _GatherSummed.apply(ax, dim, x)


def _mirror(module: torch.nn.Module, leaf, skip=()):
    """A namespace with ``module``'s parameters as ``leaf(param)``, under
    their attribute names (submodules nested; those named in ``skip`` left
    out); None stays None."""
    ns = types.SimpleNamespace(**{k: None for k, v in vars(module).items()
                                  if v is None and not k.startswith("_")})   # Dense's b
    for name, p in module._parameters.items():
        setattr(ns, name, None if p is None else leaf(p))
    for name, m in module._modules.items():
        if name not in skip:
            setattr(ns, name, None if m is None else _mirror(m, leaf))
    return ns


def shared(ax, module: torch.nn.Module, skip=()):
    """``module``'s parameters (but the submodules named in ``skip``) for
    compute that each rank runs on its own part of the work (its heads,
    its columns): a cut one whole (:func:`gather_summed`), a whole one as
    it is (``comm.replicated``); either way the gradient is the sum over
    ``model`` of the ranks' parts, the whole gradient on every rank."""
    def leaf(p):
        d = cut_dim(p)
        return comm.replicated(ax, p) if d is None else gather_summed(ax, d, p)
    return _mirror(module, leaf, skip)


def whole(ax, module: torch.nn.Module):
    """``module``'s parameters whole for compute that every rank runs in
    full (the replicated fallback): a cut one all-gathered, its gradient
    this rank's slice of the (equal) whole gradient."""
    def leaf(p):
        d = cut_dim(p)
        return p if d is None else comm.gather(ax, d, p)
    return _mirror(module, leaf)
