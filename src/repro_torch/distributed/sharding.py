"""Logical-axis sharding rules.

Counterpart of ``repro/distributed/sharding.py``.  Code names the logical
axes of an activation (``constrain(x, "batch", "seq", "d_model")``); a
context maps logical names to mesh axes, and :func:`logical_to_spec` turns
a shape into a spec: a plain tuple with, per dimension, a mesh axis name, a
tuple of names, or None (replicated).  A logical axis maps only where the
dimension divides the mesh axes' size; a divisibility miss replicates and
warns once per cause.

PyTorch has no GSPMD to act on a sharding hint, so :func:`constrain`
returns its input unchanged: in the port the glue between the sharded ops
(projections, pooling, top-k, the gated combine) stays replicated on every
rank, and only the ops of the ``"sharded"`` backend
(``distributed/sharded_backend.py``) split work across ranks.

Where the rules map the logical axis ``batch`` onto mesh axes, each rank
holds only its slice of the batch (``runtime.Trainer`` with a mesh); a
sum that a loss divides by (a count of real points or tokens, the MoE
router's load statistics) then spans the whole batch only once it is
added over those axes: :func:`batch_total`.  JAX's GSPMD takes such sums
over the global array by itself.

:func:`mesh_context` activates a mesh for the ``"sharded"`` backend, and
:func:`forward_context` captures it, the rules and the ``use_backend`` name
for a recompute on another thread.  They live here, not beside the
backend, so that the models (remat) need not load ``sharded_backend``.
"""

from __future__ import annotations

import contextlib
import threading
import warnings

import torch

from repro_torch.core.backend import active_backend, use_backend
from repro_torch.distributed import comm

__all__ = ["DEFAULT_RULES", "axis_rules", "current_rules", "logical_to_spec", "constrain",
           "reset_replication_warnings", "batch_groups", "batch_total", "mesh_context",
           "current_mesh_axis", "forward_context"]

_STATE = threading.local()
_MESHES = threading.local()

# (logical name, mesh axes, dim, size) combos already warned about: the
# divisibility fallback warns once per distinct cause
_WARNED_REPLICATION: set = set()

# logical axis -> mesh axis name(s); None = replicate (the JAX module's table)
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_res": ("model",),
    "seq_sp": ("data",),
    "seq_model": ("model",),
    "d_model": None,
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": None,
    "d_ff": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "capacity": ("pod", "data"),
    "ssm_inner": ("model",),
    "ssm_state": None,
    "blocks": None,
    "stage": ("stage",),
}


def reset_replication_warnings() -> None:
    """Clear the one-shot divisibility-warning registry (test isolation)."""
    _WARNED_REPLICATION.clear()


def _get():
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def axis_rules(mesh, rules: dict | None = None):
    """Map logical axes to ``mesh``'s axes in this block (this thread):
    :data:`DEFAULT_RULES` updated by ``rules``."""
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    prev = _get()
    _STATE.ctx = (mesh, merged)
    try:
        yield
    finally:
        _STATE.ctx = prev


def current_rules():
    """(mesh, rules) of the innermost :func:`axis_rules`, or None."""
    return _get()


@contextlib.contextmanager
def mesh_context(mesh, *, axis: str = "data", rules: dict | None = None):
    """Activate ``mesh`` for the ``"sharded"`` backend in this block (this
    thread); ``axis`` names the mesh axis the sequence splits over.  Also
    enters :func:`axis_rules` with ``seq_sp`` on ``axis`` and ``batch`` off
    it (``rules`` overrides)."""
    if axis not in mesh.shape:
        raise ValueError(f"mesh_context: axis {axis!r} not in mesh axes {tuple(mesh.shape)}")
    merged = {"batch": None, "seq_sp": (axis,)}
    if rules:
        merged.update(rules)
    stack = getattr(_MESHES, "stack", None)
    if stack is None:
        stack = _MESHES.stack = []
    stack.append((mesh, axis))
    try:
        with axis_rules(mesh, merged):
            yield mesh
    finally:
        stack.pop()


def current_mesh_axis():
    """(mesh, axis) of the innermost active :func:`mesh_context`, or None."""
    stack = getattr(_MESHES, "stack", None)
    return stack[-1] if stack else None


def forward_context():
    """A function that re-enters, on whatever thread calls it, what is
    active on this thread now: the ``use_backend`` name, the innermost
    :func:`mesh_context` and the :func:`axis_rules`.  All three live in
    thread-local state, and autograd runs a CUDA backward on a thread of
    its own: a recompute (activation checkpointing) captures them in the
    forward and enters them again there."""
    backend, mesh_axis, rules = active_backend(), current_mesh_axis(), current_rules()

    def enter() -> contextlib.ExitStack:
        stack = contextlib.ExitStack()
        if backend:
            stack.enter_context(use_backend(backend))
        if mesh_axis is not None:
            stack.enter_context(mesh_context(mesh_axis[0], axis=mesh_axis[1]))
        if rules is not None:
            stack.enter_context(axis_rules(*rules))
        return stack

    return enter


def logical_to_spec(logical_axes, shape, mesh, rules) -> tuple:
    """Map logical axis names to a spec tuple, respecting divisibility.
    ``mesh`` is anything with a ``shape`` mapping of axis name → size."""
    spec = []
    used = set()
    for dim, name in zip(shape, logical_axes):
        entry = rules.get(name) if name else None
        if entry is None:
            spec.append(None)
            continue
        axes = tuple(a for a in (entry if isinstance(entry, tuple) else (entry,))
                     if a in mesh.shape and a not in used)
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        if axes and size > 0 and dim % size == 0:
            spec.append(axes if len(axes) > 1 else axes[0])
            used.update(axes)
        else:
            if axes and dim % size != 0:
                # losing an axis already used is structural and silent; a
                # divisibility miss is usually a shape bug, so name it once
                key = (name, axes, dim, size)
                if key not in _WARNED_REPLICATION:
                    _WARNED_REPLICATION.add(key)
                    warnings.warn(
                        f"logical axis {name!r} (dim {dim}) is not divisible by mesh "
                        f"axes {axes} (size {size}); replicating instead of sharding",
                        RuntimeWarning, stacklevel=2)
            spec.append(None)
    return tuple(spec)


def constrain(x, *logical_axes):
    """A sharding hint: returns ``x`` unchanged (no GSPMD to act on it; the
    glue stays replicated).  Inside an :func:`axis_rules` context the
    number of names must match ``x``'s rank, as in JAX."""
    ctx = _get()
    if ctx is not None and len(logical_axes) != x.ndim:
        raise ValueError(f"{len(logical_axes)} axes for rank-{x.ndim} array")
    return x


def batch_groups() -> tuple:
    """The axis groups (``Mesh.axis_group``) of the active rules' mesh that
    the logical axis ``batch`` maps onto, in the rules' order, leaving out
    axes of size 1: the ranks among which the batch is split.  () outside
    :func:`axis_rules`, or where ``batch`` maps onto no axis of a mesh of
    ranks (``mesh_context`` maps it onto none)."""
    ctx = _get()
    if ctx is None:
        return ()
    mesh, rules = ctx
    entry = rules.get("batch")
    if not entry or not hasattr(mesh, "axis_group"):
        return ()
    axes = entry if isinstance(entry, tuple) else (entry,)
    return tuple(mesh.axis_group(a) for a in axes if mesh.shape.get(a, 1) > 1)


def batch_total(x, *, device=None):
    """``x`` summed over the ranks of :func:`batch_groups` (in rank order:
    the same bits on every rank), or ``x`` itself, untouched, where the
    batch is not split.  An int becomes an int64 tensor on ``device`` to be
    summed; a dict of tensors (a step's gradients) is summed as one flat
    buffer a dtype.  For the non-differentiable sums a loss divides by, and
    for what a step reads of the whole batch."""
    groups = batch_groups()
    if not groups:
        return x
    if isinstance(x, dict):
        out = {}
        for dtype in dict.fromkeys(t.dtype for t in x.values()):
            names = [n for n, t in x.items() if t.dtype == dtype]
            flat = batch_total(torch.cat([x[n].reshape(-1) for n in names]))
            for n, part in zip(names, flat.split([x[n].numel() for n in names])):
                out[n] = part.view(x[n].shape)
        return {n: out[n] for n in x}
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(x, dtype=torch.int64, device=device)
    for ax in groups:
        x = comm.all_reduce_sum(x, ax)
    return x
