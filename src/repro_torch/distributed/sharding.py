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
"""

from __future__ import annotations

import contextlib
import threading
import warnings

__all__ = ["DEFAULT_RULES", "axis_rules", "current_rules", "logical_to_spec", "constrain",
           "reset_replication_warnings"]

_STATE = threading.local()

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
