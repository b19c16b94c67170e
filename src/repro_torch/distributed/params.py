"""Parameter / optimizer-state / batch / cache layouts over a mesh of ranks,
and the slices they give each rank.

Counterpart of ``repro/distributed/params.py``, with its rule tables
(Megatron-style tensor parallelism over the ``model`` axis):

  wq, wk, wv, gate, up (column-parallel)   → output dim over model
  wo, down (row-parallel)                  → input dim over model
  embed/tok_embed table                    → vocab dim over model
  lm_head                                  → vocab (output) dim over model
  MoE expert stacks w_gate/w_up/w_down     → EXPERT dim over model (EP)
  mamba in_proj/out_proj                   → inner dim over model
  everything else (norms, gates, biases)   → replicated

A rule that does not divide falls back to replication (the llava-56-heads
case).  Optimizer m/v also shard their largest remaining dim over the DP
axes (``pod``, ``data``): ZeRO-1.

A layout here is a :class:`Spec`: a plain tuple with, per dimension, a
mesh axis name, a tuple of names or None (the tuples of
``sharding.logical_to_spec``), keyed by the model's ``named_parameters()``
names.  The two packages lay parameters out differently, and JAX's rules
are applied to JAX's layout, then mapped onto the port's:

  * JAX stacks the layers of a stack on a leading axis (``layers``,
    ``lm.layers``, ``enc_layers``, ``dec_layers``); the port has a module
    a layer (``layers.0.pos0.attn.wq.w``).  A leaf's JAX spec is taken on
    the stacked shape and its layer axis dropped.
  * JAX keeps a dense weight ``w`` as (d_in, d_out), the port as (d_out,
    d_in) (``convert.py``): the spec of a ``w`` is reversed.
  * ZeRO-1 picks "the largest still-unsharded dim", and for a small
    stacked leaf (the BSA gate vectors, (18, 8) in ``shapenet-bsa``) that
    is the layer axis.  The port's layer then has no dim to cut: it is
    owned whole, layer i by the rank at coordinate ``i · size / n_layers``
    of those axes (``Spec.owner``), which is where JAX's slice of the
    stacked leaf puts it.

:func:`local_part` cuts a full tensor to this rank's part of a spec and
:func:`full_tensor` gathers the parts back (in rank order: the same bits
on every rank).  ``runtime.Trainer`` realises the layouts with them.
"""

from __future__ import annotations

import math

import torch

from repro_torch.distributed import comm

__all__ = ["Spec", "param_shardings", "opt_shardings", "batch_shardings",
           "cache_shardings", "replicated", "axis_coordinate", "local_part", "full_tensor"]

_COL = {"wq", "wk", "wv", "gate", "up", "lm_head", "fc1", "frontend_proj",
        "in_proj", "head"}
_ROW = {"wo", "down", "out_proj", "fc2"}
_VOCAB_TABLE = {"embed", "tok_embed"}
_EXPERT = {"w_gate", "w_up", "w_down"}
_DP = ("pod", "data")


class Spec(tuple):
    """A layout: a tuple with one entry a dimension (a mesh axis name, a
    tuple of names, or None), equal to the plain tuple.  ``owner``, where
    set, is ``(axes, coordinate)``: the whole tensor belongs to the ranks
    at ``coordinate`` along ``axes`` (row-major over them), and the
    others hold none of it."""

    def __new__(cls, entries=(), owner=None):
        self = super().__new__(cls, entries)
        self.owner = owner
        return self

    def __repr__(self) -> str:
        return f"Spec({tuple(self)}" + (f", owner={self.owner})" if self.owner else ")")


def _leaf_spec(names: tuple, nd: int) -> list[int]:
    """Priority-ordered candidate dims (index from the LEFT, of JAX's
    layout) to shard over ``model``; the first divisible one wins in
    :func:`_finalize`."""
    if nd == 0:
        return []
    field = names[-1] if names else ""
    parent = names[-2] if len(names) >= 2 else ""
    if field == "w" or field == "b":
        field = parent
        parent = names[-3] if len(names) >= 3 else ""
    if field == "table" and parent in _VOCAB_TABLE:
        return [nd - 2]                 # (vocab, d_model) → shard vocab
    if field in _EXPERT:
        # EP when E | TP; else TP inside each expert (e.g. qwen's 60 experts
        # on a 16-way axis): column dim for w_gate/w_up, row dim for w_down
        inner = nd - 1 if field in ("w_gate", "w_up") else nd - 2
        return [nd - 3, inner]
    if field in _COL and nd >= 2:
        return [nd - 1]                 # output dim
    if field in _ROW and nd >= 2:
        return [nd - 2]                 # input dim
    return []


def _finalize(cands, shape, sizes: dict, *, zero1: bool = False,
              all_axes: bool = False) -> list:
    axes_model = sizes.get("model", 1)
    dp_names = ("pod", "data", "model") if all_axes else _DP
    dp_axes = tuple(a for a in dp_names if a in sizes)
    dp_size = math.prod(sizes[a] for a in dp_axes)
    out: list = [None] * len(shape)
    for i in cands:
        if axes_model > 1 and shape[i] % axes_model == 0:
            out[i] = "model"
            break
    if zero1 and dp_axes and dp_size > 1:
        # ZeRO-1: shard the largest still-unsharded dim over DP if divisible
        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if out[i] is None and shape[i] % dp_size == 0 and shape[i] >= dp_size:
                out[i] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
                break
    return out


def _axes(entry) -> tuple:
    return () if entry is None else entry if isinstance(entry, tuple) else (entry,)


def _stacks(names) -> dict:
    """{stack prefix: its number of layers} of parameter names
    ``<prefix>.<i>.<rest>`` (the first all-digit part marks the layer)."""
    depth: dict = {}
    for name in names:
        parts = name.split(".")
        at = next((i for i, p in enumerate(parts) if p.isdigit()), None)
        if at is not None:
            key = tuple(parts[:at])
            depth[key] = max(depth.get(key, 0), int(parts[at]) + 1)
    return depth


def _port_spec(name: str, shape: tuple, depth: dict, sizes: dict, rule) -> Spec:
    """The port's spec of ``name`` from ``rule(jax_path, jax_shape)``, a
    spec on JAX's layout of the same leaf."""
    parts = name.split(".")
    at = next((i for i, p in enumerate(parts) if p.isdigit()), None)
    transposed = parts[-1] == "w"                 # (d_out, d_in) here, (d_in, d_out) there
    jshape = tuple(reversed(shape)) if transposed else tuple(shape)
    if at is None:
        entries = rule(tuple(parts), jshape)
        return Spec(tuple(reversed(entries)) if transposed else entries)
    n = depth[tuple(parts[:at])]
    layer = int(parts[at])
    entries = rule(tuple(parts[:at] + parts[at + 1:]), (n, *jshape))
    stacked, entries = entries[0], entries[1:]
    owner = None
    if stacked is not None:                       # JAX cuts the layer axis
        axes = _axes(stacked)
        owner = (axes, layer * math.prod(sizes[a] for a in axes) // n)
    return Spec(tuple(reversed(entries)) if transposed else entries, owner)


def param_shardings(params: dict, mesh, *, zero1: bool = False, tp: bool = True) -> dict:
    """{name: Spec} for ``params`` (name → anything with a ``shape``: the
    model's ``named_parameters()``).  ``tp=False`` disables model-axis
    tensor parallelism (DP-heavy layout for small models); params then rely
    on zero1/FSDP over ALL mesh axes."""
    sizes = dict(mesh.shape)
    depth = _stacks(params)

    def rule(path, shape):
        cands = _leaf_spec(path, len(shape)) if tp else []
        return _finalize(cands, shape, sizes, zero1=zero1, all_axes=not tp)
    return {n: _port_spec(n, tuple(t.shape), depth, sizes, rule) for n, t in params.items()}


def opt_shardings(opt_state: dict, mesh, *, tp: bool = True) -> dict:
    """m/v follow the param rules + ZeRO-1 over DP; ``step`` replicated.
    ``opt_state``: ``{"m": {name: t}, "v": {name: t}, "step": n}``."""
    out = {"step": Spec()}
    for key in ("m", "v"):
        out[key] = param_shardings(opt_state[key], mesh, zero1=True, tp=tp)
    return out


def batch_shardings(batch: dict, mesh, *, seq_parallel: bool = False,
                    full_dp: bool = False) -> dict:
    """Batch dim over DP axes; in SP mode (global_batch < DP) shard the
    SEQUENCE dim over `data` instead (BSA makes this collective-cheap).
    ``full_dp`` spreads batch over the model axis too (DP-heavy layout).
    Keys without a shape (``_state``) are left out."""
    names = ("pod", "data", "model") if full_dp else _DP
    sizes = dict(mesh.shape)
    dp = tuple(a for a in names if a in sizes)
    dp_size = math.prod(sizes[a] for a in dp)

    def one(shape):
        spec: list = [None] * len(shape)
        if len(shape) >= 1:
            if not seq_parallel and dp and shape[0] % dp_size == 0:
                spec[0] = dp if len(dp) > 1 else dp[0]
            elif seq_parallel and len(shape) >= 2 and "data" in sizes \
                    and shape[1] % sizes["data"] == 0:
                spec[1] = "data"
        return Spec(spec)
    return {k: one(tuple(v.shape)) for k, v in batch.items() if hasattr(v, "shape")}


def _cache_rule(names: tuple, shape: tuple, sizes: dict, seq_parallel: bool) -> list:
    """JAX's cache rule on its stacked leaf (NP, B, ...)."""
    dp = tuple(a for a in _DP if a in sizes)
    dp_size = math.prod(sizes[a] for a in dp)
    model = sizes.get("model", 1)
    nd = len(shape)
    spec: list = [None] * nd
    # k/v: (NP, B, S, Hkv, D)   k_cmp/v_cmp: (NP, B, NB, Hkv, D)
    # mamba h: (NP, B, H, Ns, P)   conv: (NP, B, W, C)   length: (NP,)
    # encdec adds mem_k/mem_v: (NP, B, S, Hkv, D)
    field = names[-1] if names else ""
    if field == "length" or nd <= 1:
        return spec
    b_axis = 1 if nd >= 3 else 0
    if not seq_parallel and dp and shape[b_axis] % dp_size == 0:
        spec[b_axis] = dp if len(dp) > 1 else dp[0]
    if field in ("k", "v", "k_cmp", "v_cmp", "mem_k", "mem_v") and nd >= 5:
        if seq_parallel and "data" in sizes and shape[2] % sizes["data"] == 0:
            spec[2] = "data"
        if shape[3] % model == 0 and model > 1:
            spec[3] = "model"
        elif spec[2] is None and model > 1 and shape[2] % model == 0:
            # kv_heads ∤ model: shard the cache SEQUENCE over model instead
            spec[2] = "model"
    elif field == "h" and nd >= 5 and model > 1 and shape[2] % model == 0:
        spec[2] = "model"           # mamba state heads (JAX's rule names "model"
                                    # on a mesh without it too, which NamedSharding refuses)
    return spec


def cache_shardings(caches: list, mesh, *, seq_parallel: bool = False) -> list:
    """KV caches: batch over DP; kv-head dim over model when divisible; in SP
    mode the cache SEQUENCE dim shards over `data`.  ``caches``: the port's
    decode caches, a list with a dict a period (a layer of the
    encoder-decoder), which JAX stacks on a leading axis: each leaf's spec
    is JAX's on the stacked shape with that axis dropped."""
    sizes, n = dict(mesh.shape), len(caches)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, (*path, k)) for k, v in tree.items()}
        entries = _cache_rule(path, (n, *tuple(tree.shape)), sizes, seq_parallel)
        assert entries[0] is None                 # JAX never cuts the layer axis of a cache
        return Spec(entries[1:])
    return [walk(period, ()) for period in caches]


def replicated(mesh) -> Spec:
    """Whole on every rank."""
    return Spec()


# ---------------------------------------------------------------------------
# a spec's parts on the ranks
# ---------------------------------------------------------------------------

def axis_coordinate(mesh, axes) -> tuple[int, int]:
    """(this rank's coordinate, their count) along ``axes`` together,
    row-major: the index of its slice of a dim cut over ``axes``."""
    c, n = 0, 1
    for a in _axes(axes):
        g = mesh.axis_group(a)
        c, n = c * g.size + g.index, n * g.size
    return c, n


def _owns(spec: Spec, mesh) -> bool:
    return spec.owner is None or axis_coordinate(mesh, spec.owner[0])[0] == spec.owner[1]


def local_part(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's part of the full tensor ``t`` under ``spec``: a view of
    ``t`` (an empty tensor where the rank owns none of it)."""
    if not _owns(spec, mesh):
        return t.new_empty((0,))
    for dim, entry in enumerate(spec):
        if entry is not None:
            c, n = axis_coordinate(mesh, entry)
            size = t.shape[dim] // n
            t = t.narrow(dim, c * size, size)
    return t


def full_tensor(part: torch.Tensor, spec: Spec, shape, mesh) -> torch.Tensor:
    """The full tensor of ``shape`` from every rank's ``part`` under
    ``spec`` (a collective over the spec's axes, in rank order: the same
    bits on every rank).  Every rank of those axes must call it."""
    if _owns(spec, mesh):
        for dim, entry in enumerate(spec):
            for a in reversed(_axes(entry)):      # the last axis varies fastest
                part = torch.cat(comm.all_gather(part, mesh.axis_group(a)), dim)
    else:
        part = part.new_zeros(tuple(shape))
    if spec.owner is not None:
        axes, coord = spec.owner
        idx = []
        for a in reversed(axes):
            coord, i = divmod(coord, mesh.shape[a])
            idx.append(i)
        for a, i in zip(reversed(axes), idx):
            part = comm.all_gather(part.contiguous(), mesh.axis_group(a))[i]
    return part
