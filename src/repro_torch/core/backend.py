"""Pluggable attention-backend registry — the kernel/reference seam.

Counterpart of ``repro/core/backend.py``.  ``bsa_attention`` runs its hot
loops through a backend object with the ops ``ball``, ``flash``,
``selection`` and ``gated_combine``; ``nsa_causal_attention`` (the causal
LM) through ``local_window`` in place of ``ball``;
``bsa_attention_varlen`` (the packed layout) through ``ball_varlen``,
``flash_varlen``, ``local_window_varlen`` and ``selection_varlen``,
resolved by :func:`get_varlen`; the paged decode
(``nsa_causal_decode_paged``) fetches the same rows of its K and V pools
through ``paged_gather_pair``, resolved by :func:`get_paged_gather`
(``paged_gather`` gathers one pool).  Shapes follow
``core``: q (B, N, Hq, D), k/v (B, L, Hkv, D), GQA-native; the varlen ops
take one packed axis, q (T, Hq, D), k/v (L, Hkv, D), and host ``offsets``;
``paged_gather(pool (R, Hkv, D), rows)`` → ``rows.shape + (Hkv, D)``,
``paged_gather_pair(k_pool, v_pool, rows)`` → two of them.

Built-ins:

  ``"reference"``  plain PyTorch (``core/branches.py``, ``core/bsa.py``,
                   ``kernels/ref.py``) on any device, differentiated by
                   autograd;
  ``"kernels"``    the CUDA kernels through ``kernels/ops.py``, forward and
                   backward (each op is a ``torch.autograd.Function`` whose
                   backward launches the backward kernels; on CPU tensors
                   each runs its kernel's plain versions).  It never
                   answers with the reference;
  ``"auto"``       chosen by the device of the tensors: CUDA tensors take
                   ``"kernels"``, CPU tensors ``"reference"``;
  ``"sharded"``    an inner backend's ops split across the ranks of a
                   mesh (``repro_torch.distributed``), registered on first
                   use.

Resolution (weakest → strongest)::

    BSAConfig.backend  <  with use_backend("..."):  <  $REPRO_TORCH_ATTENTION_BACKEND

as in the JAX package.  The context manager and the environment variable
force one backend for every branch; absent both, ``BSAConfig.backend`` is
the base and ``backend_overrides`` redirects single branches.  The port
reads its own variable, ``REPRO_TORCH_ATTENTION_BACKEND``, holding the
port's names (``reference``, ``kernels``, ``auto`` or any registered
name), and never JAX's ``REPRO_ATTENTION_BACKEND``: the two packages run
side by side in one test process, and JAX's names (``jnp``, ``pallas``,
``interpret``) mean nothing here.  The variable is read at every call and
holds on every thread, so the remat recompute that autograd runs on its
own thread (``active_backend``) resolves to it as the forward did.
:func:`resolve_backend_name` applies the chain to a config's name and
:func:`resolve_backend` returns the object: the baselines
(``full_attention``, ``erwin_attention``) resolve one backend for the
whole call with it.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Iterator

__all__ = ["ReferenceBackend", "KernelBackend", "AutoBackend", "ENV_VAR",
           "DEFAULT_BACKEND", "BRANCH_KEYS", "register_backend", "get_backend",
           "list_backends", "use_backend", "active_backend", "resolve_backend_name",
           "resolve_backend", "resolve_branch_backends", "get_varlen", "get_paged_gather"]

ENV_VAR = "REPRO_TORCH_ATTENTION_BACKEND"
DEFAULT_BACKEND = "auto"
BRANCH_KEYS = ("ball", "cmp", "slc")
REQUIRED_OPS = ("ball", "flash", "selection", "gated_combine")


class ReferenceBackend:
    """Plain PyTorch: the parity oracle of the kernels, on any device.  GQA
    repeats K/V before the equal-head math (``branches.repeat_kv``), which
    pins the semantics the kernels' shared-fetch layouts must match."""

    name = "reference"

    @staticmethod
    def _rep(q, k, v):
        from repro_torch.core.branches import repeat_kv
        rep = q.shape[2] // k.shape[2]
        return repeat_kv(k, rep), repeat_kv(v, rep)

    def ball(self, q, k, v, mask, *, ball_size, chunk_tokens=0):
        from repro_torch.core.bsa import ball_attention_ref
        k, v = self._rep(q, k, v)
        return ball_attention_ref(q, k, v, mask, ball_size)

    def flash(self, q, k, v, *, key_valid=None, causal=False, block_causal=False,
              ell=1, chunk_tokens=0, q_valid=None):
        # q_valid is a hint only: the reference computes every row
        if causal:
            if k.shape[1] != q.shape[1]:
                raise ValueError("token-causal flash needs aligned queries and "
                                 f"keys (N={q.shape[1]}, L={k.shape[1]})")
            from repro_torch.kernels.ref import flash_attention_ref
            return flash_attention_ref(q, k, v, key_valid=key_valid,
                                       causal=True)[0]
        from repro_torch.core.branches import chunked_q_attention
        k, v = self._rep(q, k, v)
        return chunked_q_attention(q, k, v, key_valid=key_valid,
                                   block_causal_ell=ell if block_causal else 0,
                                   chunk=chunk_tokens)

    def local_window(self, q, k, v, *, window, mask=None, chunk_tokens=0):
        from repro_torch.core.nsa_causal import local_window_attention_ref
        k, v = self._rep(q, k, v)
        cb = max(chunk_tokens // window, 1) if chunk_tokens else 0
        return local_window_attention_ref(q, k, v, window, mask=mask, chunk_blocks=cb)

    def selection(self, q, k, v, top_idx, sel_valid, mask, *, block_size,
                  group_size, chunk_tokens=0, q_valid=None):
        from repro_torch.core.branches import selection_attend
        return selection_attend(q, k, v, top_idx, sel_valid, mask,
                                block_size=block_size, q_valid=q_valid)

    def gated_combine(self, outs, gates, mask):
        from repro_torch.core.branches import gated_combine_ref
        return gated_combine_ref(outs, gates, mask)

    def paged_gather(self, pool, rows):
        # plain advanced indexing: the semantics of the paged decode's fetch
        return pool[rows]

    def paged_gather_pair(self, k_pool, v_pool, rows):
        from repro_torch.kernels.paged import paged_gather_pair_plain
        return paged_gather_pair_plain(k_pool, v_pool, rows)

    # -- packed-varlen ops: q (T, Hq, D), k/v (L, Hkv, D), host offsets.  The
    # parity oracle of the varlen kernels: sample isolation is an explicit
    # segment bias on the reference math.

    def ball_varlen(self, q, k, v, offsets, mask, *, ball_size, chunk_tokens=0):
        # offsets are ball multiples: packed ball attention IS B = 1 ball attention
        return self.ball(q[None], k[None], v[None], None if mask is None else mask[None],
                         ball_size=ball_size, chunk_tokens=chunk_tokens)[0]

    def flash_varlen(self, q, k, v, q_offsets, k_offsets, *, key_valid=None,
                     chunk_tokens=0):
        from repro_torch.core.branches import chunked_q_attention
        from repro_torch.kernels.occupancy import segment_ids
        kb, vb = self._rep(q[None], k[None], v[None])
        return chunked_q_attention(
            q[None], kb, vb, key_valid=None if key_valid is None else key_valid[None],
            chunk=chunk_tokens, q_seg=segment_ids(q_offsets, q.shape[0], q.device),
            k_seg=segment_ids(k_offsets, k.shape[0], q.device))[0]

    def local_window_varlen(self, q, k, v, offsets, *, window, mask=None,
                            chunk_tokens=0):
        from repro_torch.core.nsa_causal import local_window_attention_ref
        from repro_torch.kernels.occupancy import segment_ids
        kb, vb = self._rep(q[None], k[None], v[None])
        seg = segment_ids(offsets, q.shape[0], q.device)
        cb = max(chunk_tokens // window, 1) if chunk_tokens else 0
        return local_window_attention_ref(
            q[None], kb, vb, window, mask=None if mask is None else mask[None],
            chunk_blocks=cb, block_seg=seg.reshape(-1, window)[:, 0])[0]

    def selection_varlen(self, q, k, v, top_idx, sel_valid, offsets, mask, *,
                         block_size, group_size, chunk_tokens=0):
        # isolation lives in the scores (other samples' blocks are never
        # picked), so the packed gather-attend is B = 1 selection attention
        return self.selection(q[None], k[None], v[None], top_idx[None], sel_valid[None],
                              None if mask is None else mask[None],
                              block_size=block_size, group_size=group_size,
                              chunk_tokens=chunk_tokens)[0]


class KernelBackend:
    """The hand-written CUDA kernels (``kernels/ops.py``), differentiable:
    on CUDA tensors a backward never answers with a plain version."""

    name = "kernels"

    def ball(self, q, k, v, mask, *, ball_size, chunk_tokens=0):
        from repro_torch.kernels import ops
        return ops.ball_attention(q, k, v, mask, ball_size)

    def flash(self, q, k, v, *, key_valid=None, causal=False, block_causal=False,
              ell=1, chunk_tokens=0, q_valid=None):
        from repro_torch.kernels import ops
        return ops.flash_attention(q, k, v, key_valid=key_valid, causal=causal,
                                   block_causal=block_causal, ell=ell,
                                   q_valid=q_valid)

    def local_window(self, q, k, v, *, window, mask=None, chunk_tokens=0):
        from repro_torch.kernels import ops
        return ops.local_window_attention(q, k, v, window, mask=mask)

    def selection(self, q, k, v, top_idx, sel_valid, mask, *, block_size,
                  group_size, chunk_tokens=0, q_valid=None):
        from repro_torch.kernels import ops
        return ops.selection_attention(q, k, v, top_idx, sel_valid, mask,
                                       block_size=block_size,
                                       group_size=group_size, q_valid=q_valid)

    def paged_gather(self, pool, rows):
        from repro_torch.kernels import ops
        return ops.paged_gather(pool, rows)

    def paged_gather_pair(self, k_pool, v_pool, rows):
        from repro_torch.kernels import ops
        return ops.paged_gather_pair(k_pool, v_pool, rows)

    def gated_combine(self, outs, gates, mask):
        from repro_torch.kernels import ops
        return ops.gated_combine(outs, gates, mask)

    def ball_varlen(self, q, k, v, offsets, mask, *, ball_size, chunk_tokens=0):
        from repro_torch.kernels import ops
        return ops.ball_attention_varlen(q, k, v, offsets, mask, ball_size)

    def flash_varlen(self, q, k, v, q_offsets, k_offsets, *, key_valid=None,
                     chunk_tokens=0):
        from repro_torch.kernels import ops
        return ops.flash_attention_varlen(q, k, v, q_offsets, k_offsets,
                                          key_valid=key_valid)

    def local_window_varlen(self, q, k, v, offsets, *, window, mask=None,
                            chunk_tokens=0):
        from repro_torch.kernels import ops
        return ops.local_window_attention_varlen(q, k, v, offsets, window, mask=mask)

    def selection_varlen(self, q, k, v, top_idx, sel_valid, offsets, mask, *,
                         block_size, group_size, chunk_tokens=0):
        from repro_torch.kernels import ops
        return ops.selection_attention_varlen(q, k, v, top_idx, sel_valid, offsets,
                                              mask, block_size=block_size,
                                              group_size=group_size)


class AutoBackend:
    """Chooses per call by the device of the first tensor argument."""

    name = "auto"

    def __getattr__(self, op):
        if op.startswith("_"):
            raise AttributeError(op)

        def dispatch(first, *args, **kwargs):
            if isinstance(first, (tuple, list)):      # gated_combine(outs, …)
                device = first[0].device
            else:
                device = first.device
            name = "kernels" if device.type == "cuda" else "reference"
            return getattr(_REGISTRY[name], op)(first, *args, **kwargs)
        return dispatch


_REGISTRY: dict = {}
_tls = threading.local()


def register_backend(name: str, backend, *, overwrite: bool = False):
    """Register ``backend`` under ``name``; it then works everywhere a
    backend is named (``BSAConfig``, ``backend_overrides``, ``use_backend``)."""
    if name == "auto":
        raise ValueError('"auto" is reserved (chooses by tensor device)')
    missing = [op for op in REQUIRED_OPS if not callable(getattr(backend, op, None))]
    if missing:
        raise TypeError(f"backend {name!r} is missing ops {missing}")
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {name!r} already registered "
                         "(pass overwrite=True to replace)")
    _REGISTRY[name] = backend
    return backend


def get_backend(name: str):
    if name == "auto":
        return _AUTO
    if name == "sharded" and name not in _REGISTRY:
        # registered on first use: core imports nothing distributed unless
        # the multi-rank backend is asked for
        import repro_torch.distributed.sharded_backend  # noqa: F401
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown attention backend {name!r}; registered: "
                       f"{list_backends()} and 'auto' (${ENV_VAR} and use_backend() "
                       "must name one of these)") from None


def list_backends() -> list[str]:
    return sorted(_REGISTRY)


@contextlib.contextmanager
def use_backend(name: str) -> Iterator:
    """Force backend ``name`` for every branch of every attention call in
    this block (this thread).  Nests; beaten only by the environment
    variable."""
    backend = get_backend(name)          # fail fast on unknown names
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(name)
    try:
        yield backend
    finally:
        stack.pop()


def active_backend() -> str | None:
    """The name forced by the innermost ``use_backend`` of this thread, or
    None.  Autograd runs a CUDA backward on a thread of its own, where no
    ``use_backend`` of the caller is active: code that runs part of a
    forward again in the backward (activation checkpointing) re-enters this
    name there.  The environment variable needs no re-entry: it holds on
    every thread."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def _forced_name() -> str | None:
    """The environment's backend, else this thread's ``use_backend``."""
    return os.environ.get(ENV_VAR) or active_backend()


def resolve_backend_name(name: str | None = None) -> str:
    """Apply the precedence chain to a config-level ``name`` (may be None):
    the environment variable, then ``use_backend``, then ``name``, then
    ``"auto"``."""
    return _forced_name() or name or DEFAULT_BACKEND


def resolve_backend(name=None):
    """The backend object for a config-level ``name`` after the precedence
    chain.  A backend object (anything not a string) passes through
    unchanged, past the overrides, as in JAX."""
    if name is not None and not isinstance(name, str):
        return name
    return get_backend(resolve_backend_name(name))


def resolve_branch_backends(cfg) -> dict:
    """{"ball": backend, "cmp": backend, "slc": backend} for one call: the
    environment variable or an active ``use_backend`` forces all three;
    otherwise ``cfg.backend`` with ``cfg.backend_overrides`` per branch."""
    forced = _forced_name()
    if forced:
        bk = get_backend(forced)
        return {b: bk for b in BRANCH_KEYS}
    base = cfg.backend or DEFAULT_BACKEND
    overrides = dict(cfg.backend_overrides or ())
    return {b: get_backend(overrides.get(b, base)) for b in BRANCH_KEYS}


def get_varlen(backend, op: str):
    """The backend's packed-varlen op ``<op>_varlen`` (``op`` one of
    ``"ball"``, ``"flash"``, ``"local_window"``, ``"selection"``), or the reference backend's
    when a registered backend does not provide it.  The built-ins
    (``reference``, ``kernels``, ``auto``) always answer with their own."""
    name = f"{op}_varlen"
    fn = getattr(backend, name, None)
    if callable(fn):
        return fn
    return getattr(_REGISTRY["reference"], name)


def get_paged_gather(backend):
    """The backend's paged-cache gather of the same rows from a K and a V
    pool, ``paged_gather_pair(k_pool, v_pool, rows) → (k, v)``.  A
    registered backend with only the single-pool ``paged_gather`` gathers
    the pair with two calls of its own; one with neither takes the
    reference backend's."""
    fn = getattr(backend, "paged_gather_pair", None)
    if callable(fn):
        return fn
    single = getattr(backend, "paged_gather", None)
    if callable(single):
        return lambda k_pool, v_pool, rows: (single(k_pool, rows), single(v_pool, rows))
    return _REGISTRY["reference"].paged_gather_pair


_AUTO = AutoBackend()
register_backend("reference", ReferenceBackend())
register_backend("kernels", KernelBackend())
