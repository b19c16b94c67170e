"""Pluggable attention-backend registry — the kernel/reference seam.

Counterpart of ``repro/core/backend.py``.  ``bsa_attention`` runs its hot
loops through a backend object with the ops ``ball``, ``flash``,
``selection`` and ``gated_combine``; ``bsa_attention_varlen`` (the packed
layout) through ``ball_varlen``, ``flash_varlen`` and ``selection_varlen``,
resolved by :func:`get_varlen` (the JAX protocol's ``local_window``,
``local_window_varlen`` and ``paged_gather`` belong to later slices of the
port).  Shapes follow ``core``: q (B, N, Hq, D), k/v (B, L, Hkv, D),
GQA-native; the varlen ops take one packed axis, q (T, Hq, D), k/v
(L, Hkv, D), and host ``offsets``.

Built-ins:

  ``"reference"``  plain PyTorch (``core/branches.py``, ``core/bsa.py``,
                   ``kernels/ref.py``) on any device, differentiated by
                   autograd;
  ``"kernels"``    the CUDA kernels through ``kernels/ops.py``, forward and
                   backward (each op is a ``torch.autograd.Function`` whose
                   backward launches the backward kernels; on CPU tensors
                   each runs its kernel's plain versions).  An op without a
                   kernel yet raises ``NotImplementedError``; it never
                   answers with the reference;
  ``"auto"``       chosen by the device of the tensors: CUDA tensors take
                   ``"kernels"``, CPU tensors ``"reference"``.

Resolution (weakest → strongest): ``BSAConfig.backend`` (with
``backend_overrides`` per branch) < ``with use_backend("..."):``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator

__all__ = ["ReferenceBackend", "KernelBackend", "AutoBackend", "DEFAULT_BACKEND",
           "BRANCH_KEYS", "register_backend", "get_backend", "list_backends",
           "use_backend", "resolve_branch_backends", "get_varlen"]

DEFAULT_BACKEND = "auto"
BRANCH_KEYS = ("ball", "cmp", "slc")
REQUIRED_OPS = ("ball", "flash", "selection", "gated_combine")


def _not_ported(op: str, slice_name: str):
    def missing(*args, **kwargs):
        raise NotImplementedError(
            f"{op} has no port yet: it comes with the {slice_name} slice")
    return missing


class _Unported:
    """The JAX protocol's ops that later slices of the port bring."""
    local_window = staticmethod(_not_ported("local_window", "causal LM"))
    paged_gather = staticmethod(_not_ported("paged_gather", "paged decode"))
    local_window_varlen = staticmethod(_not_ported("local_window_varlen", "causal LM"))


class ReferenceBackend(_Unported):
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

    def selection(self, q, k, v, top_idx, sel_valid, mask, *, block_size,
                  group_size, chunk_tokens=0, q_valid=None):
        from repro_torch.core.branches import selection_attend
        return selection_attend(q, k, v, top_idx, sel_valid, mask,
                                block_size=block_size, q_valid=q_valid)

    def gated_combine(self, outs, gates, mask):
        from repro_torch.core.branches import gated_combine_ref
        return gated_combine_ref(outs, gates, mask)

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

    def selection_varlen(self, q, k, v, top_idx, sel_valid, offsets, mask, *,
                         block_size, group_size, chunk_tokens=0):
        # isolation lives in the scores (other samples' blocks are never
        # picked), so the packed gather-attend is B = 1 selection attention
        return self.selection(q[None], k[None], v[None], top_idx[None], sel_valid[None],
                              None if mask is None else mask[None],
                              block_size=block_size, group_size=group_size,
                              chunk_tokens=chunk_tokens)[0]


class KernelBackend(_Unported):
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

    def selection(self, q, k, v, top_idx, sel_valid, mask, *, block_size,
                  group_size, chunk_tokens=0, q_valid=None):
        from repro_torch.kernels import ops
        return ops.selection_attention(q, k, v, top_idx, sel_valid, mask,
                                       block_size=block_size,
                                       group_size=group_size, q_valid=q_valid)

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
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown attention backend {name!r}; registered: "
                       f"{list_backends()} and 'auto'") from None


def list_backends() -> list[str]:
    return sorted(_REGISTRY)


@contextlib.contextmanager
def use_backend(name: str) -> Iterator:
    """Force backend ``name`` for every branch of every attention call in
    this block (this thread).  Nests."""
    backend = get_backend(name)          # fail fast on unknown names
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(name)
    try:
        yield backend
    finally:
        stack.pop()


def resolve_branch_backends(cfg) -> dict:
    """{"ball": backend, "cmp": backend, "slc": backend} for one call: an
    active ``use_backend`` forces all three; otherwise ``cfg.backend`` with
    ``cfg.backend_overrides`` per branch."""
    stack = getattr(_tls, "stack", None)
    if stack:
        bk = get_backend(stack[-1])
        return {b: bk for b in BRANCH_KEYS}
    base = cfg.backend or DEFAULT_BACKEND
    overrides = dict(cfg.backend_overrides or ())
    return {b: get_backend(overrides.get(b, base)) for b in BRANCH_KEYS}


def get_varlen(backend, op: str):
    """The backend's packed-varlen op ``<op>_varlen`` (``op`` one of
    ``"ball"``, ``"flash"``, ``"selection"``), or the reference backend's
    when a registered backend does not provide it.  The built-ins
    (``reference``, ``kernels``, ``auto``) always answer with their own."""
    name = f"{op}_varlen"
    fn = getattr(backend, name, None)
    if callable(fn):
        return fn
    return getattr(_REGISTRY["reference"], name)


_AUTO = AutoBackend()
register_backend("reference", ReferenceBackend())
register_backend("kernels", KernelBackend())
