"""Multi-rank attention backend: the ops of an inner backend, sharded.

Counterpart of ``repro/distributed/sharded_backend.py``.  The ``"sharded"``
backend wraps a single-device backend (``"kernels"``, ``"reference"`` or
``"auto"``) and splits the ops of the backend protocol across the ranks of
the mesh activated by :func:`mesh_context` (``sharding.py``, re-exported
here), the distributed analogue of ``use_backend()``::

    dist.init_process_group("nccl")          # torchrun, one card a rank
    with mesh_context(make_local_mesh()), use_backend("sharded"):
        out = bsa_attention(params, q, k, v, cfg=cfg)   # no call-site change

Every rank runs the same program on the same full tensors (the glue
between the ops is replicated: PyTorch has no GSPMD to shard it); each op
takes this rank's shard, runs the inner backend on it, and gathers the
output (``distributed/comm.py``, whose autograd functions carry the
gradients back).  Per op:

* ``ball``: balls are independent, so the sequence splits in ball
  multiples and the inner op runs unchanged on each shard.  No collective
  but the output gather.
* ``local_window``: the sequence splits in window multiples plus a
  one-block halo: each rank receives its left neighbour's last block of
  K/V, so its block 0 can attend the block before it; rank 0 receives
  zeros with an all-False mask, the reference's first-block rule.
* ``flash``: non-causal and block-causal (the compression branch): the
  queries split, the ℓ-times-smaller pooled K/V is used whole on every
  rank (its gradient summed over the ranks).  A block-causal shard runs
  its rows at their global positions: zero query rows ahead of them,
  marked invalid by ``q_valid`` (whole tiles of them, which the kernel
  skips).  Token-causal flash runs :func:`ring.ring_flash`, q, K and V all
  sharded, with the hop table of ``occupancy.ring_hop_live``.
* ``selection``: queries, selections and validity split along the group
  axis and K/V along the sequence: :func:`ring.ring_selection`.
* packed-varlen (``*_varlen``): segment sharding.  A greedy LPT partition
  (cost ∝ nᵢ², :func:`ring.plan_segments`) assigns samples to ranks, the
  packed axis is laid out as one contiguous padded slab per rank, and the
  inner varlen ops run per rank on local offsets: samples never attend
  each other, so there is no collective before the output gather.  The
  offsets must be on the host (they are in the port; device offsets fall
  back with a warning).
* ``gated_combine``: the inner op on the full tensors (replicated glue).

Where an op cannot shard (a dimension or sample size the axis or the op's
granule does not divide; a mesh axis of size 1) it runs the inner backend
unsharded on every rank and warns once per (op, cause): numbers never
change, only the partitioning.  At p = 1 every op passes straight to the
inner backend, as in JAX.

:func:`sharded_paged_decode` runs the paged NSA decode with the pools
partitioned by row: each rank holds one contiguous row block of each pool
(:func:`shard_pools` cuts them), gathers read owned rows and zero-fill the
rest before a sum over the ranks, scatters write owned rows only, and the
compression branch merges each rank's softmax statistics ``(m, l, acc)``
in place of gathering the compressed rows (``REPRO_TORCH_SHARDED_RING_DECODE=0``
gathers them instead).  The inner backend is named by ``inner`` or
``REPRO_TORCH_SHARDED_INNER`` (JAX's ``REPRO_SHARDED_*`` are never read).
"""

from __future__ import annotations

import dataclasses
import os
import warnings

import numpy as np
import torch

from repro_torch.core.backend import (get_backend, get_paged_gather, get_varlen,
                                      list_backends, register_backend)
from repro_torch.distributed import comm, ring
from repro_torch.distributed.sharding import (current_mesh_axis, logical_to_spec,  # noqa: F401
                                              mesh_context)

__all__ = ["ShardedBackend", "RowShards", "mesh_context", "current_mesh_axis",
           "sharded_paged_decode", "shard_pools", "shard_paged_caches", "reset_warnings",
           "INNER_ENV", "RING_DECODE_ENV"]

INNER_ENV = "REPRO_TORCH_SHARDED_INNER"
RING_DECODE_ENV = "REPRO_TORCH_SHARDED_RING_DECODE"

_WARNED: set = set()


def _warn_once(op: str, code: str, detail: str) -> None:
    """Warn once per (op, cause); ``code`` is the stable cause, ``detail``
    may carry shapes."""
    key = (op, code)
    if key not in _WARNED:
        _WARNED.add(key)
        warnings.warn(f"sharded backend: {op} falls back to the inner backend unsharded "
                      f"[{code}] — {detail}", RuntimeWarning, stacklevel=3)


def reset_warnings() -> None:
    """Clear the warn-once registry (test isolation)."""
    _WARNED.clear()


@dataclasses.dataclass(frozen=True)
class ShardedBackend:
    """The inner backend's ops, sharded over the active mesh (see the module
    docstring).  ``inner`` pins the wrapped backend by name; None defers to
    ``$REPRO_TORCH_SHARDED_INNER``, then ``"auto"``.  The mesh is not
    stored: each call reads the ambient :func:`mesh_context`, as
    ``use_backend`` names the backend."""

    name: str = "sharded"
    inner: str | None = None
    requires_mesh = True         # engines fail fast without a mesh_context
    is_sharded_backend = True    # the paged decode's dispatch marker

    def _resolve_inner(self):
        name = os.environ.get(INNER_ENV) or self.inner or "auto"
        if name == "sharded":
            raise ValueError("the sharded backend cannot wrap itself "
                             f"(${INNER_ENV} / inner must name a single-device backend)")
        return get_backend(name)

    def _require_mesh(self, op: str):
        ctx = current_mesh_axis()
        if ctx is None:
            raise RuntimeError(
                f"the 'sharded' backend needs an active mesh to run {op!r}; wrap the "
                "call in\n"
                "    from repro_torch.distributed import mesh_context\n"
                "    from repro_torch.launch.mesh import make_local_mesh\n"
                "    with mesh_context(make_local_mesh()):\n"
                "        ...\n"
                "in every rank of an initialised group "
                "(torch.distributed.init_process_group)")
        return ctx

    def _plan(self, op: str, mesh, axis, n: int, granule: int = 1):
        """This axis's group if dim ``n`` can shard over it with each shard a
        multiple of ``granule``, else None (after a warning once)."""
        p = mesh.shape[axis]
        if p == 1:
            return None
        spec = logical_to_spec(("seq_shard",), (n,), mesh, {"seq_shard": (axis,)})
        if spec[0] is None:
            _warn_once(op, "indivisible-dim", f"dim {n} not divisible by mesh axis "
                                              f"{axis!r}={p}")
            return None
        if (n // p) % granule:
            _warn_once(op, "granule", f"per-shard length {n // p} not a multiple of "
                                      f"granule {granule} (dim {n}, {axis!r}={p})")
            return None
        return mesh.axis_group(axis)

    def _segment_plan(self, op: str, mesh, axis, offsets, granules=()):
        """(axis group, LPT plan, offsets tuple) of a packed-varlen op, or
        None: fall back."""
        from repro_torch.kernels.occupancy import offsets_digest
        p = mesh.shape[axis]
        if p == 1:
            return None
        dig = offsets_digest(offsets)
        if dig is None:
            _warn_once(op, "device-offsets", "offsets are on the device; the LPT segment "
                                             "partition is a host-side decision")
            return None
        sizes = [b - a for a, b in zip(dig[:-1], dig[1:])]
        for gr in granules:
            if gr > 1 and any(sz % gr for sz in sizes):
                _warn_once(op, "granule", f"sample sizes not all multiples of granule {gr}")
                return None
        return mesh.axis_group(axis), ring.plan_segments(dig, p), dig

    # -- dense ops ----------------------------------------------------------

    def ball(self, q, k, v, mask, *, ball_size, chunk_tokens=0):
        mesh, axis = self._require_mesh("ball")
        inner = self._resolve_inner()
        ax = self._plan("ball", mesh, axis, q.shape[1], ball_size)
        if ax is None:
            return inner.ball(q, k, v, mask, ball_size=ball_size, chunk_tokens=chunk_tokens)
        qs, ks, vs = comm.shard(ax, 1, q, k, v)
        out = inner.ball(qs, ks, vs, comm.local_slice(mask, ax, 1), ball_size=ball_size,
                         chunk_tokens=chunk_tokens)
        return comm.gather(ax, 1, out)

    def local_window(self, q, k, v, *, window, mask=None, chunk_tokens=0):
        mesh, axis = self._require_mesh("local_window")
        inner = self._resolve_inner()
        ax = self._plan("local_window", mesh, axis, q.shape[1], window)
        if ax is None:
            return inner.local_window(q, k, v, window=window, mask=mask,
                                      chunk_tokens=chunk_tokens)
        if mask is None:
            mask = torch.ones(q.shape[:2], dtype=torch.bool, device=q.device)
        w = window
        qs, ks, vs = comm.shard(ax, 1, q, k, v)
        ms = comm.local_slice(mask, ax, 1)
        # the halo: the left neighbour's last block (zeros and all-False on
        # rank 0); a zero query block keeps the inner's blocks aligned
        hk, hv = comm.rotate(ax, ks[:, -w:], vs[:, -w:], wrap=False)
        hm = comm.rotate_plain(ms[:, -w:], ax, wrap=False)
        out = inner.local_window(torch.cat([torch.zeros_like(qs[:, :w]), qs], 1),
                                 torch.cat([hk, ks], 1), torch.cat([hv, vs], 1), window=w,
                                 mask=torch.cat([hm, ms], 1), chunk_tokens=chunk_tokens)
        return comm.gather(ax, 1, out[:, w:])

    def flash(self, q, k, v, *, key_valid=None, causal=False, block_causal=False, ell=1,
              chunk_tokens=0, q_valid=None):
        mesh, axis = self._require_mesh("flash")
        inner = self._resolve_inner()
        B, N = q.shape[:2]
        L = k.shape[1]
        if causal:
            # ring flash: the token-causal rule needs aligned q / k axes to
            # place global positions (decode's right-aligned N < L cannot)
            ax = self._plan("flash", mesh, axis, N) if N == L else None
            if N != L:
                _warn_once("flash", "causal-qk-mismatch",
                           f"token-causal q len {N} != k len {L} cannot ring-shard")
            if ax is None:
                return inner.flash(q, k, v, key_valid=key_valid, causal=True,
                                   block_causal=block_causal, ell=ell,
                                   chunk_tokens=chunk_tokens, q_valid=q_valid)
            from repro_torch.kernels.occupancy import ring_hop_live
            from repro_torch.numerics import key_padding_bias
            live = ring_hop_live(ax.size, N // ax.size, causal=True)
            kb = key_padding_bias(key_valid, B, L, device=q.device)
            qs, ks, vs = comm.shard(ax, 1, q, k, v)
            out = ring.ring_flash(qs, ks, vs, comm.local_slice(kb, ax, 1), axis=ax,
                                  causal=True, live=live)
            return comm.gather(ax, 1, out)
        ax = self._plan("flash", mesh, axis, N)
        if ax is None:
            return inner.flash(q, k, v, key_valid=key_valid, block_causal=block_causal,
                               ell=ell, chunk_tokens=chunk_tokens, q_valid=q_valid)
        qs = comm.shard(ax, 1, q)
        qv = comm.local_slice(q_valid, ax, 1)
        # the pooled K/V is T/ℓ small: every rank attends it whole
        kr, vr = comm.replicated(ax, k, v)
        if block_causal:
            # the rule reads global query positions: the shard's rows go in
            # behind i·n invalid zero rows, which the kernel skips by tile
            lead = ax.index * (N // ax.size)
            if qv is None:
                qv = torch.ones(qs.shape[:2], dtype=torch.bool, device=q.device)
            qs = torch.cat([qs.new_zeros((B, lead) + tuple(qs.shape[2:])), qs], 1)
            qv = torch.cat([qv.new_zeros((B, lead)), qv], 1)
            out = inner.flash(qs, kr, vr, key_valid=key_valid, block_causal=True, ell=ell,
                              chunk_tokens=chunk_tokens, q_valid=qv)[:, lead:]
        else:
            out = inner.flash(qs, kr, vr, key_valid=key_valid, ell=ell,
                              chunk_tokens=chunk_tokens, q_valid=qv)
        return comm.gather(ax, 1, out)

    def selection(self, q, k, v, top_idx, sel_valid, mask, *, block_size, group_size,
                  chunk_tokens=0, q_valid=None):
        mesh, axis = self._require_mesh("selection")
        inner = self._resolve_inner()
        N, L, G = q.shape[1], k.shape[1], top_idx.shape[1]
        # K/V shard too, so the sequence splits in block granules and the
        # groups in equal counts
        ax = (self._plan("selection", mesh, axis, N, ring.lcm(block_size, N // G))
              if N == L else None)
        if N != L:
            _warn_once("selection", "qk-mismatch", f"q len {N} != k len {L}; the ring "
                                                   "needs aligned sequence slabs")
        if ax is not None and G % ax.size:
            _warn_once("selection", "groups-indivisible",
                       f"G={G} not divisible by {axis!r}={ax.size}")
            ax = None
        if ax is None:
            return inner.selection(q, k, v, top_idx, sel_valid, mask, block_size=block_size,
                                   group_size=group_size, chunk_tokens=chunk_tokens,
                                   q_valid=q_valid)
        if mask is None:
            mask = torch.ones(q.shape[:2], dtype=torch.bool, device=q.device)
        qv = mask if q_valid is None else q_valid
        qs, ks, vs = comm.shard(ax, 1, q, k, v)
        out = ring.ring_selection(
            qs, ks, vs, comm.local_slice(top_idx, ax, 1), comm.local_slice(sel_valid, ax, 1),
            comm.local_slice(mask, ax, 1), comm.local_slice(qv, ax, 1), axis=ax,
            block_size=block_size, group_size=N // G)
        return comm.gather(ax, 1, out)

    def gated_combine(self, outs, gates, mask):
        # elementwise glue: the inner op on the full tensors, on every rank
        return self._resolve_inner().gated_combine(outs, gates, mask)

    # -- packed-varlen ops: LPT segment sharding ----------------------------

    @staticmethod
    def _split(ax, idx, *arrays):
        """This rank's slab of each packed array (None passes) under a
        layout: (capacity, …) tensors, differentiable."""
        out = []
        for a in arrays:
            if a is None:
                out.append(None)
            elif a.dtype == torch.bool or not a.is_floating_point():
                out.append(comm.local_slice(ring.split_tokens(idx, a, ax.size), ax, 0)[0])
            else:
                out.append(comm.shard(ax, 0, ring.split_tokens(idx, a, ax.size))[0])
        return out

    def ball_varlen(self, q, k, v, offsets, mask, *, ball_size, chunk_tokens=0):
        mesh, axis = self._require_mesh("ball_varlen")
        op = get_varlen(self._resolve_inner(), "ball")
        planned = self._segment_plan("ball_varlen", mesh, axis, offsets,
                                     granules=(ball_size,))
        if planned is None:
            return op(q, k, v, offsets, mask, ball_size=ball_size, chunk_tokens=chunk_tokens)
        ax, plan, dig = planned
        T = q.shape[0]
        idx, loff, _, _ = ring.axis_layout(plan, dig, T, ball_size)
        qs, ks, vs, ms = self._split(ax, idx, q, k, v, mask)
        out = op(qs, ks, vs, loff[ax.index], ms, ball_size=ball_size,
                 chunk_tokens=chunk_tokens)
        return ring.merge_tokens(idx, comm.gather(ax, 0, out[None]), T)

    def flash_varlen(self, q, k, v, q_offsets, k_offsets, *, key_valid=None,
                     chunk_tokens=0):
        """The compression branch's varlen flash, segment-sharded on both
        axes: the pooled key axis is laid out with the query axis's sample
        assignment, so every query's keys are resident (the ring with only
        hop 0 live: no collective)."""
        from repro_torch.kernels.occupancy import offsets_digest
        mesh, axis = self._require_mesh("flash_varlen")
        op = get_varlen(self._resolve_inner(), "flash")
        p = mesh.shape[axis]
        qd, kd = offsets_digest(q_offsets), offsets_digest(k_offsets)
        if p == 1 or qd is None or kd is None:
            if p > 1:
                _warn_once("flash_varlen", "device-offsets", "offsets are on the device; "
                           "the LPT segment partition is a host-side decision")
            return op(q, k, v, q_offsets, k_offsets, key_valid=key_valid,
                      chunk_tokens=chunk_tokens)
        ax = mesh.axis_group(axis)
        plan = ring.plan_segments(qd, p)
        Tq, Lk = q.shape[0], k.shape[0]
        qidx, qloff, _, _ = ring.axis_layout(plan, qd, Tq, 1)
        kidx, kloff, _, _ = ring.axis_layout(plan, kd, Lk, 1)
        qs, = self._split(ax, qidx, q)
        ks, vs, kvs = self._split(ax, kidx, k, v, key_valid)
        out = op(qs, ks, vs, qloff[ax.index], kloff[ax.index], key_valid=kvs,
                 chunk_tokens=chunk_tokens)
        return ring.merge_tokens(qidx, comm.gather(ax, 0, out[None]), Tq)

    def local_window_varlen(self, q, k, v, offsets, *, window, mask=None, chunk_tokens=0):
        mesh, axis = self._require_mesh("local_window_varlen")
        op = get_varlen(self._resolve_inner(), "local_window")
        planned = self._segment_plan("local_window_varlen", mesh, axis, offsets,
                                     granules=(window,))
        if planned is None:
            return op(q, k, v, offsets, window=window, mask=mask, chunk_tokens=chunk_tokens)
        ax, plan, dig = planned
        T = q.shape[0]
        idx, loff, _, _ = ring.axis_layout(plan, dig, T, window)
        qs, ks, vs, ms = self._split(ax, idx, q, k, v, mask)
        out = op(qs, ks, vs, loff[ax.index], window=window, mask=ms,
                 chunk_tokens=chunk_tokens)
        return ring.merge_tokens(idx, comm.gather(ax, 0, out[None]), T)

    def selection_varlen(self, q, k, v, top_idx, sel_valid, offsets, mask, *, block_size,
                         group_size, chunk_tokens=0):
        """Segment-sharded varlen selection: a group's selected blocks lie in
        its own sample (the scores mask the others), hence on its own rank
        after the re-layout; the global block indices only need re-basing
        by the sample's shift.  Sample sizes must be multiples of
        lcm(block, group) so block and group boundaries survive the move."""
        mesh, axis = self._require_mesh("selection_varlen")
        op = get_varlen(self._resolve_inner(), "selection")
        gran = ring.lcm(block_size, group_size)
        planned = self._segment_plan("selection_varlen", mesh, axis, offsets,
                                     granules=(gran,))
        if planned is None:
            return op(q, k, v, top_idx, sel_valid, offsets, mask, block_size=block_size,
                      group_size=group_size, chunk_tokens=chunk_tokens)
        ax, plan, dig = planned
        T, G = q.shape[0], top_idx.shape[0]
        idx, loff, _, shift = ring.axis_layout(plan, dig, T, gran)
        gdig = tuple(o // group_size for o in dig)
        gidx, _, _, _ = ring.axis_layout(plan, gdig, G, gran // group_size)
        # groups [off[s]/g, off[s+1]/g) belong to sample s, whose blocks
        # moved by shift[s]/ℓ
        gshift = np.zeros(G, np.int64)
        for s in range(len(dig) - 1):
            gshift[gdig[s]:gdig[s + 1]] = shift[s] // block_size
        ti = top_idx + torch.as_tensor(gshift, device=top_idx.device)[:, None, None]
        tis, svs = self._split(ax, gidx, ti, sel_valid)
        qs, ks, vs, ms = self._split(ax, idx, q, k, v, mask)
        out = op(qs, ks, vs, tis, svs, loff[ax.index], ms, block_size=block_size,
                 group_size=group_size, chunk_tokens=chunk_tokens)
        return ring.merge_tokens(idx, comm.gather(ax, 0, out[None]), T)


# ---------------------------------------------------------------------------
# Row-partitioned paged decode
# ---------------------------------------------------------------------------

class RowShards(dict):
    """This rank's row block of a paged cache's pools: on an axis of p
    ranks, rank i holds rows [i·r, (i+1)·r) of each global pool of p·r rows
    (:func:`shard_pools`); ``axis`` is that mesh axis's group.  The sharded
    paged decode takes and returns these; a plain dict of pools is a whole,
    unpartitioned cache."""

    def __init__(self, pools: dict, axis):
        super().__init__(pools)
        self.axis = axis

    def copy_block(self, src: int, dst: int, *, page: int, cmp_block: int) -> None:
        """Copy-on-write of pool block ``src`` → ``dst``: the owner of each
        source row sends it (a zero-filled read summed over the ranks), the
        owner of each destination row writes it."""
        ops = _ShardedPoolOps(self.axis, None)
        for name, t in self.items():
            rows = page if name in ("k", "v") else page // cmp_block
            ar = torch.arange(rows, device=t.device)
            ops.scatter_rows(t, dst * rows + ar, ops.gather_rows(t, src * rows + ar))


def shard_pools(cache: dict, mesh, axis: str = "data") -> dict:
    """Cut a paged cache's pools (``k``, ``v``, ``k_cmp``, ``v_cmp``, every
    rank holding the whole) into this rank's row blocks.  Where the axis
    does not divide both row counts, warns once and returns ``cache``
    unchanged (the decode then runs unpartitioned)."""
    p = mesh.shape[axis]
    R, Rc = cache["k"].shape[0], cache["k_cmp"].shape[0]
    if p == 1 or R % p or Rc % p:
        if p > 1:
            _warn_once("paged decode", "pool-rows-indivisible",
                       f"pool rows R={R}/Rc={Rc} not divisible by {axis!r}={p}")
        return cache
    ax = mesh.axis_group(axis)
    return RowShards({name: t[ax.index * (t.shape[0] // p):
                              (ax.index + 1) * (t.shape[0] // p)].clone()
                      for name, t in cache.items()}, ax)


def shard_paged_caches(caches: list, mesh, axis: str = "data") -> list:
    """:func:`shard_pools` on every paged NSA cache of an LM's per-period
    cache list (``api.paged_cache_init``); other state (mamba's, the token
    pools of other attention mechanisms) stays whole on every rank."""
    keys = {"k", "v", "k_cmp", "v_cmp"}
    for pc in caches:
        for pos, c in pc.items():
            if isinstance(c, dict) and set(c) == keys:
                pc[pos] = shard_pools(c, mesh, axis)
    return caches


class _ShardedPoolOps:
    """Row-partitioned pool access of the paged decode (the interface of
    ``core.nsa_causal._DensePoolOps``).

    A rank reads only rows it owns: rows of other ranks read row 0 and are
    zeroed, and the ranks' results are summed (exact: one nonzero
    contributor a row).  Scatters write owned rows only, so no collective.
    ``cmp_attend`` merges per-rank softmax statistics instead of gathering
    the compressed rows (the ring's merge at one hop)."""

    def __init__(self, ax, gather_pair):
        self.ax = ax
        self.inner_pair = gather_pair

    def _local(self, pool, rows):
        r_loc = pool.shape[0]
        li = rows.long() - self.ax.index * r_loc
        owned = (li >= 0) & (li < r_loc)
        return torch.where(owned, li, 0), owned

    def _own(self, pool, rows):
        """Local rows (in ``rows``' dtype, in range) and the owned mask."""
        li, owned = self._local(pool, rows)
        return li.to(rows.dtype), owned

    def gather_rows(self, pool, rows):
        li, owned = self._local(pool, rows)
        return comm.all_reduce_sum(torch.where(_bc(owned, pool), pool[li], 0), self.ax)

    def gather_pair(self, k_pool, v_pool, rows):
        li, owned = self._own(k_pool, rows)
        kg, vg = self.inner_pair(k_pool, v_pool, li)
        z = _bc(owned, k_pool)
        both = torch.stack([torch.where(z, kg, 0), torch.where(z, vg, 0)])
        kg, vg = comm.all_reduce_sum(both, self.ax).unbind(0)
        return kg, vg

    def gather_head(self, pool, rows, head_idx):
        li, owned = self._local(pool, rows)
        g = torch.where(owned[..., None], pool[li, head_idx], 0)
        return comm.all_reduce_sum(g, self.ax)

    def scatter_rows(self, pool, rows, vals):
        li, owned = self._local(pool, rows)
        return pool.index_copy_(0, li[owned], vals[owned].to(pool.dtype))

    def cmp_attend(self, k_pool, v_pool, rows, q1, blk_ok, rep):
        """The compression branch and the selection scores over owned rows:
        each rank attends the compressed rows it holds (others masked) and
        the per-query (m, l, acc) are merged over the ranks, O(B·Hq·D) on
        the wire in place of the O(B·NB·Hkv·D) rows.  Exact up to
        rounding: every row is owned once, so the ranks' partials partition
        the key set.  The scores ride the same local reads."""
        from repro_torch.core.nsa_causal import _cmp_attend_from_rows
        from repro_torch.numerics import NEG_INF, mask_to_bias
        if os.environ.get(RING_DECODE_ENV, "1") == "0":
            return _cmp_attend_from_rows(*self.gather_pair(k_pool, v_pool, rows), q1,
                                         blk_ok, rep)
        B, _, Hq, D = q1.shape
        Hkv = k_pool.shape[1]
        li, owned = self._own(k_pool, rows)
        kl, vl = self.inner_pair(k_pool, v_pool, li)                # (B, NB, Hkv, D)
        qg = q1.reshape(B, Hkv, rep, D).float()
        s = torch.einsum("bkrd,bnkd->bkn", qg, kl.float()) / D ** 0.5
        s = comm.all_reduce_sum(torch.where(owned[:, None, :], s, 0.0), self.ax)
        s = torch.where(blk_ok[:, None, :], s, NEG_INF)
        logits = (torch.einsum("bkrd,bnkd->bkrn", qg, kl.float()) / D ** 0.5
                  + mask_to_bias((blk_ok & owned)[:, None, None, :]))
        m, pw, l = ring._stats(logits)
        acc = torch.einsum("bkrn,bnkd->bkrd", pw, vl.float())
        m_g = comm.all_reduce_max(m, self.ax)
        w = torch.exp(m - m_g)
        l_g = comm.all_reduce_sum(l * w, self.ax)
        acc_g = comm.all_reduce_sum(acc * w[..., None], self.ax)
        return (acc_g / torch.clamp(l_g, min=1e-20)[..., None]).to(v_pool.dtype), s


def _bc(owned, pool):
    """An owned-rows mask broadcast over a gather's (Hkv, D)."""
    return owned.reshape(owned.shape + (1,) * (pool.dim() - 1))


def sharded_paged_decode(backend, params, q1, k1, v1, cache, table, lengths, *, cfg,
                         page, x1=None, step=None):
    """One paged NSA decode step with row-partitioned pools (called by
    ``core.nsa_causal.nsa_causal_decode_paged`` when the resolved backend is
    sharded).  ``cache``: :class:`RowShards` (this rank's row blocks);
    query, table, lengths and parameters are the same on every rank, and
    so is the returned output.  A plain dict of whole pools, or a mesh
    axis of size 1, runs the single-device decode under the inner
    backend."""
    from repro_torch.core import nsa_causal
    mesh, axis = backend._require_mesh("paged decode")
    inner = backend._resolve_inner()
    p = mesh.shape[axis]
    if p == 1 or not isinstance(cache, RowShards):
        if p > 1:
            _warn_once("paged decode", "pools-not-row-sharded",
                       "the pools are whole on every rank (cut them with shard_pools)")
        ops = nsa_causal._DensePoolOps(get_paged_gather(inner))
        return nsa_causal.nsa_causal_decode_paged(params, q1, k1, v1, cache, table, lengths,
                                                  cfg=cfg, page=page, x1=x1, step=step,
                                                  _pool_ops=ops)
    ops = _ShardedPoolOps(mesh.axis_group(axis), get_paged_gather(inner))
    out, pools = nsa_causal.nsa_causal_decode_paged(params, q1, k1, v1, cache, table,
                                                    lengths, cfg=cfg, page=page, x1=x1,
                                                    step=step, _pool_ops=ops)
    return out, RowShards(pools, cache.axis)


if "sharded" not in list_backends():
    register_backend("sharded", ShardedBackend())
