"""Ring context parallelism: queries stay put, K/V slabs travel.

Counterpart of ``repro/distributed/ring.py``.  Called on this rank's
slabs, with ``axis`` the mesh axis's :class:`~repro_torch.launch.mesh.AxisGroup`
(``mesh.axis_group(name)``):

* :func:`ring_flash`: dense flash attention with q, K and V all sharded
  along the sequence.  Each of the p hops attends the resident K/V slab,
  merges the partial result into running online-softmax statistics
  ``(m, l, acc)`` and passes the slab to the next rank.  Its backward
  (a ``torch.autograd.Function``) saves only ``(out, lse)``, recomputes
  each hop's probabilities from the logsumexp while the slabs make one more
  revolution, and sends the dK/dV accumulators round with them, so they
  arrive home after p rotations: O(L/p) memory both ways.
* Causal hop skipping: with token-causal masking, hop h on rank i holds
  the slab of rank (i − h) mod p, entirely in rank i's future when h > i.
  The (p, p) table of ``occupancy.ring_hop_live`` skips those hops'
  products; the rotation itself still runs on every rank (a collective
  that one rank skipped would hang the others), so the causal ring
  computes p(p+1)/2 of p² hops.
* :func:`ring_selection`: the selection branch with K/V sharded.  Each hop
  re-bases the global top-k block indices to the resident slab
  (``loc = top_idx − src·nb_loc``) and attends only the selections that
  live there; a hop that holds none of this rank's selections skips its
  products (a decision each rank takes on its own data, so again only the
  products are skipped, never the rotation).  Exact, because every global
  block lives on one rank: the hops' partials partition each group's
  selected set.  Differentiated by autograd under one outer
  ``torch.utils.checkpoint`` (non-reentrant, early stop off, so the
  recompute issues every rotation in the forward's order on every rank).

The per-hop partials are plain PyTorch products, as they are plain
``jnp.einsum`` in JAX (outside any Pallas kernel).

Plus the host planner of segment-sharded packed-varlen batches:
:func:`plan_segments` (greedy LPT, cost ∝ nᵢ², LRU-cached on the offsets),
:func:`axis_layout` / :func:`split_tokens` / :func:`merge_tokens`, which
lay a packed axis out as one contiguous padded slab per rank.  After the
re-layout every branch is segment-local, so the varlen ops run per rank on
local offsets with no collective before the output gather.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.distributed import comm
from repro_torch.kernels.occupancy import invalidate_dead_groups
from repro_torch.numerics import NEG_INF, mask_to_bias

__all__ = ["ring_perm", "ring_flash", "ring_selection", "SegmentPlan", "plan_segments",
           "lpt_partition", "round_robin_partition", "axis_layout", "split_tokens",
           "merge_tokens", "lcm"]

_TINY = 1e-20


def ring_perm(p: int) -> list[tuple[int, int]]:
    """The rotation: rank j sends to (j+1) mod p, so after hop h rank i holds
    the slab that rank (i − h) mod p started with."""
    return [(j, (j + 1) % p) for j in range(p)]


def _merge(m, l, acc, m_h, l_h, acc_h):
    """Online-softmax merge of two partial-attention triples (running row
    max, running sum of exp, unnormalised output).  An all-masked partial
    carries m ≤ NEG_INF and l = 0, so it merges as an exact no-op."""
    m_new = torch.maximum(m, m_h)
    a = torch.exp(m - m_new)
    b = torch.exp(m_h - m_new)
    return m_new, a * l + b * l_h, a[..., None] * acc + b[..., None] * acc_h


def _stats(logits):
    """(m, p, l) of fp32 logits: row max, unnormalised probabilities (0 on
    masked keys), their row sum."""
    m = logits.amax(-1)
    p = torch.exp(logits - m[..., None])
    p = torch.where(logits <= NEG_INF / 2, 0.0, p)
    return m, p, p.sum(-1)


# ---------------------------------------------------------------------------
# ring flash
# ---------------------------------------------------------------------------

def _heads(t, rep):
    """(B, n, H, D) → head-major fp32 (B, H·rep, n, D)."""
    t = t.transpose(1, 2).float()
    return t.repeat_interleave(rep, dim=1) if rep > 1 else t


def _hop_bias(kbias, i, src, n, causal):
    """(B, n) travelling key bias plus the token-causal rule on global
    positions (query rank i, key source rank src) → (B, 1, n|1, n)."""
    bias = kbias[:, None, None, :]
    if causal:
        pos = torch.arange(n, device=kbias.device)
        bias = bias + mask_to_bias(src * n + pos[None, :] <= i * n + pos[:, None])[None, None]
    return bias


class RingFlashFn(torch.autograd.Function):
    """Differentiable ring flash in q, k, v (the key bias takes none)."""

    @staticmethod
    def forward(ctx, q, k, v, kbias, axis, causal, live):
        B, n, Hq, D = q.shape
        rep = Hq // k.shape[2]
        i, p = axis.index, axis.size
        qh = q.transpose(1, 2).float()
        kc, vc, bc = k, v, kbias
        m = torch.full((B, Hq, n), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, Hq, n), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, Hq, n, D), dtype=torch.float32, device=q.device)
        for h in range(p):
            if live is None or live[i, h]:
                s = qh @ _heads(kc, rep).transpose(-1, -2) / D ** 0.5
                mh, ph, lh = _stats(s + _hop_bias(bc, i, (i - h) % p, n, causal))
                m, l, acc = _merge(m, l, acc, mh, lh, ph @ _heads(vc, rep))
            if h < p - 1:
                kc, vc, bc = (comm.rotate_plain(t, axis) for t in (kc, vc, bc))
        out = acc / torch.clamp(l, min=_TINY)[..., None]
        lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=_TINY)), NEG_INF)
        ctx.save_for_backward(q, k, v, kbias, out, lse)
        ctx.axis, ctx.causal, ctx.live = axis, causal, live
        return out.transpose(1, 2).to(v.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, kbias, out, lse = ctx.saved_tensors
        axis, causal, live = ctx.axis, ctx.causal, ctx.live
        B, n, Hq, D = q.shape
        Hkv = k.shape[2]
        rep = Hq // Hkv
        i, p = axis.index, axis.size
        scale = D ** -0.5
        qh = q.transpose(1, 2).float()
        doh = do.transpose(1, 2).float()
        delta = (doh * out).sum(-1)                                   # (B, Hq, n)
        kc, vc, bc = k, v, kbias
        dq = torch.zeros((B, Hq, n, D), dtype=torch.float32, device=q.device)
        dk = torch.zeros((B, Hkv, n, D), dtype=torch.float32, device=q.device)
        dv = torch.zeros_like(dk)
        for h in range(p):
            if live is None or live[i, h]:
                kr, vr = _heads(kc, rep), _heads(vc, rep)
                s = qh @ kr.transpose(-1, -2) * scale + _hop_bias(bc, i, (i - h) % p, n,
                                                                   causal)
                ph = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - lse[..., None]))
                dl = ph * (doh @ vr.transpose(-1, -2) - delta[..., None])
                dq = dq + dl @ kr * scale
                dkh = dl.transpose(-1, -2) @ qh * scale
                dvh = ph.transpose(-1, -2) @ doh
                if rep > 1:
                    dkh = dkh.reshape(B, Hkv, rep, n, D).sum(2)
                    dvh = dvh.reshape(B, Hkv, rep, n, D).sum(2)
                dk, dv = dk + dkh, dv + dvh
            # every hop rotates (p in all): the slab, and the dK/dV it
            # gathered on its visits, complete the revolution home
            kc, vc, bc, dk, dv = (comm.rotate_plain(t, axis) for t in (kc, vc, bc, dk, dv))
        return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
                dv.transpose(1, 2).to(v.dtype), None, None, None, None)


def ring_flash(q, k, v, kbias, *, axis, causal: bool = False, live=None):
    """Sequence-sharded flash attention on this rank's slabs.

    q (B, n, Hq, D), k/v (B, n, Hkv, D), kbias (B, n) fp32 additive key
    bias (0 attend, NEG_INF masked): rank ``axis.index``'s slabs of a
    sequence of p·n positions.  ``causal`` applies the token-causal rule on
    global positions; ``live`` is an optional (p, p) hop table
    (``occupancy.ring_hop_live``) that skips dead hops' products.  Returns
    this rank's (B, n, Hq, D) output slab, differentiable in q, k, v."""
    live = None if live is None else np.asarray(live, bool)
    return RingFlashFn.apply(q, k, v, kbias, axis, bool(causal), live)


# ---------------------------------------------------------------------------
# ring selection
# ---------------------------------------------------------------------------

def _take_blocks(x, idx, nb: int):
    """x (B, H, nb, F), idx (B, H, S) → (B, H, S, F): rows of x by index, as
    a one-hot product, whose backward (a product too) sums repeated picks
    in a fixed order, where the backward of an indexed gather would add
    them with atomics."""
    return F.one_hot(idx.long(), nb).to(x.dtype) @ x


def _selection_partial(qh, kc, vc, mc, loc, here, ell):
    """One hop's partial stats.  qh (B, Hkv, G, rep, g, D) fp32 head-major
    grouped queries; kc/vc (B, n, Hkv, D) the resident slab; mc (B, n)
    int32 token validity of the slab; loc (B, G, Hkv, k*) slab-local block
    indices, ``here`` marking the selections resident on this slab."""
    B, n, Hkv, D = kc.shape
    nb = n // ell
    G, k_star = loc.shape[1], loc.shape[-1]
    L = k_star * ell
    ig = torch.where(here, loc, 0).permute(0, 2, 1, 3).reshape(B, Hkv, G * k_star)

    def blocks(t):
        return t.reshape(B, nb, ell, Hkv, D).permute(0, 3, 1, 2, 4).reshape(B, Hkv, nb,
                                                                             ell * D)
    kg = _take_blocks(blocks(kc), ig, nb).reshape(B, Hkv, G, L, D).float()
    vg = _take_blocks(blocks(vc), ig, nb).reshape(B, Hkv, G, L, D).float()
    tv = torch.gather(mc.reshape(B, 1, nb, ell).expand(B, Hkv, nb, ell), 2,
                      ig[..., None].expand(B, Hkv, G * k_star, ell)) > 0
    valid = here.permute(0, 2, 1, 3)[..., None] & tv.reshape(B, Hkv, G, k_star, ell)
    bias = mask_to_bias(valid.reshape(B, Hkv, G, 1, 1, L))
    logits = torch.einsum("bhgrmd,bhgld->bhgrml", qh, kg) / D ** 0.5 + bias
    m, ph, l = _stats(logits)
    return m, l, torch.einsum("bhgrml,bhgld->bhgrmd", ph, vg)


def ring_selection(q, k, v, top_idx, sel_valid, key_valid, q_valid, *, axis,
                   block_size: int, group_size: int):
    """Sequence-sharded selection attention on this rank's slabs.

    q (B, n, Hq, D) local queries; k/v (B, n, Hkv, D) the local K/V slab;
    top_idx/sel_valid (B, G_loc, Hkv, k*) this rank's groups with global
    block indices; key_valid/q_valid (B, n) bool local validity (None: all
    valid).  Returns this rank's (B, n, Hq, D) output slab."""
    ell, g = block_size, group_size
    B, n, Hq, D = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    nb = n // ell
    G = top_idx.shape[1]
    i, p = axis.index, axis.size
    sel_valid = invalidate_dead_groups(sel_valid, q_valid, n)
    mc0 = (torch.ones((B, n), dtype=torch.int32, device=q.device) if key_valid is None
           else key_valid.to(torch.int32))

    def core(q, k, v):
        qh = q.reshape(B, G, g, Hkv, rep, D).permute(0, 3, 1, 4, 2, 5).float()
        m = torch.full((B, Hkv, G, rep, g), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Hkv, G, rep, g, D), dtype=torch.float32, device=q.device)
        kc, vc, mc = k, v, mc0
        for h in range(p):
            loc = top_idx - (i - h) % p * nb
            here = sel_valid & (loc >= 0) & (loc < nb)
            if bool(here.any()):            # skip the products, never the rotation
                m, l, acc = _merge(m, l, acc,
                                   *_selection_partial(qh, kc, vc, mc, loc, here, ell))
            if h < p - 1:
                kc, vc = comm.rotate(axis, kc, vc)
                mc = comm.rotate_plain(mc, axis)
        out = acc / torch.clamp(l, min=_TINY)[..., None]
        out = out.permute(0, 2, 4, 1, 3, 5).reshape(B, n, Hq, D).to(v.dtype)
        return comm.touch(out, q, kc, vc)

    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))):
        return core(q, k, v)
    with set_checkpoint_early_stop(False):
        return checkpoint(core, q, k, v, use_reentrant=False)


# ---------------------------------------------------------------------------
# segment-sharded packed-varlen: LPT planner + axis re-layout
# ---------------------------------------------------------------------------

def lpt_partition(sizes, p: int) -> tuple:
    """Greedy LPT: samples in decreasing cost order (cost ∝ nᵢ²) each go to
    the least-loaded rank.  Returns the rank of each sample."""
    sizes = np.asarray(sizes, np.int64)
    order = np.argsort(-(sizes.astype(np.float64) ** 2), kind="stable")
    loads = np.zeros(p, np.float64)
    assign = np.zeros(len(sizes), np.int64)
    for s in order:
        j = int(np.argmin(loads))
        assign[s] = j
        loads[j] += float(sizes[s]) ** 2
    return tuple(int(a) for a in assign)


def round_robin_partition(sizes, p: int) -> tuple:
    """Sample i → rank i mod p (the baseline LPT beats on skewed batches)."""
    return tuple(i % p for i in range(len(sizes)))


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """A sample → rank assignment of one packed-varlen batch.  Plain tuples
    and ints, so the plan keys the layout cache.  ``cost_balance`` is the
    largest rank's Σnᵢ² over the mean (1.0: perfect)."""

    p: int
    sizes: tuple            # (S,) tokens per sample (trailing 0s: empty)
    assign: tuple           # (S,) rank of each sample

    @property
    def loads(self) -> tuple:
        out = [0] * self.p
        for sz, a in zip(self.sizes, self.assign):
            out[a] += sz
        return tuple(out)

    @property
    def cost_balance(self) -> float:
        cost = [0.0] * self.p
        for sz, a in zip(self.sizes, self.assign):
            cost[a] += float(sz) ** 2
        mean = sum(cost) / self.p
        return max(cost) / mean if mean else 1.0


@functools.lru_cache(maxsize=128)
def plan_segments(offsets: tuple, p: int, partition=lpt_partition) -> SegmentPlan:
    """Assign the samples of a host offsets tuple to ``p`` ranks."""
    sizes = tuple(int(b - a) for a, b in zip(offsets[:-1], offsets[1:]))
    return SegmentPlan(p=p, sizes=sizes, assign=partition(sizes, p))


@functools.lru_cache(maxsize=256)
def axis_layout(plan: SegmentPlan, offsets: tuple, total: int, pad_to: int = 1):
    """Per-rank contiguous re-layout of one packed axis whose samples follow
    ``plan.assign`` (the token axis, or the compression branch's pooled
    block axis); ``total`` is its global capacity.  Returns
    ``(idx, local_offsets, capacity, shift)``:

    * idx (p·capacity,) int32: the global position of each local slot, the
      one-past-end index ``total`` marking padding (a gather reads a zero
      row there, a scatter lands on a row that is cut off);
    * local_offsets (p, S+1) int32: each rank's varlen offsets, repeating
      for the samples it does not own (empty segments);
    * capacity: the per-rank padded length (largest load rounded up to
      ``pad_to``, at least ``pad_to``);
    * shift (S,) int32: local start − global start of each sample.
    """
    starts = np.asarray(offsets[:-1], np.int64)
    ends = np.asarray(offsets[1:], np.int64)
    sizes = ends - starts
    loads = np.zeros(plan.p, np.int64)
    local_start = np.zeros(len(sizes), np.int64)
    for s, a in enumerate(plan.assign):
        local_start[s] = loads[a]
        loads[a] += sizes[s]
    capacity = max(int(loads.max()), 1)
    capacity = -(-capacity // pad_to) * pad_to
    idx = np.full((plan.p, capacity), total, np.int32)
    local_offsets = np.zeros((plan.p, len(offsets)), np.int32)
    for s, a in enumerate(plan.assign):
        idx[a, local_start[s]:local_start[s] + sizes[s]] = np.arange(starts[s], ends[s],
                                                                     dtype=np.int32)
        local_offsets[:, s + 1] = local_offsets[:, s]
        local_offsets[a, s + 1] = local_start[s] + sizes[s]
    shift = (local_start - starts).astype(np.int32)
    return idx.reshape(-1), local_offsets, capacity, shift


def split_tokens(idx, arr, p: int):
    """(T, …) global packed tensor → (p, capacity, …) per-rank slabs by a
    layout's gather index (padding slots read a zero row)."""
    pad = torch.zeros((1,) + tuple(arr.shape[1:]), dtype=arr.dtype, device=arr.device)
    rows = torch.as_tensor(idx, device=arr.device).long()
    return torch.cat([arr, pad])[rows].reshape((p, -1) + tuple(arr.shape[1:]))


def merge_tokens(idx, parts, total: int):
    """(p, capacity, …) per-rank outputs → (T, …) global packed tensor.
    Padding slots land on the cut-off row ``total``; rows no sample owns
    (the capacity tail) come back exactly zero."""
    flat = parts.reshape((-1,) + tuple(parts.shape[2:]))
    out = torch.zeros((total + 1,) + tuple(flat.shape[1:]), dtype=flat.dtype,
                      device=flat.device)
    rows = torch.as_tensor(idx, device=flat.device).long()
    return out.index_copy(0, rows, flat)[:total]


def lcm(a: int, b: int) -> int:
    return abs(a * b) // math.gcd(a, b) if a and b else max(a, b)
