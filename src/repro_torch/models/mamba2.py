"""Mamba-2 (SSD, state-space duality) mixer layer.

Counterpart of ``repro/models/mamba2.py``.  The chunked SSD algorithm (Dao
& Gu 2024): within a chunk of ``CHUNK`` tokens a quadratic, attention-like
term; across chunks a linear recurrence of the (H, N, P) state, run here
as a Python loop over the chunks where JAX runs ``lax.scan``.  The JAX
einsums that contract three operands are contracted two at a time here,
in an order that never builds a (B, nc, Q, Q, H, P) intermediate: the
(CB ⊙ M) weights first, then one batched product over (b, c, h) with
dt·x; the decay times dt·x first for the chunk states; the inter-chunk
output as C times the entering state, then the decay.  The causal mask is
applied in log space, before the exponential, so the masked entries are
exp(−inf) = 0 and never overflow (their gradients stay finite).

The causal depthwise convolution (width ``ssm_conv``) is a sum of
``ssm_conv`` shifted products over a left-padded input, in fp32: its
backward is plain reductions, so it gives the same bits on every call on
the card.  The one-token decode (``mamba2_decode``) keeps the last
``ssm_conv − 1`` inputs and the fp32 state per slot (``mamba2_cache_init``)
and shares the parameters: decode ≡ forward is tested.  The paper's BSA
does not apply to this attention-free mixer.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import tensor_parallel
from repro_torch.layers.nn import Dense, RMSNorm, dense, row_dense

__all__ = ["CHUNK", "Mamba2", "mamba2_init", "mamba2_apply", "mamba2_cache_init",
           "mamba2_decode"]

CHUNK = 128


def _dims(mcfg):
    d_inner = mcfg.ssm_expand * mcfg.d_model
    H = d_inner // mcfg.ssm_head_dim
    return d_inner, H, mcfg.ssm_head_dim, mcfg.ssm_state


class Mamba2(nn.Module):
    """``in_proj`` (d → z, x, B, C, dt), ``conv_w`` (W, C) and ``conv_b``,
    ``A_log``, ``D``, ``dt_bias`` (H,), the gated ``norm`` and
    ``out_proj``; names and layouts as the JAX pytree's."""

    def __init__(self, mcfg, *, generator: torch.Generator, dtype=torch.float32,
                 device=None):
        super().__init__()
        d = mcfg.d_model
        d_inner, H, P, Ns = _dims(mcfg)
        conv_ch = d_inner + 2 * Ns
        kw = dict(dtype=dtype, device=device)
        self.in_proj = Dense(d, 2 * d_inner + 2 * Ns + H, generator=generator, **kw)
        w = torch.randn((mcfg.ssm_conv, conv_ch), generator=generator,
                        device=generator.device) * 0.1
        self.conv_w = nn.Parameter(w.to(**kw))
        self.conv_b = nn.Parameter(torch.zeros(conv_ch, **kw))
        self.A_log = nn.Parameter(torch.log(torch.linspace(1.0, 16.0, H)).to(**kw))
        self.D = nn.Parameter(torch.ones(H, **kw))
        self.dt_bias = nn.Parameter(torch.zeros(H, **kw))
        self.norm = RMSNorm(d_inner, eps=mcfg.norm_eps, **kw)
        self.out_proj = Dense(d_inner, d, generator=generator, **kw)


def mamba2_init(mcfg, *, generator: torch.Generator, dtype=torch.float32,
                device=None) -> Mamba2:
    return Mamba2(mcfg, generator=generator, dtype=dtype, device=device)


def _split_proj(proj, mcfg):
    d_inner, H, P, Ns = _dims(mcfg)
    return torch.split(proj, [d_inner, d_inner, Ns, Ns, H], dim=-1)   # z, x, B, C, dt


def _conv_train(w: torch.Tensor, b: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Causal depthwise convolution of u (B, S, C) by ``w`` (W, C) and ``b``
    (C,): out[s] = Σ_w u[s − W + 1 + w] · w[w] + b, with zeros before the
    start."""
    w = w.to(u.dtype).float()
    W, S = w.shape[0], u.shape[1]
    pad = F.pad(u.float(), (0, 0, W - 1, 0))
    out = sum(pad[:, i:i + S] * w[i] for i in range(W))
    return out.to(u.dtype) + b.to(u.dtype)


def _gated(g, y, z, mcfg, dtype, statistic=None):
    """The gated RMSNorm of the SSD's output (out_proj's input), gain ``g``
    (``layers.nn.rmsnorm``'s arithmetic).  ``statistic`` (this rank's sum
    of squares → the whole layer's) where ``y`` and ``z`` hold only this
    rank's heads: the mean is then over the whole ``d_inner``."""
    hf = (y * F.silu(z.float()).to(dtype)).float()
    if statistic is None:
        ms = hf.pow(2).mean(dim=-1, keepdim=True)
    else:
        ms = statistic(hf.pow(2).sum(dim=-1, keepdim=True)) / _dims(mcfg)[0]
    return (hf * torch.rsqrt(ms + mcfg.norm_eps)).to(dtype) * g.to(dtype)


def mamba2_apply(p: Mamba2, x: torch.Tensor, mcfg) -> torch.Tensor:
    """x: (B, S, d_model) → (B, S, d_model) by the chunked SSD scan; S must
    be a multiple of the chunk (or shorter than one).

    Where ``in_proj`` and ``out_proj`` are cut over ``model``
    (``distributed/tensor_parallel.py``): in_proj is a column product whose
    outputs (z, x, B, C and dt side by side, which a flat cut does not
    split by heads) are all-gathered; each rank then runs the convolution
    and the scan on its own H / model heads (JAX's ``heads`` constraint on
    the scan's x: z, x and dt of its heads, B and C whole), the gated
    norm's sum of squares summed over ``model``, and out_proj is a row
    product on its heads' columns, the same range as its cut.  Where the
    heads do not divide, the scan runs whole on every rank; a layer with
    only one of the projections cut runs whole on gathered weights."""
    cut = tensor_parallel.cut_dim
    if cut(p.in_proj.w) is None and cut(p.out_proj.w) is None:
        return dense(p.out_proj, _mamba(p, dense(p.in_proj, x), x, mcfg))
    ax = tensor_parallel.axis()
    if cut(p.in_proj.w) != 0 or cut(p.out_proj.w) != 1:
        w = tensor_parallel.whole(ax, p)
        return dense(w.out_proj, _mamba(w, dense(w.in_proj, x), x, mcfg))
    xc = tensor_parallel.copy_to_model(ax, x)
    proj = tensor_parallel.gather_summed(ax, -1, dense(p.in_proj, xc))
    shared = tensor_parallel.shared(ax, p, skip=("in_proj", "out_proj"))
    if _dims(mcfg)[1] % ax.size:
        n = p.out_proj.w.shape[1]
        y = _mamba(shared, proj, x, mcfg)
        return row_dense(p.out_proj, y.narrow(-1, ax.index * n, n))
    return row_dense(p.out_proj, _mamba(shared, proj, x, mcfg, ax=ax))


def _mamba(p, proj, x, mcfg, ax=None) -> torch.Tensor:
    """The convolution, the SSD scan and the gated norm on ``in_proj``'s
    output ``proj`` for the layer input ``x``: out_proj's input.  With
    ``ax`` (the ``model`` axis group; ``p`` the layer's parameters from
    ``tensor_parallel.shared``): this rank's H / model heads only, and
    their columns of out_proj's input."""
    B, S, _ = x.shape
    d_inner, H, P, Ns = _dims(mcfg)
    Q = min(CHUNK, S)
    if S % Q:
        raise ValueError(f"sequence length {S} is not a multiple of the chunk {Q}")
    nc = S // Q

    z, xin, Bm, Cm, dt = _split_proj(proj, mcfg)
    conv_w, conv_b, A_log, D, dt_bias, g = p.conv_w, p.conv_b, p.A_log, p.D, p.dt_bias, p.norm.g
    statistic = None
    if ax is not None:                  # this rank's heads: z, x, dt and their parameters
        H //= ax.size
        h0, c0, n = ax.index * H, ax.index * H * P, H * P
        z, xin, dt = z.narrow(-1, c0, n), xin.narrow(-1, c0, n), dt.narrow(-1, h0, H)
        # the convolution's channels: this rank's of x, then all of B and C
        conv_w, conv_b = (torch.cat([t.narrow(-1, c0, n), t.narrow(-1, d_inner, 2 * Ns)], -1)
                          for t in (conv_w, conv_b))
        A_log, D, dt_bias = (t.narrow(0, h0, H) for t in (A_log, D, dt_bias))
        g, d_inner = g.narrow(0, c0, n), n
        statistic = functools.partial(tensor_parallel.reduce_statistic, ax)
    xBC = F.silu(_conv_train(conv_w, conv_b, torch.cat([xin, Bm, Cm], -1)).float()).to(x.dtype)
    xin, Bm, Cm = torch.split(xBC, [d_inner, Ns, Ns], dim=-1)
    xin = xin.reshape(B, S, H, P)

    A = -torch.exp(A_log.float())                                    # (H,)
    dt = F.softplus(dt.float() + dt_bias.float())                    # (B, S, H)
    loga = dt * A                                                    # log decay
    dtx = xin.float() * dt[..., None]                                # (B, S, H, P)

    cs = torch.cumsum(loga.reshape(B, nc, Q, H), dim=2)              # inclusive
    dtx_c = dtx.reshape(B, nc, Q, H, P)
    B_c = Bm.reshape(B, nc, Q, Ns).float()
    C_c = Cm.reshape(B, nc, Q, Ns).float()

    # intra-chunk: y[i] = Σ_{j≤i} (C_i·B_j) exp(cs_i − cs_j) dtx_j
    CB = torch.matmul(C_c, B_c.transpose(-1, -2))                    # (B, nc, Q, Q)
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]                # (B, nc, Q, Q, H)
    ii = torch.arange(Q, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    M = torch.exp(torch.where(causal, seg, -math.inf))               # masked in log space
    Wt = (CB[..., None] * M).permute(0, 1, 4, 2, 3)                  # (B, nc, H, Q, Q)
    y_intra = torch.matmul(Wt, dtx_c.permute(0, 1, 3, 2, 4))         # (B, nc, H, Q, P)
    y_intra = y_intra.permute(0, 1, 3, 2, 4)                         # (B, nc, Q, H, P)

    # chunk out-states S_c = Σ_j exp(cs_last − cs_j) B_j ⊗ dtx_j: (B, nc, H, N, P)
    decay_out = torch.exp(cs[:, :, -1:, :] - cs)                     # (B, nc, Q, H)
    ddx = (decay_out[..., None] * dtx_c).reshape(B, nc, Q, H * P)
    S_c = torch.matmul(B_c.transpose(-1, -2), ddx)                   # (B, nc, N, H·P)
    S_c = S_c.reshape(B, nc, Ns, H, P).permute(0, 1, 3, 2, 4)
    A_tot = torch.exp(cs[:, :, -1, :])                               # (B, nc, H)

    # inter-chunk recurrence: the state entering each chunk
    h = torch.zeros((B, H, Ns, P), dtype=torch.float32, device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = A_tot[:, c, :, None, None] * h + S_c[:, c]
    h_in = torch.stack(h_in, 1)                                      # (B, nc, H, N, P)

    # inter-chunk output: y_inter[i] = exp(cs_i) · C_i · h_in
    hh = h_in.permute(0, 1, 3, 2, 4).reshape(B, nc, Ns, H * P)
    y_inter = torch.matmul(C_c, hh).reshape(B, nc, Q, H, P) * torch.exp(cs)[..., None]

    y = (y_intra + y_inter).reshape(B, S, H, P)
    y = y + D.float()[None, None, :, None] * xin.float()
    y = y.reshape(B, S, d_inner).to(x.dtype)
    return _gated(g, y, z, mcfg, x.dtype, statistic)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def mamba2_cache_init(mcfg, batch: int, dtype=torch.float32, device=None) -> dict:
    """Per slot: the fp32 state ``h`` (B, H, N, P) and the last W − 1
    convolution inputs ``conv`` (B, W − 1, C) in ``dtype``."""
    d_inner, H, P, Ns = _dims(mcfg)
    return {"h": torch.zeros((batch, H, Ns, P), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, mcfg.ssm_conv - 1, d_inner + 2 * Ns), dtype=dtype,
                                device=device)}


def mamba2_decode(p: Mamba2, x1: torch.Tensor, cache: dict, mcfg) -> tuple:
    """x1: (B, 1, d_model) → ((B, 1, d_model), the updated cache)."""
    B = x1.shape[0]
    d_inner, H, P, Ns = _dims(mcfg)
    z, xin, Bm, Cm, dt = _split_proj(dense(p.in_proj, x1), mcfg)
    u = torch.cat([xin, Bm, Cm], -1)                                 # (B, 1, C)
    win = torch.cat([cache["conv"].to(u.dtype), u], dim=1)           # (B, W, C)
    w = p.conv_w.to(u.dtype)
    xBC = (torch.einsum("bwc,wc->bc", win.float(), w.float()).to(u.dtype)
           + p.conv_b.to(u.dtype))
    xBC = F.silu(xBC.float()).to(x1.dtype)
    xin, Bm, Cm = torch.split(xBC, [d_inner, Ns, Ns], dim=-1)
    xin = xin.reshape(B, H, P)

    A = -torch.exp(p.A_log.float())
    dt1 = F.softplus(dt[:, 0].float() + p.dt_bias.float())          # (B, H)
    a = torch.exp(dt1 * A[None, :])
    dtx = xin.float() * dt1[..., None]                               # (B, H, P)
    b_out = Bm.float()[:, None, :, None] * dtx[:, :, None, :]        # (B, H, N, P)
    h = a[..., None, None] * cache["h"] + b_out
    y = torch.einsum("bn,bhnp->bhp", Cm.float(), h)
    y = y + p.D.float()[None, :, None] * xin.float()
    y = y.reshape(B, 1, d_inner).to(x1.dtype)
    return (dense(p.out_proj, _gated(p.norm.g, y, z, mcfg, x1.dtype)),
            {"h": h, "conv": win[:, 1:]})
