"""The port's backward kernels (their plain versions on the CPU) against
``jax.vjp`` through the JAX Pallas kernels in interpret mode.

Each op of ``repro_torch.kernels.ops`` is differentiated by its
``torch.autograd.Function`` (whose backward runs the kernel's plain version
on CPU tensors) and compared with the JAX ``kernels/ops`` wrapper's VJP on
the same numpy inputs and cotangent.  A second set holds each plain
backward to ``torch.autograd`` through its plain forward, mask modes the
JAX comparison leaves out included.

Shapes of ``tests/test_kernels_grad.py``: B = 1, N = 128, Hkv = 2, rep 1
and 2, D = 32, ball 32, the last N/8 tokens padding.  Tolerances from the
same file: fp32 1e-3; bf16 4e-2, 6e-2 for selection.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro_torch.kernels import bta, epilogue, flash, ops, selection
from repro_torch.kernels.common import row_delta

B, N, HKV, D, BALL = 1, 128, 2, 32, 32
TOL = {"float32": dict(atol=1e-3, rtol=1e-3), "bfloat16": dict(atol=4e-2, rtol=4e-2)}
SEL_TOL = {"float32": TOL["float32"], "bfloat16": dict(atol=6e-2, rtol=6e-2)}


def _mask(n=N):
    m = np.ones((B, n), bool)
    m[:, -n // 8:] = False
    return m


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax_vjp(fn, arrays, cotangent, dtype):
    primals = [jnp.asarray(a).astype(dtype) for a in arrays]
    out, vjp = jax.vjp(fn, *primals)
    return out, vjp(jnp.asarray(cotangent).astype(out.dtype))


def _torch_grads(fn, arrays, cotangent, dtype):
    dt = getattr(torch, dtype)
    leaves = [torch.from_numpy(a).to(dt).requires_grad_(True) for a in arrays]
    out = fn(*leaves)
    out.backward(torch.from_numpy(cotangent).to(out.dtype))
    return out, [t.grad for t in leaves]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close_all(got, want, tol, where=None):
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert np.isfinite(g).all()
        if where is not None:
            g, w = g[where], w[where]
        np.testing.assert_allclose(g, w, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rep", [1, 2])
def test_ball_attention_grads_match_jax(rep, dtype):
    mask = _mask()
    q, k, v, do = _arrays(rep, (B, N, HKV * rep, D), (B, N, HKV, D), (B, N, HKV, D),
                          (B, N, HKV * rep, D))
    _, want = _jax_vjp(lambda q, k, v: j_ops.ball_attention(
        q, k, v, jnp.asarray(mask), BALL, interpret=True), (q, k, v), do, dtype)
    _, got = _torch_grads(lambda q, k, v: ops.ball_attention(
        q, k, v, torch.from_numpy(mask), BALL), (q, k, v), do, dtype)
    _close_all(got, want, TOL[dtype])
    assert (_np(got[1])[:, -N // 8:] == 0).all()      # padded keys: exact zeros


@pytest.mark.parametrize("head_dim", [64, 128])
def test_ball_attention_grads_match_jax_mma_shapes(head_dim):
    """The bf16 mma path's shapes: balls of 256 at D 64 (seamless's encoder)
    and D 128, rep 2, N 512 with the last 64 keys padding."""
    n, m, rep = 512, 256, 2
    mask = _mask(n)
    q, k, v, do = _arrays(head_dim, (B, n, HKV * rep, head_dim), (B, n, HKV, head_dim),
                          (B, n, HKV, head_dim), (B, n, HKV * rep, head_dim))
    assert bta.bta_plan(m, head_dim, rep, torch.bfloat16).path == "mma"
    _, want = _jax_vjp(lambda q, k, v: j_ops.ball_attention(
        q, k, v, jnp.asarray(mask), m, interpret=True), (q, k, v), do, "bfloat16")
    _, got = _torch_grads(lambda q, k, v: ops.ball_attention(
        q, k, v, torch.from_numpy(mask), m), (q, k, v), do, "bfloat16")
    _close_all(got, want, TOL["bfloat16"])
    assert (_np(got[1])[:, -n // 8:] == 0).all()      # padded keys: exact zeros


# (mode, D, rep, dtype): key-bias mode as the compression branch runs it at
# D 32, and the causal LM's modes at head_dim 128 with rep 3 (phi4-mini's
# group of 24 / 8 heads)
_FLASH_CASES = [pytest.param("key_bias", D, rep, dt, id=f"{rep}-{dt}")
                for rep in (1, 2) for dt in ("float32", "bfloat16")]
_FLASH_CASES += [pytest.param(mode, 128, 3, dt, id=f"{mode}-d128-3-{dt}")
                 for mode in ("causal", "block_causal") for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("mode,head_dim,rep,dtype", _FLASH_CASES)
def test_flash_attention_grads_match_jax(mode, head_dim, rep, dtype):
    """Key-bias mode as the compression branch runs it: L = 19 coarse keys
    (a ragged tile edge), the q_valid hint on, padded query rows carrying a
    zero cotangent (the combine masks them).  Causal: L = N keys;
    block-causal: L = N/ℓ pooled keys, ℓ = 8; both with three masked keys
    and no q_valid hint."""
    causal, block_causal, ell = mode == "causal", mode == "block_causal", 8
    L = {"key_bias": 19, "causal": N, "block_causal": N // ell}[mode]
    kv = np.ones((B, L), bool)
    kv[:, 16:19] = mode != "key_bias"                  # key-bias: keys 16-18 masked,
    kv[:, 5:8] = mode == "key_bias"                    # causal modes: keys 5-7
    qv = _mask() if mode == "key_bias" else np.ones((B, N), bool)
    q, k, v, do = _arrays(10 + rep, (B, N, HKV * rep, head_dim), (B, L, HKV, head_dim),
                          (B, L, HKV, head_dim), (B, N, HKV * rep, head_dim))
    do[~qv] = 0.0
    hint = mode == "key_bias"
    kw = dict(causal=causal, block_causal=block_causal, ell=ell)
    _, want = _jax_vjp(lambda q, k, v: j_ops.flash_attention(
        q, k, v, key_valid=jnp.asarray(kv), q_valid=jnp.asarray(qv) if hint else None,
        interpret=True, **kw), (q, k, v), do, dtype)
    _, got = _torch_grads(lambda q, k, v: ops.flash_attention(
        q, k, v, key_valid=torch.from_numpy(kv),
        q_valid=torch.from_numpy(qv) if hint else None, **kw), (q, k, v), do, dtype)
    _close_all(got[:1], want[:1], TOL[dtype], where=qv)
    _close_all(got[1:], want[1:], TOL[dtype])
    assert (_np(got[0])[~qv] == 0).all()               # skipped rows: exact zeros
    dead = ~kv[0]                                      # masked keys: exact zeros
    assert (_np(got[1])[:, dead] == 0).all() and (_np(got[2])[:, dead] == 0).all()


@pytest.mark.parametrize("mode,N,L,ell,D,BH", [
    ("key_bias", 3840, 480, 8, 32, 64),          # shapenet's compression branch
    ("key_bias", 200, 70, 1, 128, 2),            # ragged key edge, D 128
    ("causal", 300, 300, 1, 64, 4),              # five key tiles, the last one ragged
    ("block_causal", 4096, 64, 64, 64, 8),       # the LM train shape
    ("block_causal", 1000, 333, 3, 16, 1),       # ℓ = 3 divides no tile; L ragged
    ("block_causal", 100, 40, 5, 128, 3),        # tiles past N: empty ranges
])
def test_flash_dkv_row_split_plan(mode, N, L, ell, D, BH):
    """``flash_dkv``'s row splits: S ≥ 1, and for every key tile the S
    ranges are disjoint, in order, and cover [the tile's first visible
    position, N) exactly once, each but the last a whole number of row
    tiles; the plan for the card's 132 SMs and a forced S alike."""
    kw = dict(causal=mode == "causal", block_causal=mode == "block_causal", ell=ell)
    S_auto = flash.dkv_splits(N, L, BH, D, **kw)
    assert S_auto >= 1
    bm = flash.dkv_row_tile(D)
    n_kt = -(-L // flash.DKV_KEYS)
    first0 = min(N, flash.first_visible(0, **kw))
    assert S_auto <= max(1, -(-(N - first0) // bm))       # never more splits than row tiles
    assert S_auto == 1 or n_kt * BH * (S_auto - 1) < 4 * 132   # none past ~4 blocks an SM
    for S in (S_auto, 1, 3):
        for kt in range(n_kt):
            ranges = flash.dkv_ranges(kt, S, N, D, **kw)
            assert len(ranges) == S
            first = min(N, flash.first_visible(kt * flash.DKV_KEYS, **kw))
            covered = np.zeros(N, int)
            for lo, hi in ranges:
                assert lo <= hi
                covered[lo:hi] += 1
            assert (covered[first:] == 1).all() and (covered[:first] == 0).all()
            live = [(lo, hi) for lo, hi in ranges if hi > lo]
            assert all(a[1] == b[0] for a, b in zip(live, live[1:]))
            assert all((hi - lo) % bm == 0 for lo, hi in live[:-1])
            # no position before `first` sees any key of the tile
            vis = flash.visible_keys(N, L, device="cpu", **kw)
            if vis is not None:
                tile = vis[:, kt * flash.DKV_KEYS:(kt + 1) * flash.DKV_KEYS]
                assert not tile[:first].any() and (first == N or tile[first].any())


def _selection_case(seed, rep):
    """top-k indices with several groups on one block, invalid selections,
    and (through the mask) an all-padding query group."""
    ell, g, k_star = 4, 4, 3
    nb, G = N // ell, N // g
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(nb)[:k_star] for _ in range(B * G * HKV)])
    idx = idx.reshape(B, G, HKV, k_star).astype(np.int32)
    idx[:, :6, :, 0] = 5                               # six groups pick block 5
    sel_valid = rng.random(idx.shape) > 0.2
    sel_valid[:, 7] = False                            # a group with none valid
    return idx, sel_valid, ell, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rep", [1, 2])
def test_selection_attention_grads_match_jax(rep, dtype):
    mask = _mask()
    idx, sel_valid, ell, g = _selection_case(20 + rep, rep)
    q, k, v, do = _arrays(30 + rep, (B, N, HKV * rep, D), (B, N, HKV, D),
                          (B, N, HKV, D), (B, N, HKV * rep, D))
    kw = dict(block_size=ell, group_size=g)
    _, want = _jax_vjp(lambda q, k, v: j_ops.selection_attention(
        q, k, v, jnp.asarray(idx), jnp.asarray(sel_valid), jnp.asarray(mask),
        interpret=True, **kw), (q, k, v), do, dtype)
    out, got = _torch_grads(lambda q, k, v: ops.selection_attention(
        q, k, v, torch.from_numpy(idx), torch.from_numpy(sel_valid),
        torch.from_numpy(mask), **kw), (q, k, v), do, dtype)
    _close_all(got, want, SEL_TOL[dtype])
    dead = np.zeros((B, N), bool)
    dead[:, 7 * g:8 * g] = True                        # the group with none valid
    dead |= ~mask                                      # all-padding groups
    assert (_np(got[0])[dead] == 0).all() and (_np(out)[dead] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_combine_grads_match_jax(dtype):
    """Scalar per-head gates expanded to rows: their gradient sums back
    through the expand, as through JAX's broadcast."""
    H = 4
    mask = _mask()
    o1, o2, o3, do = _arrays(40, *([(B, N, H, D)] * 4))
    gates = _arrays(41, *([(H,)] * 3))

    def j_fn(o1, o2, o3, g1, g2, g3):
        gs = [jax.nn.sigmoid(g.astype(jnp.float32))[None, None, :, None]
              for g in (g1, g2, g3)]
        return j_ops.gated_combine((o1, o2, o3), gs, jnp.asarray(mask), interpret=True)

    def t_fn(o1, o2, o3, g1, g2, g3):
        gs = [torch.sigmoid(g.float())[None, None, :, None] for g in (g1, g2, g3)]
        return ops.gated_combine((o1, o2, o3), gs, torch.from_numpy(mask))

    _, want = _jax_vjp(j_fn, (o1, o2, o3, *gates), do, dtype)
    _, got = _torch_grads(t_fn, (o1, o2, o3, *gates), do, dtype)
    _close_all(got, want, TOL[dtype])
    assert (_np(got[0])[~mask] == 0).all()


# ---------------------------------------------------------------------------
# each plain backward against torch.autograd through its plain forward
# ---------------------------------------------------------------------------

def _autograd_vs_plain(fwd_plain, bwd_plain, inputs, side, dtype, tol, **kw):
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    o, lse = fwd_plain(*leaves, *side, **kw)
    do = torch.from_numpy(_arrays(50, tuple(o.shape))[0]).to(dtype)
    o.backward(do)
    got = bwd_plain(*inputs, *side, do, lse.detach(), row_delta(do, o.detach()), **kw)
    for g, t in zip(got, leaves):
        assert g.dtype == t.dtype
        torch.testing.assert_close(g.float(), t.grad.float(), **tol)


PLAIN_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
             torch.bfloat16: dict(atol=4e-2, rtol=4e-2)}


def _kernel_layout(seed, dtype, rep, L=N):
    q, k, v = _arrays(seed, (B * HKV, rep, N, D), (B * HKV, L, D), (B * HKV, L, D))
    return [torch.from_numpy(a).to(dtype) for a in (q, k, v)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ball_bwd_plain_is_autograd_of_forward(dtype):
    bias = torch.where(torch.from_numpy(_mask()), 0.0, -1e30).float()
    _autograd_vs_plain(bta.ball_attention_fwd_plain, bta.ball_attention_bwd_plain,
                       _kernel_layout(60, dtype, 2), (bias,), dtype, PLAIN_TOL[dtype],
                       ball_size=BALL, n_heads=HKV)


@pytest.mark.parametrize("mode", ["key_bias", "causal", "block_causal"])
def test_flash_bwd_plain_is_autograd_of_forward(mode):
    L = N if mode == "causal" else 19
    valid = torch.ones(B, L, dtype=torch.bool)
    valid[:, L - 3:] = False
    bias = torch.where(valid, 0.0, -1e30).float()
    kw = dict(n_heads=HKV, causal=mode == "causal", block_causal=mode == "block_causal",
              ell=4)
    _autograd_vs_plain(flash.flash_attention_fwd_plain, flash.flash_attention_bwd_plain,
                       _kernel_layout(61, torch.float32, 2, L), (bias,), torch.float32,
                       PLAIN_TOL[torch.float32], **kw)


def test_selection_bwd_plain_is_autograd_of_forward():
    nb, ell, G, M, k_star = 16, 8, 8, 8, 3
    q, kb, vb = (torch.from_numpy(a) for a in _arrays(
        62, (B, HKV, G, M, D), (B, HKV, nb, ell, D), (B, HKV, nb, ell, D)))
    idx = torch.from_numpy(np.random.default_rng(63).integers(-1, nb, (B, HKV, G, k_star))
                           .astype(np.int32))
    idx[0, 0, :5, 0] = 2                                # duplicates across groups
    tok = torch.zeros(B, nb, ell)
    tok[:, -1, 3:] = -1e30
    _autograd_vs_plain(selection.selection_attention_fwd_plain,
                       selection.selection_attention_bwd_plain, [q, kb, vb],
                       (idx, tok), torch.float32, PLAIN_TOL[torch.float32])


def test_epilogue_bwd_plain_is_autograd_of_forward():
    R = 64
    outs = [torch.from_numpy(a) for a in _arrays(64, *([(R, D)] * 3))]
    gates = [torch.rand(R, generator=torch.Generator().manual_seed(i)) for i in range(3)]
    m = torch.arange(R) % 3 != 0
    leaves = [t.clone().requires_grad_(True) for t in outs + gates]
    # the forward reads a row's gate as (R/H, H) = (R, 1) here and the mask per token
    out = epilogue.gated_combine_fwd_plain(*leaves[:3], *(g[:, None] for g in leaves[3:]), m)
    do = torch.from_numpy(_arrays(65, (R, D))[0])
    out.backward(do)
    got = epilogue.gated_combine_bwd_plain(*outs, *gates, m.float(), do)
    for g, t in zip(got, leaves):
        torch.testing.assert_close(g, t.grad, atol=1e-6, rtol=1e-6)
