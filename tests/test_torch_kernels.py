"""The port's four forward kernels, held against the JAX Pallas kernels.

Each kernel's plain PyTorch version (what the wrapper runs on CPU tensors
and what ``chip_smoke.py`` compares the CUDA kernel with on the card) goes
against the JAX kernel body run in interpret mode on the same numpy
inputs, ``o`` and ``lse`` both.  The layout wrappers of ``kernels/ops.py``
go against ``repro.kernels.ops`` in interpret mode, and the core-layout
oracles of ``kernels/ref.py`` against ``repro.kernels.ref``.

Small shapes: B = 3 samples (one padded, one fully masked), N = 64,
Hq = 4 / Hkv = 2 (rep 2), D = 16, ball 16, ℓ = 4, k* = 2, g = 4.
Tolerances: fp32 1e-4, bf16 4e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bta as j_bta
from repro.kernels import epilogue as j_epi
from repro.kernels import flash as j_flash
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.kernels import selection as j_sel
from repro.kernels.occupancy import key_tile_live as j_key_tile_live
from repro_torch.kernels import bta, epilogue, flash, ops, ref, selection

B, N, HQ, HKV, D = 3, 64, 4, 2, 16
REP = HQ // HKV
BALL, ELL, KSTAR, G_SIZE = 16, 4, 2, 4
NB = N // ELL
TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=4e-2, rtol=4e-2)}


def _mask():
    m = np.ones((B, N), bool)
    m[1, 41:] = False            # a padded sample (tail, as a short cloud)
    m[2] = False                 # a fully masked dummy slot
    return m


def _pair(a, dtype):
    """The same numbers on both sides, rounded once to ``dtype``."""
    j = jnp.asarray(a).astype(dtype)
    t = torch.from_numpy(np.asarray(a)).to(getattr(torch, dtype))
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bias(mask):
    return np.where(mask, 0.0, -1e30).astype(np.float32)


def _close(got, want, dtype, where=None):
    g, w = _np(got), _np(want)
    if where is not None:
        g, w = g[where], w[where]
    np.testing.assert_allclose(g, w, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bta_plain_matches_pallas(dtype):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B * HKV, REP, N, D), np.float32)
    k = rng.standard_normal((B * HKV, N, D), np.float32)
    v = rng.standard_normal((B * HKV, N, D), np.float32)
    kb = _bias(_mask())
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    live = j_key_tile_live(jnp.asarray(kb), BALL).astype(jnp.int32)
    jo, jl = j_bta._fwd_call(jq, jk, jv, jnp.asarray(kb), live, ball_size=BALL,
                             n_heads=HKV, interpret=True, compute=dtype)
    to, tl = bta.ball_attention_fwd(tq, tk, tv, torch.from_numpy(kb),
                                    ball_size=BALL, n_heads=HKV)
    _close(to, jo, dtype)
    _close(tl, jl, dtype)
    assert np.isfinite(_np(to)).all()
    assert (_np(to)[2 * HKV:] == 0).all() and (_np(tl)[2 * HKV:] == 1e30).all()


@pytest.mark.parametrize("head_dim", [64, 128])
def test_bta_plain_matches_pallas_mma_shapes(head_dim):
    """The shapes of the bf16 mma path: balls of 256 at D 64 (seamless's
    encoder) and D 128 (the Pallas kernel's largest head dim), rep 2; two
    samples of 512 positions, the second's ball 1 holding 3 valid keys."""
    rng = np.random.default_rng(head_dim)
    n, m = 512, 256
    q = rng.standard_normal((2 * HKV, REP, n, head_dim), np.float32)
    k = rng.standard_normal((2 * HKV, n, head_dim), np.float32)
    v = rng.standard_normal((2 * HKV, n, head_dim), np.float32)
    mask = np.ones((2, n), bool)
    mask[1, 259:] = False
    kb = _bias(mask)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, "bfloat16") for a in (q, k, v))
    assert bta.bta_plan(m, head_dim, REP, torch.bfloat16).path == "mma"
    live = j_key_tile_live(jnp.asarray(kb), m).astype(jnp.int32)
    jo, jl = j_bta._fwd_call(jq, jk, jv, jnp.asarray(kb), live, ball_size=m,
                             n_heads=HKV, interpret=True, compute="bfloat16")
    to, tl = bta.ball_attention_fwd(tq, tk, tv, torch.from_numpy(kb), ball_size=m,
                                    n_heads=HKV)
    _close(to, jo, "bfloat16")
    _close(tl, jl, "bfloat16")
    assert np.isfinite(_np(to)).all()


@pytest.mark.parametrize("dtype,causal,block_causal,L,n,ell", [
    pytest.param("float32", False, False, NB, N, ELL, id="float32-False-False-16"),
    pytest.param("bfloat16", False, False, NB, N, ELL, id="bfloat16-False-False-16"),
    pytest.param("float32", True, False, N, N, ELL, id="float32-True-False-64"),
    pytest.param("float32", False, True, NB, N, ELL, id="float32-False-True-16"),
    # the LM's pooled keys: ℓ 64, 512 positions against 8 keys; rows t < ℓ
    # see no key (zeros and LSE_EMPTY on both sides)
    pytest.param("bfloat16", False, True, 8, 512, 64, id="bfloat16-False-True-8-ell64"),
])
def test_flash_plain_matches_pallas(dtype, causal, block_causal, L, n, ell):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B * HKV, REP, n, D), np.float32)
    k = rng.standard_normal((B * HKV, L, D), np.float32)
    v = rng.standard_normal((B * HKV, L, D), np.float32)
    kvalid = np.ones((B, L), bool)
    kvalid[1, L // 2 + 1:] = False
    kvalid[2] = False
    kb = _bias(kvalid)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    tq_tile, tk_tile = 16, 8
    live = jnp.ones((B, n // tq_tile, L // tk_tile), jnp.int32)
    jo, jl = j_flash._fwd_call(jq, jk, jv, jnp.asarray(kb), live, n_heads=HKV,
                               tq=tq_tile, tk=tk_tile, causal=causal,
                               block_causal=block_causal, ell=ell,
                               interpret=True, compute=dtype)
    to, tl = flash.flash_attention_fwd(tq, tk, tv, torch.from_numpy(kb),
                                       n_heads=HKV, causal=causal,
                                       block_causal=block_causal, ell=ell)
    _close(to, jo, dtype)
    _close(tl, jl, dtype)
    if block_causal:
        assert (_np(to)[:, :, :ell] == 0).all() and (_np(tl)[:, :, :ell] == 1e30).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_selection_plain_matches_pallas(dtype):
    rng = np.random.default_rng(2)
    G, M = NB, G_SIZE * REP
    q = rng.standard_normal((B, HKV, G, M, D), np.float32)
    kb = rng.standard_normal((B, HKV, NB, ELL, D), np.float32)
    vb = rng.standard_normal((B, HKV, NB, ELL, D), np.float32)
    idx = rng.integers(0, NB, (B, HKV, G, KSTAR)).astype(np.int32)
    idx[rng.random(idx.shape) < 0.25] = -1
    idx[0, 0, 3] = -1                        # a group with no valid selection
    tok = _bias(_mask().reshape(B, NB, ELL))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, kb, vb))
    jo, jl = j_sel._fwd_call(jq, jk, jv, jnp.asarray(idx), jnp.asarray(tok),
                             interpret=True, compute=dtype)
    to, tl = selection.selection_attention_fwd(tq, tk, tv, torch.from_numpy(idx),
                                               torch.from_numpy(tok))
    _close(to, jo, dtype)
    _close(tl, jl, dtype)
    assert (_np(to)[0, 0, 3] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_epilogue_plain_matches_pallas(dtype):
    rng = np.random.default_rng(3)
    R = B * N * HQ
    os_ = [rng.standard_normal((R, D), np.float32) for _ in range(3)]
    gs = [rng.random((R, 1), np.float32) for _ in range(3)]
    m = np.repeat(_mask().reshape(-1), HQ).astype(np.float32)[:, None]
    pairs = [_pair(o, dtype) for o in os_]
    want = j_epi._fwd_call(*(p[0] for p in pairs), *(jnp.asarray(g) for g in gs),
                           jnp.asarray(m), tile=64, interpret=True)
    # the port's kernel reads per-row gates as (B·N, H) and the mask per token
    got = epilogue.gated_combine_fwd(*(p[1] for p in pairs),
                                     *(torch.from_numpy(g).view(B * N, HQ) for g in gs),
                                     torch.from_numpy(_mask().reshape(-1)))
    _close(got, want, dtype)


def _qkv(seed, L=N, dtype="float32"):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, N, HQ, D), np.float32)
    k = rng.standard_normal((B, L, HKV, D), np.float32)
    v = rng.standard_normal((B, L, HKV, D), np.float32)
    return [_pair(a, dtype) for a in (q, k, v)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_ball_attention(dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(4, dtype=dtype)
    mask = _mask()
    want = j_ops.ball_attention(jq, jk, jv, jnp.asarray(mask), BALL, interpret=True)
    got = ops.ball_attention(tq, tk, tv, torch.from_numpy(mask), BALL)
    _close(got, want, dtype)


@pytest.mark.parametrize("L", [NB, NB - 3])          # ragged key edge too
def test_ops_flash_attention(L):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(5, L=L)
    kvalid = np.ones((B, L), bool)
    kvalid[1, 7:] = False
    kvalid[2] = False
    want = j_ops.flash_attention(jq, jk, jv, key_valid=jnp.asarray(kvalid),
                                 tq=16, tk=8, interpret=True)
    got = ops.flash_attention(tq, tk, tv, key_valid=torch.from_numpy(kvalid))
    _close(got, want, "float32")


@pytest.mark.parametrize("causal,block_causal,L", [(True, False, N), (False, True, NB)])
def test_ops_flash_causal_modes(causal, block_causal, L):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(11, L=L)
    want = j_ops.flash_attention(jq, jk, jv, causal=causal, block_causal=block_causal,
                                 ell=ELL, tq=16, tk=8, interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal=causal, block_causal=block_causal,
                              ell=ELL)
    _close(got, want, "float32")
    if causal:
        with pytest.raises(ValueError, match="aligned"):
            ops.flash_attention(tq, tk[:, :NB], tv[:, :NB], causal=True)


def test_ops_flash_q_valid_hint():
    """Rows marked invalid are unspecified; every valid row must agree."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(6, L=NB)
    mask = _mask()
    kvalid = mask.reshape(B, NB, ELL).any(-1)
    want = j_ops.flash_attention(jq, jk, jv, key_valid=jnp.asarray(kvalid),
                                 q_valid=jnp.asarray(mask), tq=16, tk=8,
                                 interpret=True)
    got = ops.flash_attention(tq, tk, tv, key_valid=torch.from_numpy(kvalid),
                              q_valid=torch.from_numpy(mask))
    _close(got, want, "float32", where=mask)


def _selection_inputs(seed, dtype="float32"):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(seed, dtype=dtype)
    rng = np.random.default_rng(seed)
    G = N // G_SIZE
    idx = np.stack([np.stack([rng.permutation(NB)[:KSTAR] for _ in range(HKV)])
                    for _ in range(B * G)]).reshape(B, G, HKV, KSTAR).astype(np.int32)
    sel_valid = rng.random((B, G, HKV, KSTAR)) > 0.2
    return (jq, tq), (jk, tk), (jv, tv), idx, sel_valid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_selection_attention(dtype):
    (jq, tq), (jk, tk), (jv, tv), idx, sv = _selection_inputs(7, dtype)
    mask = _mask()
    want = j_ops.selection_attention(jq, jk, jv, jnp.asarray(idx), jnp.asarray(sv),
                                     jnp.asarray(mask), block_size=ELL,
                                     group_size=G_SIZE, interpret=True)
    got = ops.selection_attention(tq, tk, tv, torch.from_numpy(idx),
                                  torch.from_numpy(sv), torch.from_numpy(mask),
                                  block_size=ELL, group_size=G_SIZE)
    _close(got, want, dtype)


@pytest.mark.parametrize("token_gates", [False, True])
def test_ops_gated_combine(token_gates):
    rng = np.random.default_rng(8)
    outs = [rng.standard_normal((B, N, HQ, D), np.float32) for _ in range(3)]
    shape = (B, N, HQ, 1) if token_gates else (1, 1, HQ, 1)
    gates = [rng.random(shape, np.float32) for _ in range(3)]
    mask = _mask()
    want = j_ops.gated_combine([jnp.asarray(o) for o in outs],
                               [jnp.asarray(g) for g in gates], jnp.asarray(mask),
                               interpret=True)
    got = ops.gated_combine([torch.from_numpy(o) for o in outs],
                            [torch.from_numpy(g) for g in gates],
                            torch.from_numpy(mask))
    _close(got, want, "float32")


@pytest.mark.parametrize("causal,block_causal", [(False, False), (True, False),
                                                 (False, True)])
def test_ref_flash_oracle(causal, block_causal):
    L = N if causal else NB
    (jq, tq), (jk, tk), (jv, tv) = _qkv(9, L=L)
    kvalid = np.ones((B, L), bool)
    kvalid[1, 9:] = False
    rep = lambda t: jnp.repeat(t, REP, axis=2)
    want = j_ref.flash_attention_ref(jq, rep(jk), rep(jv),
                                     key_valid=jnp.asarray(kvalid), causal=causal,
                                     block_causal=block_causal, ell=ELL)
    got, lse = ref.flash_attention_ref(tq, tk, tv, key_valid=torch.from_numpy(kvalid),
                                       causal=causal, block_causal=block_causal,
                                       ell=ELL)
    _close(got, want, "float32")
    assert lse.shape == (B, N, HQ)


def test_ref_selection_and_ball_oracles():
    (jq, tq), (jk, tk), (jv, tv), idx, sv = _selection_inputs(10)
    mask = _mask()
    want = j_ref.selection_attention_ref(jq, jk, jv, jnp.asarray(idx),
                                         jnp.asarray(sv), jnp.asarray(mask),
                                         block_size=ELL, group_size=G_SIZE)
    got, lse = ref.selection_attention_ref(tq, tk, tv, torch.from_numpy(idx),
                                           torch.from_numpy(sv),
                                           torch.from_numpy(mask), block_size=ELL)
    _close(got, want, "float32")
    # the selection oracle's lse is the kernel's lse in the core layout
    _, klse = ops_selection_lse(tq, tk, tv, idx, sv, mask)
    _close(lse, klse, "float32")
    rep = lambda t: jnp.repeat(t, REP, axis=2)
    want_b = j_ref.ball_attention_ref(jq, rep(jk), rep(jv), jnp.asarray(mask), BALL)
    trep = lambda t: t.repeat_interleave(REP, dim=2)
    got_b = ref.ball_attention_ref(tq, trep(tk), trep(tv), torch.from_numpy(mask), BALL)
    _close(got_b, want_b, "float32")


def ops_selection_lse(tq, tk, tv, idx, sv, mask):
    """Run the selection kernel's plain version on the ops layout and bring
    its lse back to (B, N, Hq)."""
    from repro_torch.kernels.occupancy import invalidate_dead_groups
    G = N // G_SIZE
    qg = (tq.reshape(B, G, G_SIZE, HKV, REP, D).permute(0, 3, 1, 2, 4, 5)
            .reshape(B, HKV, G, G_SIZE * REP, D))
    kb = tk.reshape(B, NB, ELL, HKV, D).permute(0, 3, 1, 2, 4)
    vb = tv.reshape(B, NB, ELL, HKV, D).permute(0, 3, 1, 2, 4)
    valid = invalidate_dead_groups(torch.from_numpy(sv), torch.from_numpy(mask), N)
    ii = torch.where(valid, torch.from_numpy(idx), -1).permute(0, 2, 1, 3)
    tok = torch.from_numpy(_bias(mask).reshape(B, NB, ELL))
    o, lse = selection.selection_attention_fwd(qg, kb, vb, ii.int(), tok)
    lse = lse.reshape(B, HKV, G, G_SIZE, REP).permute(0, 2, 3, 1, 4).reshape(B, N, HQ)
    return o, lse
