"""The port's causal LM path against the JAX package, on the CPU.

The blocked local-window kernel's plain version and the paged row gather's
plain version against the Pallas kernels in interpret mode, RoPE,
``nsa_causal_attention`` branch by branch, the paged decode against the
full-sequence forward (a staggered, shuffled-table oracle, as the JAX
suite's) and against JAX's decode (and its four pair gathers a step), and
a 2-layer smoke tinyllama's
``lm_apply`` logits and ``lm_decode_step`` on converted weights.  The same
numpy inputs from a seed go to both packages.  Tolerances: the kernels'
plain versions fp32 1e-5, bf16 4e-2; decode against the forward 2e-5 (the
JAX oracle's); everything else against JAX fp32 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.reduce import smoke_config as j_smoke_config
from repro.core import nsa_causal as j_nsa
from repro.core.backend import use_backend as j_use_backend
from repro.core.config import BSAConfig as JBSAConfig
from repro.kernels import local as j_local
from repro.kernels import ops as j_ops
from repro.kernels.occupancy import key_tile_live as j_key_tile_live
from repro.layers.rope import apply_rope as j_apply_rope
from repro.models import transformer as j_tf
from repro.models.api import model_api as j_model_api
from repro_torch.configs import get_config
from repro_torch.configs.reduce import smoke_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core import nsa_causal as t_nsa
from repro_torch.core.backend import use_backend
from repro_torch.core.config import BSAConfig
from repro_torch.kernels import local as t_local
from repro_torch.kernels import paged as t_paged
from repro_torch.layers.rope import apply_rope
from repro_torch.models import transformer as t_tf
from repro_torch.models.api import model_api

KERNEL_TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
              "bfloat16": dict(atol=4e-2, rtol=4e-2)}
TOL = dict(atol=1e-4, rtol=1e-4)
ORACLE_TOL = dict(atol=2e-5, rtol=0)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


# ---------------------------------------------------------------------------
# kernels: plain versions vs Pallas (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rep,masked,segmented", [(1, False, False), (4, False, False),
                                                  (1, True, True), (4, True, False),
                                                  (4, False, True), (4, True, True)])
def test_local_window_plain_matches_pallas(dtype, rep, masked, segmented):
    B, Hkv, N, w, D = 2, 2, 128, 32, 16
    rng = np.random.default_rng(rep + 2 * masked + 4 * segmented)
    q = rng.standard_normal((B * Hkv, rep, N, D)).astype(np.float32)
    k = rng.standard_normal((B * Hkv, N, D)).astype(np.float32)
    v = rng.standard_normal((B * Hkv, N, D)).astype(np.float32)
    valid = np.ones((B, N), bool)
    if masked:
        valid[0, 50:70] = False                    # a ragged hole
        valid[1, 64:96] = False                    # a fully dead block
    bias = np.where(valid, 0.0, -1e30).astype(np.float32)
    seg = np.array([[0, 0, 1, 1], [0, 1, 1, 2]], np.int32) if segmented else None
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    jseg = None if seg is None else jnp.asarray(seg)
    o_want, lse_want = j_local._fwd_call(
        jq, jk, jv, jnp.asarray(bias),
        jnp.zeros((B, N // w), jnp.int32) if jseg is None else jseg,
        j_key_tile_live(jnp.asarray(bias), w).astype(jnp.int32), window=w,
        n_heads=Hkv, interpret=True, compute=dtype)
    tdt = getattr(torch, dtype)
    o, lse = t_local.local_window_fwd(
        _t(q, tdt), _t(k, tdt), _t(v, tdt), _t(bias), None if seg is None else _t(seg, torch.int32),
        window=w, n_heads=Hkv)
    assert o.dtype == tdt and o.shape == (B * Hkv, rep, N, D)
    np.testing.assert_allclose(_np(o), _np(o_want), **KERNEL_TOL[dtype])
    np.testing.assert_allclose(_np(lse), _np(lse_want), **KERNEL_TOL[dtype])
    # the public JAX entry point (interpret mode) gives the same o
    o_call = j_local.local_window_kernel_call(jq, jk, jv, jnp.asarray(bias), window=w,
                                              n_heads=Hkv, interpret=True, blk_seg=jseg)
    np.testing.assert_allclose(_np(o), _np(o_call), **KERNEL_TOL[dtype])


def test_local_window_cpu_gradient_is_the_plain_versions():
    """On CPU tensors ``LocalWindowFn`` differentiates the plain version."""
    B, Hkv, rep, N, w, D = 1, 2, 2, 64, 16, 16
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g, dtype=torch.float64).float()
               for s in ((B * Hkv, rep, N, D), (B * Hkv, N, D), (B * Hkv, N, D)))
    bias = torch.zeros(B, N)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    t_local.LocalWindowFn.apply(*leaves, bias, None, w, Hkv).square().sum().backward()
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    t_local.local_window_fwd_plain(*ref, bias, window=w, n_heads=Hkv)[0].square().sum().backward()
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad)


@pytest.mark.parametrize("dtype,index", [("float32", torch.int32), ("bfloat16", torch.int32),
                                         ("float32", torch.int64), ("bfloat16", torch.int64)],
                         ids=["float32", "bfloat16", "float32-int64", "bfloat16-int64"])
def test_paged_gather_plain_matches_pallas(dtype, index):
    """int32 and int64 row indices (the decode passes both) against the
    Pallas kernel in interpret mode, with rows past the end, from the end
    and before 0."""
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((40, 2, 16)).astype(np.float32)
    rows = rng.integers(0, 40, (3, 7)).astype(np.int32)
    rows[0, :4] = [40, 57, -1, -45]                # past the end, from the end, before 0
    rows[2, -2:] = [-40, 39]                       # the first row from the end, the last
    jpool = jnp.asarray(pool, getattr(jnp, dtype))
    want = j_ops.paged_gather(jpool, jnp.asarray(rows), interpret=True, force_kernel=True)
    got = t_paged.paged_gather(_t(pool, getattr(torch, dtype)), _t(rows, index))
    assert got.shape == (3, 7, 2, 16)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 40)).astype(np.int32)
    want = j_apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    got = apply_rope(_t(x), _t(pos, torch.int32), 1e4)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# nsa_causal_attention and the decode
# ---------------------------------------------------------------------------

SMOKE = dict(ball_size=32, local_window=32, cmp_block=8, slc_block=8, top_k=2,
             group_size=8, query_cmp_selection=True)
EXACT = dict(SMOKE, group_size=0, query_cmp_selection=False)   # decode == forward


def _nsa_pair(bsa: dict, Hq, Hkv, D, seed=3):
    """(JAX params, port params) of one causal BSA layer, the same weights."""
    jp = j_nsa.nsa_init(jax.random.PRNGKey(seed), JBSAConfig(**bsa), n_heads=Hq,
                        n_kv_heads=Hkv, head_dim=D, d_model=Hq * D)
    tp = t_nsa.nsa_init(BSAConfig(**bsa), n_heads=Hq, n_kv_heads=Hkv, head_dim=D,
                        d_model=Hq * D, generator=torch.Generator().manual_seed(0))
    # the gates start at zero in both: give them values so a wrong branch shows
    jp = jax.tree.map(np.asarray, jp)
    for i, b in enumerate(("ball", "cmp", "slc")):
        jp["gates"][b] = np.linspace(-1, 1, Hq).astype(np.float32) * (i + 1)
    params_from_jax(jp, tp)
    return jp, tp


def _valid_candidates(bsa, N, G, mask):
    """(B, G, NB) bool: blocks a group may pick (strictly past, real, or the
    boosted first block)."""
    ell = bsa["cmp_block"]
    nb = N // ell
    grp_start = np.arange(G) * (N // G)
    causal = (np.arange(nb) * ell + ell - 1)[None, :] < grp_start[:, None]
    blk = mask.reshape(mask.shape[0], nb, ell).any(-1)
    ok = causal[None] & blk[:, None, :]
    ok[:, :, 0] |= causal[None, :, 0]
    return ok


@pytest.mark.parametrize("backend,jax_backend", [("reference", "jnp"),
                                                 ("kernels", "interpret")])
@pytest.mark.parametrize("masked", [False, True])
def test_nsa_causal_attention_matches_jax(backend, jax_backend, masked):
    B, N, Hq, Hkv, D = 2, 128, 4, 1, 16
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, N, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, N, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, N, Hkv, D)).astype(np.float32)
    mask = np.ones((B, N), bool)
    if masked:
        mask[1, 100:] = False                      # a padded tail
    jp, tp = _nsa_pair(SMOKE, Hq, Hkv, D)
    m = mask if masked else None
    with j_use_backend(jax_backend):
        want, waux = j_nsa.nsa_causal_attention(
            jp, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cfg=JBSAConfig(**SMOKE),
            mask=None if m is None else jnp.asarray(m), return_aux=True)
    with use_backend(backend):
        got, aux = t_nsa.nsa_causal_attention(
            tp, _t(q), _t(k), _t(v), cfg=BSAConfig(**SMOKE),
            mask=None if m is None else torch.from_numpy(m), return_aux=True)
    rows = mask[:, :, None, None] if masked else np.ones((1, 1, 1, 1), bool)
    for name in ("local", "cmp", "slc"):
        np.testing.assert_allclose(_np(aux[name]) * rows, _np(waux[name]) * rows, **TOL,
                                   err_msg=name)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    G = aux["indices"].shape[1]
    ok = _valid_candidates(SMOKE, N, G, mask)
    live = mask.reshape(B, G, N // G).any(-1)      # a padding group's picks tie at 0
    ti, wi = aux["indices"].numpy(), np.asarray(waux["indices"])
    for b, g, h in zip(*np.nonzero(live[:, :, None].repeat(ti.shape[2], 2))):
        pick = lambda idx: {int(j) for j in idx if ok[b, g, j]}
        assert pick(ti[b, g, h]) == pick(wi[b, g, h]), (b, g, h)


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        path = f"{prefix}.{key}" if prefix else key
        out.update(_flat(val, path) if isinstance(val, dict) else {path: _np(val)})
    return out


@pytest.mark.parametrize("backend,jax_backend", [("reference", "jnp"),
                                                 ("kernels", "interpret")])
def test_nsa_causal_attention_grads_match_jax_head_dim_128(backend, jax_backend):
    """phi4-mini's head layout (24 query heads on 8 KV heads of 128: rep 3,
    D 128) cut to one KV head at N = 128 with a padded tail: the output and
    the gradients of q, k, v and of every parameter against ``jax.vjp`` on
    converted weights (the padded rows carry a zero cotangent)."""
    B, N, Hq, Hkv, D = 1, 128, 3, 1, 128
    rng = np.random.default_rng(8)
    q = rng.standard_normal((B, N, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, N, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, N, Hkv, D)).astype(np.float32)
    do = rng.standard_normal((B, N, Hq, D)).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[0, 112:] = False
    do[~mask] = 0.0
    jp, tp = _nsa_pair(SMOKE, Hq, Hkv, D)
    jcfg = JBSAConfig(**SMOKE)

    def attend(params, q, k, v):
        return j_nsa.nsa_causal_attention(params, q, k, v, cfg=jcfg, mask=jnp.asarray(mask))
    with j_use_backend(jax_backend):
        want, vjp = jax.vjp(attend, jax.tree.map(jnp.asarray, jp), *map(jnp.asarray, (q, k, v)))
        jgrads = vjp(jnp.asarray(do))
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    with use_backend(backend):
        got = t_nsa.nsa_causal_attention(tp, *leaves, cfg=BSAConfig(**SMOKE),
                                         mask=torch.from_numpy(mask))
        got.backward(_t(do))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for name, leaf, w in zip("qkv", leaves, jgrads[1:]):
        np.testing.assert_allclose(_np(leaf.grad), _np(w), err_msg=name, **TOL)
    g, w = _flat(params_to_jax(tp, grads=True)), _flat(jgrads[0])
    assert sorted(g) == sorted(w)
    for name in w:
        np.testing.assert_allclose(g[name], w[name], err_msg=name, **TOL)


def _staggered_decode(decode_step, q, k, v, B, page, n_pages, num_blocks, lens, starts):
    """Drive a paged decode over three staggered slots with a shuffled block
    table (the JAX suite's oracle); returns {(slot, pos): out row}."""
    blocks = np.random.default_rng(0).permutation(num_blocks)
    table = np.full((B, n_pages), num_blocks, np.int32)
    next_blk, outs = 0, {}
    for t in range(max(s + n for s, n in zip(starts, lens))):
        for s in range(B):
            pos = t - starts[s]
            if 0 <= pos < lens[s] and pos % page == 0:
                table[s, pos // page] = blocks[next_blk]
                next_blk += 1
        active = [s for s in range(B) if 0 <= t - starts[s] < lens[s]]
        pos = np.minimum([max(t - starts[s], 0) for s in range(B)], np.array(lens) - 1)
        lengths = np.where([s in active for s in range(B)], pos, 0).astype(np.int32)
        rows = np.arange(B)
        out = decode_step(q[rows, pos][:, None], k[rows, pos][:, None],
                          v[rows, pos][:, None], table.copy(), lengths)
        for s in active:
            outs[s, int(pos[s])] = _np(out[s, 0])
    return outs


@pytest.mark.parametrize("backend", ["reference", "kernels"])
def test_paged_decode_matches_forward_and_jax(backend):
    B, Hq, Hkv, D = 3, 4, 2, 16
    page, n_pages, num_blocks, N_pad = 32, 4, 12, 128
    lens, starts = [96, 64, 33], [0, 17, 41]
    rng = np.random.default_rng(7)
    q = rng.standard_normal((B, N_pad, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, N_pad, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, N_pad, Hkv, D)).astype(np.float32)
    jp, tp = _nsa_pair(EXACT, Hq, Hkv, D)
    cfg, jcfg = BSAConfig(**EXACT), JBSAConfig(**EXACT, backend="jnp")
    with use_backend(backend):
        ref = _np(t_nsa.nsa_causal_attention(tp, _t(q), _t(k), _t(v), cfg=cfg))
        cache = t_nsa.init_paged_decode_cache(num_blocks, page, Hkv, D, cfg,
                                              dtype=torch.float32)

        def step(q1, k1, v1, table, lengths):
            out, _ = t_nsa.nsa_causal_decode_paged(
                tp, _t(q1), _t(k1), _t(v1), cache, torch.from_numpy(table),
                torch.from_numpy(lengths), cfg=cfg, page=page)
            return out
        got = _staggered_decode(step, q, k, v, B, page, n_pages, num_blocks, lens, starts)

    jcache = [j_nsa.init_paged_decode_cache(num_blocks, page, Hkv, D, jcfg,
                                            dtype=jnp.float32)]
    jstep = jax.jit(lambda p, a, b, c, cc, tt, ll: j_nsa.nsa_causal_decode_paged(
        p, a, b, c, cc, tt, ll, cfg=jcfg, page=page))

    def jax_step(q1, k1, v1, table, lengths):
        out, jcache[0] = jstep(jp, q1, k1, v1, jcache[0], table, lengths)
        return out
    want = _staggered_decode(jax_step, q, k, v, B, page, n_pages, num_blocks, lens, starts)
    assert got.keys() == want.keys() and len(got) == sum(lens)
    for (s, p), row in got.items():
        np.testing.assert_allclose(row, ref[s, p], **ORACLE_TOL, err_msg=f"slot {s} pos {p}")
        np.testing.assert_allclose(row, want[s, p], **TOL, err_msg=f"slot {s} pos {p}")


def test_paged_decode_gathers_kv_pairs_and_matches_jax(monkeypatch):
    """Each step of the paged decode on the kernels backend (their plain
    versions here) fetches its four row sets (φ-block, completed compressed
    row, local window, compressed rows) with one ``paged_gather_pair`` call
    each and no single-pool gather, and equals JAX's
    ``nsa_causal_decode_paged`` step for step."""
    B, Hq, Hkv, D = 3, 4, 2, 16
    page, n_pages, num_blocks, N_pad = 32, 4, 12, 64
    lens, starts = [40, 33, 9], [0, 5, 30]
    rng = np.random.default_rng(9)
    q = rng.standard_normal((B, N_pad, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, N_pad, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, N_pad, Hkv, D)).astype(np.float32)
    jp, tp = _nsa_pair(SMOKE, Hq, Hkv, D)
    cfg, jcfg = BSAConfig(**SMOKE), JBSAConfig(**SMOKE, backend="jnp")
    calls = {"pair": 0, "single": 0}
    pair, single = t_paged.paged_gather_pair, t_paged.paged_gather

    def count(key, fn):
        def spy(*args):
            calls[key] += 1
            return fn(*args)
        return spy

    monkeypatch.setattr(t_paged, "paged_gather_pair", count("pair", pair))
    monkeypatch.setattr(t_paged, "paged_gather", count("single", single))
    per_step = []
    with use_backend("kernels"):
        cache = t_nsa.init_paged_decode_cache(num_blocks, page, Hkv, D, cfg,
                                              dtype=torch.float32)

        def step(q1, k1, v1, table, lengths):
            before = calls["pair"]
            out, _ = t_nsa.nsa_causal_decode_paged(
                tp, _t(q1), _t(k1), _t(v1), cache, torch.from_numpy(table),
                torch.from_numpy(lengths), cfg=cfg, page=page)
            per_step.append(calls["pair"] - before)
            return out
        got = _staggered_decode(step, q, k, v, B, page, n_pages, num_blocks, lens, starts)
    assert set(per_step) == {4} and calls["single"] == 0

    jcache = [j_nsa.init_paged_decode_cache(num_blocks, page, Hkv, D, jcfg,
                                            dtype=jnp.float32)]
    jstep = jax.jit(lambda p, a, b, c, cc, tt, ll: j_nsa.nsa_causal_decode_paged(
        p, a, b, c, cc, tt, ll, cfg=jcfg, page=page))

    def jax_step(q1, k1, v1, table, lengths):
        out, jcache[0] = jstep(jp, q1, k1, v1, jcache[0], table, lengths)
        return out
    want = _staggered_decode(jax_step, q, k, v, B, page, n_pages, num_blocks, lens, starts)
    assert got.keys() == want.keys() and len(got) == sum(lens)
    for (s, p), row in got.items():
        np.testing.assert_allclose(row, want[s, p], **TOL, err_msg=f"slot {s} pos {p}")


def test_dense_decode_is_the_degenerate_paged_layout():
    B, N, Hq, Hkv, D = 2, 64, 4, 2, 16
    rng = np.random.default_rng(8)
    q, k, v = (_t(rng.standard_normal((B, N, h, D)).astype(np.float32))
               for h in (Hq, Hkv, Hkv))
    _, tp = _nsa_pair(EXACT, Hq, Hkv, D)
    cfg = BSAConfig(**EXACT)
    ref = t_nsa.nsa_causal_attention(tp, q, k, v, cfg=cfg)
    cache = t_nsa.init_decode_cache(B, N, Hkv, D, cfg, dtype=torch.float32)
    for t in range(N):
        out, cache = t_nsa.nsa_causal_decode(tp, q[:, t:t + 1], k[:, t:t + 1],
                                             v[:, t:t + 1], cache, cfg=cfg)
        np.testing.assert_allclose(_np(out[:, 0]), _np(ref[:, t]), **ORACLE_TOL,
                                   err_msg=f"pos {t}")
    assert int(cache["length"]) == N


# ---------------------------------------------------------------------------
# the smoke tinyllama: lm_apply and lm_decode_step on converted weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_lm():
    jcfg = j_smoke_config(j_get_config("tinyllama-1.1b"))
    jcfg = jcfg.scaled(bsa=dataclasses.replace(jcfg.bsa, backend="jnp"))
    jp = j_model_api(jcfg).init(jax.random.PRNGKey(0))
    tcfg = smoke_config(get_config("tinyllama-1.1b"))
    assert (tcfg.n_layers, tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads, tcfg.head_dim,
            tcfg.vocab_size) == (jcfg.n_layers, jcfg.d_model, jcfg.n_heads,
                                 jcfg.n_kv_heads, jcfg.head_dim, jcfg.vocab_size)
    api = model_api(tcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jp), api.init(1, device="cpu"))
    return jcfg, jp, tcfg, api, model


@pytest.mark.parametrize("backend", ["reference", "kernels"])
def test_lm_apply_matches_jax(smoke_lm, backend):
    jcfg, jp, tcfg, api, model = smoke_lm
    toks = np.random.default_rng(9).integers(0, tcfg.vocab_size, (2, 64)).astype(np.int32)
    want, _ = j_tf.lm_apply(jp, jnp.asarray(toks), mcfg=jcfg)
    with use_backend(backend):
        got = api.forward(model, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 64, tcfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_lm_decode_step_matches_jax(smoke_lm):
    jcfg, jp, tcfg, api, model = smoke_lm
    B, S, T = 2, 96, 70                            # past two local windows
    toks = np.random.default_rng(10).integers(0, tcfg.vocab_size, (B, T)).astype(np.int32)
    jcache = j_tf.lm_cache_init(jcfg, B, S, jnp.float32)
    jstep = jax.jit(lambda p, tok, c: j_tf.lm_decode_step(p, tok, c, mcfg=jcfg))
    caches = api.cache_init(B, S, torch.float32, device="cpu")
    for t in range(T):
        want, jcache = jstep(jp, jnp.asarray(toks[:, t]), jcache)
        got, caches = api.decode_step(model, torch.from_numpy(toks[:, t]), caches)
        np.testing.assert_allclose(_np(got), _np(want), **TOL, err_msg=f"step {t}")
    paged = t_tf.lm_paged_cache_init(tcfg, B, 6, 32, torch.float32)
    assert len(paged) == tcfg.n_layers and set(paged[0]) == {"pos0"}


def test_paged_decode_layer_input_feeds_each_layer(smoke_lm, monkeypatch):
    """``lm_paged_decode_step(layer_input=)``: the identity leaves the step's
    bits alone; feeding each layer the forward's input at the slot's
    position (per-token selection, the decode's) gives the forward's logits."""
    _, _, tcfg, _, model = smoke_lm
    xcfg = tcfg.scaled(bsa=dataclasses.replace(tcfg.bsa, group_size=0,
                                               query_cmp_selection=False))
    B, T, page = 2, 96, 32                         # past two local windows
    toks = torch.from_numpy(
        np.random.default_rng(11).integers(0, tcfg.vocab_size, (B, T)).astype(np.int32))
    inputs, lm_layer = [], t_tf.lm_layer

    def tap(lp, x, **kw):
        inputs.append(x)
        return lm_layer(lp, x, **kw)

    with torch.no_grad():
        with monkeypatch.context() as m:
            m.setattr(t_tf, "lm_layer", tap)
            ref = model_api(xcfg).forward(model, {"tokens": toks})
        assert len(inputs) == tcfg.n_layers
        table = torch.arange(B * 3, dtype=torch.int32).reshape(B, 3)
        runs, calls = [], []
        for hook in (None, lambda i, x: x, "forward"):
            caches = t_tf.lm_paged_cache_init(xcfg, B, B * 3, page, torch.float32)
            out = []
            for t in range(T):
                lengths = torch.full((B,), t)

                def forced(i, x, t=t):
                    calls.append(i)
                    return inputs[i][:, t:t + 1]
                lg, caches = t_tf.lm_paged_decode_step(
                    model, toks[:, t], caches, table, lengths, mcfg=xcfg, page=page,
                    layer_input=forced if hook == "forward" else hook)
                out.append(lg)
            runs.append(torch.stack(out, 1))
    assert torch.equal(runs[0], runs[1])
    assert calls == list(range(tcfg.n_layers)) * T
    np.testing.assert_allclose(_np(runs[2]), _np(ref), **ORACLE_TOL)


def test_convert_round_trips_the_lm_tree(smoke_lm):
    _, jp, _, _, model = smoke_lm
    from repro_torch.convert import params_to_jax
    want = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jp))
    got = dict(jax.tree_util.tree_leaves_with_path(params_to_jax(model)))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf, err_msg=jax.tree_util.keystr(path))
    with pytest.raises(ValueError, match="shape"):
        bad = jax.tree.map(np.asarray, jp)
        bad["lm_head"]["w"] = bad["lm_head"]["w"][:, :-1]
        params_from_jax(bad, model)
