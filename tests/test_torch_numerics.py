"""The port's numerics, precision contract, config and branch math, held
against the JAX package on the same numpy inputs.

Tolerance: fp32 1e-4 per module, bf16 4e-2.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import numerics as j_num
from repro.core import branches as j_br
from repro.core.config import BSAConfig as JBSAConfig
from repro.kernels import common as j_common
from repro_torch import numerics as t_num
from repro_torch.core import branches as t_br
from repro_torch.core.config import BSAConfig
from repro_torch.kernels import common as t_common

F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=4e-2, rtol=4e-2)
B, N, HQ, HKV, D, ELL = 3, 64, 4, 2, 16, 4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _mask():
    m = np.ones((B, N), bool)
    m[1, 41:] = False
    m[2] = False
    return m


def _cfgs(**kw):
    return JBSAConfig(**kw), BSAConfig(**kw)


def test_constants_match():
    assert t_num.NEG_INF == j_num.NEG_INF
    assert t_common.LSE_EMPTY == j_common.LSE_EMPTY


@pytest.mark.parametrize("with_mask", [True, False])
def test_key_padding_bias(with_mask):
    mask = _mask() if with_mask else None
    want = j_num.key_padding_bias(None if mask is None else jnp.asarray(mask), B, N)
    got = t_num.key_padding_bias(None if mask is None else torch.from_numpy(mask), B, N)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_np(got), _np(want))


def test_lse_finalize_and_p_from_lse():
    rng = np.random.default_rng(0)
    m = rng.standard_normal((5, 1)).astype(np.float32)
    l = np.array([[0.0], [1e-35], [1.0], [3.5], [0.2]], np.float32)
    np.testing.assert_allclose(
        _np(t_common.lse_finalize(torch.from_numpy(m), torch.from_numpy(l))),
        _np(j_common.lse_finalize(jnp.asarray(m), jnp.asarray(l))), **F32)
    s = rng.standard_normal((5, 7)).astype(np.float32)
    s[1, 2] = -1e30
    lse = rng.standard_normal((5, 1)).astype(np.float32) + 2
    np.testing.assert_allclose(
        _np(t_common.p_from_lse(torch.from_numpy(s), torch.from_numpy(lse))),
        _np(j_common.p_from_lse(jnp.asarray(s), jnp.asarray(lse))), **F32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_resolve_compute_dtype(dtype):
    jname = j_common.resolve_compute_dtype(str(dtype).replace("torch.", ""))
    assert t_common.resolve_compute_dtype(dtype) == getattr(torch, jname)
    assert t_common.mma_dtype(t_common.resolve_compute_dtype(dtype)) == getattr(
        torch, j_common.mma_dtype(jname))


@pytest.mark.parametrize("kw", [
    dict(ball_size=24), dict(slc_block=4), dict(cmp_block=3, slc_block=3),
    dict(group_size=24), dict(score_dtype="float16"),
    dict(backend_overrides={"bad": "kernels"}),
])
def test_config_validation_matches(kw):
    with pytest.raises(ValueError):
        JBSAConfig(**kw)
    with pytest.raises(ValueError):
        BSAConfig(**kw)


def test_config_defaults_match():
    j, t = JBSAConfig(), BSAConfig()
    for f in dataclasses.fields(t):
        if f.name != "backend":
            assert getattr(t, f.name) == getattr(j, f.name), f.name


@pytest.mark.parametrize("with_mask", [True, False])
def test_phi_apply_and_block_validity(with_mask):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, N, HKV, D)).astype(np.float32)
    pos = (rng.standard_normal((ELL, D)) * 0.02).astype(np.float32)
    mask = _mask() if with_mask else None
    jc, tc = _cfgs(ball_size=16, cmp_block=ELL, slc_block=ELL)
    want = j_br.phi_apply({"pos": jnp.asarray(pos)}, jnp.asarray(x),
                          None if mask is None else jnp.asarray(mask), jc)
    got = t_br.phi_apply(types.SimpleNamespace(pos=torch.from_numpy(pos)),
                         torch.from_numpy(x),
                         None if mask is None else torch.from_numpy(mask), tc)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    bv_j = j_br.block_validity(None if mask is None else jnp.asarray(mask), B, N, ELL)
    bv_t = t_br.block_validity(None if mask is None else torch.from_numpy(mask),
                               B, N, ELL)
    np.testing.assert_array_equal(bv_t.numpy(), np.asarray(bv_j))


@pytest.mark.parametrize("mode", ["scalar", "token"])
def test_gate_values(mode):
    rng = np.random.default_rng(2)
    jc, tc = _cfgs(gate_mode=mode)
    x = rng.standard_normal((B, N, 32)).astype(np.float32)
    if mode == "scalar":
        vals = {b: rng.standard_normal(HQ).astype(np.float32) for b in t_br.BRANCHES}
        jp = {b: jnp.asarray(v) for b, v in vals.items()}
        tp = types.SimpleNamespace(**{b: torch.from_numpy(v) for b, v in vals.items()})
    else:
        w = (rng.standard_normal((32, 3 * HQ)) * 0.5).astype(np.float32)
        b = rng.standard_normal(3 * HQ).astype(np.float32)
        jp = {"proj": {"w": jnp.asarray(w), "b": jnp.asarray(b)}}
        tp = types.SimpleNamespace(proj=types.SimpleNamespace(
            w=torch.from_numpy(w.T.copy()), b=torch.from_numpy(b)))
    want = j_br.gate_values(jp, jc, jnp.asarray(x), HQ)
    got = t_br.gate_values(tp, tc, torch.from_numpy(x), HQ)
    for name in t_br.BRANCHES:
        np.testing.assert_allclose(_np(got[name]), _np(want[name]), **F32)


@pytest.mark.parametrize("score_dtype,tol", [("float32", F32), ("bfloat16", BF16)])
def test_diag_scores(score_dtype, tol):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, N // ELL, HQ, D)).astype(np.float32)
    kc = rng.standard_normal((B, N // ELL, HKV, D)).astype(np.float32)
    want = j_br.diag_scores(jnp.asarray(q), jnp.asarray(kc), HQ // HKV,
                            getattr(jnp, score_dtype))
    got = t_br.diag_scores(torch.from_numpy(q), torch.from_numpy(kc), HQ // HKV,
                           score_dtype)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_sdpa_all_masked_rows_give_zeros():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 3, 8, D)).astype(np.float32)
    k = rng.standard_normal((2, 3, 12, D)).astype(np.float32)
    v = rng.standard_normal((2, 3, 12, D)).astype(np.float32)
    valid = rng.random((2, 1, 1, 12)) > 0.4
    valid[1] = False                                  # every key masked
    jb = j_num.mask_to_bias(jnp.asarray(valid))
    tb = t_num.mask_to_bias(torch.from_numpy(valid))
    want = j_br.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb)
    got, lse = t_br.sdpa(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), tb, return_lse=True)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    assert (_np(got)[1] == 0).all() and np.isfinite(_np(got)).all()
    assert (lse[1] == t_common.LSE_EMPTY).all()


@pytest.mark.parametrize("with_mask", [True, False])
def test_selection_attend(with_mask):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, N, HQ, D)).astype(np.float32)
    k = rng.standard_normal((B, N, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, N, HKV, D)).astype(np.float32)
    G, nb, ks = N // 4, N // ELL, 2
    idx = rng.integers(0, nb, (B, G, HKV, ks)).astype(np.int32)
    sv = rng.random((B, G, HKV, ks)) > 0.2
    mask = _mask() if with_mask else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    want = j_br.selection_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(idx), jnp.asarray(sv), jm, block_size=ELL)
    got = t_br.selection_attend(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), torch.from_numpy(idx),
                                torch.from_numpy(sv), tm, block_size=ELL)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    if with_mask:                                     # dead groups: exact zeros
        assert (_np(got)[2] == 0).all()


@pytest.mark.parametrize("chunk,block_causal_ell", [(0, 0), (16, 0), (0, ELL), (16, ELL)])
def test_chunked_q_attention(chunk, block_causal_ell):
    rng = np.random.default_rng(6)
    L = N // ELL
    q = rng.standard_normal((B, N, HQ, D)).astype(np.float32)
    k = rng.standard_normal((B, L, HQ, D)).astype(np.float32)
    v = rng.standard_normal((B, L, HQ, D)).astype(np.float32)
    kv = _mask().reshape(B, L, ELL).any(-1)
    want = j_br.chunked_q_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    key_valid=jnp.asarray(kv),
                                    block_causal_ell=block_causal_ell, chunk=chunk)
    got = t_br.chunked_q_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), key_valid=torch.from_numpy(kv),
                                   block_causal_ell=block_causal_ell, chunk=chunk)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("with_mask", [True, False])
def test_gated_combine_ref_and_repeat_kv(with_mask):
    rng = np.random.default_rng(7)
    outs = [rng.standard_normal((B, N, HQ, D)).astype(np.float32) for _ in range(3)]
    gates = [rng.random((1, 1, HQ, 1)).astype(np.float32) for _ in range(3)]
    mask = _mask() if with_mask else None
    want = j_br.gated_combine_ref([jnp.asarray(o) for o in outs],
                                  [jnp.asarray(g) for g in gates],
                                  None if mask is None else jnp.asarray(mask))
    got = t_br.gated_combine_ref([torch.from_numpy(o) for o in outs],
                                 [torch.from_numpy(g) for g in gates],
                                 None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    kv = rng.standard_normal((B, N, HKV, D)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(t_br.repeat_kv(torch.from_numpy(kv), 2)),
        _np(j_br.repeat_kv(jnp.asarray(kv), 2)))


_CAUSAL_PATH = ("local_fwd", "local_dq", "local_dkv", "flash_fwd", "flash_dq", "flash_dkv",
                "selection_fwd", "selection_bwd")
_BALL_VARLEN = ("bta_fwd", "bta_bwd", "varlen_fwd", "varlen_dq", "varlen_dkv")


@pytest.mark.parametrize("name", _CAUSAL_PATH + _BALL_VARLEN)
def test_check_cuda_inputs_head_dims(name):
    """head_dim 128 passes the CUDA input check of the causal LM path's
    eight kernels; the ball and packed-varlen kernels refuse it, naming the
    kernel and the head dim.  All take 16, 32 and 64; none takes 96."""
    x = torch.zeros(2, 4, 128)
    for d in (16, 32, 64):
        t_common.check_cuda_inputs(name, data=(x, x), f32=(x,), head_dim=d)
    if name in _CAUSAL_PATH:
        t_common.check_cuda_inputs(name, data=(x, x), f32=(x,), head_dim=128)
    else:
        with pytest.raises(ValueError, match=rf"^{name}: head_dim 128 not built"):
            t_common.check_cuda_inputs(name, data=(x, x), f32=(x,), head_dim=128)
    with pytest.raises(ValueError, match=rf"^{name}: head_dim 96 not built"):
        t_common.check_cuda_inputs(name, data=(x, x), f32=(x,), head_dim=96)


@pytest.mark.parametrize("name", _BALL_VARLEN)
def test_check_cuda_inputs_head_dims_bf16(name):
    """In bf16 the ball kernels also take head_dim 128 (their mma path
    streams 64-key tiles); the packed-varlen kernels still refuse it, and
    fp32 operands keep every kernel at 16-64."""
    x, y = torch.zeros(2, 4, 128, dtype=torch.bfloat16), torch.zeros(2, 4)
    for d in (16, 32, 64):
        t_common.check_cuda_inputs(name, data=(x, x), f32=(y,), head_dim=d)
    if name.startswith("bta_"):
        t_common.check_cuda_inputs(name, data=(x, x), f32=(y,), head_dim=128)
    else:
        with pytest.raises(ValueError, match=rf"^{name}: head_dim 128 not built"):
            t_common.check_cuda_inputs(name, data=(x, x), f32=(y,), head_dim=128)
    with pytest.raises(ValueError, match=rf"^{name}: head_dim 128 not built"):
        t_common.check_cuda_inputs(name, data=(x.float(), x.float()), f32=(y,),
                                   head_dim=128)
