"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: without a card every test here skips (decided inside the
fixture, never at import).  On a machine with an H100 run them with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py``.
Small shapes with rep 2, one padded sample and one fully masked slot (the
varlen kernels: four clouds packed with a capacity tail and a dead block).
Each backward kernel gets the same (inputs, dO, lse, δ) as its plain
version.  Tolerance: fp32 1e-4, bf16 4e-2 (6e-2 for the selection
backward, as the JAX suite's bf16 gradient tolerances).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

B, N, HQ, HKV, D = 3, 64, 4, 2, 16
REP = HQ // HKV
BALL, ELL = 16, 4
NB = N // ELL
TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=4e-2, rtol=4e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _mask(dev):
    m = torch.ones(B, N, dtype=torch.bool, device=dev)
    m[1, 41:] = False
    m[2] = False
    return m


def _bias(mask):
    return torch.where(mask, 0.0, -1e30).float()


def _rand(shape, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype=dtype, device=dev)


def _check(kernel_out, plain_out, dtype, tol=None):
    for got, want in zip(kernel_out, plain_out):
        assert got.dtype == want.dtype and torch.isfinite(got.float()).all()
        torch.testing.assert_close(got.float(), want.float(), **(tol or TOL[dtype]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bta_kernel(cuda, dtype):
    from repro_torch.kernels import bta
    q = _rand((B * HKV, REP, N, D), dtype, cuda, 0)
    k = _rand((B * HKV, N, D), dtype, cuda, 1)
    v = _rand((B * HKV, N, D), dtype, cuda, 2)
    kb = _bias(_mask(cuda))
    before = bta.COUNT.n
    got = bta.ball_attention_fwd(q, k, v, kb, ball_size=BALL, n_heads=HKV)
    torch.cuda.synchronize()
    assert bta.COUNT.n == before + 1
    _check(got, bta.ball_attention_fwd_plain(q, k, v, kb, ball_size=BALL,
                                             n_heads=HKV), dtype)


@pytest.mark.parametrize("dtype,mode", [(torch.float32, "plain"),
                                        (torch.bfloat16, "plain"),
                                        (torch.float32, "causal"),
                                        (torch.float32, "block_causal")])
def test_flash_kernel(cuda, dtype, mode):
    from repro_torch.kernels import flash
    L = N if mode == "causal" else NB - 3
    q = _rand((B * HKV, REP, N, D), dtype, cuda, 3)
    k = _rand((B * HKV, L, D), dtype, cuda, 4)
    v = _rand((B * HKV, L, D), dtype, cuda, 5)
    kv = torch.ones(B, L, dtype=torch.bool, device=cuda)
    kv[1, 5:] = False
    kw = dict(n_heads=HKV, causal=mode == "causal",
              block_causal=mode == "block_causal", ell=ELL)
    got = flash.flash_attention_fwd(q, k, v, _bias(kv), **kw)
    _check(got, flash.flash_attention_fwd_plain(q, k, v, _bias(kv), **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selection_kernel(cuda, dtype):
    from repro_torch.kernels import selection
    G, M, ks = NB, 4 * REP, 2
    q = _rand((B, HKV, G, M, D), dtype, cuda, 6)
    kb = _rand((B, HKV, NB, ELL, D), dtype, cuda, 7)
    vb = _rand((B, HKV, NB, ELL, D), dtype, cuda, 8)
    g = torch.Generator().manual_seed(9)
    idx = torch.randint(-1, NB, (B, HKV, G, ks), generator=g).int().to(cuda)
    tok = _bias(_mask(cuda)).reshape(B, NB, ELL)
    got = selection.selection_attention_fwd(q, kb, vb, idx, tok)
    _check(got, selection.selection_attention_fwd_plain(q, kb, vb, idx, tok), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_epilogue_kernel(cuda, dtype):
    from repro_torch.kernels import epilogue
    R = B * N * HQ
    os_ = [_rand((R, D), dtype, cuda, 10 + i) for i in range(3)]
    gs = [torch.rand(R, device=cuda) for _ in range(3)]
    m = (torch.rand(R, device=cuda) > 0.3).float()
    got = epilogue.gated_combine_fwd(*os_, *gs, m)
    want = epilogue.gated_combine_fwd_plain(*os_, *gs, m)
    _check((got,), (want,), dtype)


def test_model_kernels_match_reference(cuda):
    from repro_torch.configs import get_config
    from repro_torch.core.backend import use_backend
    from repro_torch.core.config import BSAConfig
    from repro_torch.kernels.common import COUNTERS, reset_counters
    from repro_torch.models.api import model_api
    cfg = get_config("shapenet-bsa").scaled(
        n_layers=2, d_model=64, n_heads=HQ, n_kv_heads=HKV, head_dim=D, d_ff=128,
        bsa=BSAConfig(ball_size=BALL, cmp_block=ELL, slc_block=ELL, top_k=2,
                      group_size=4))
    api = model_api(cfg)
    model = api.init(0)
    batch = api.make_batch(np.random.default_rng(0), B, N)
    batch["mask"][1, 41:] = False
    batch["mask"][2] = False
    with use_backend("reference"):
        want = api.forward(model, batch)
    reset_counters()
    got = api.forward(model, batch)                    # "auto" → kernels on cuda
    padded_fwd = ("bta_fwd", "flash_fwd", "selection_fwd", "epilogue_fwd")
    assert all(c.n == (cfg.n_layers if name in padded_fwd else 0)
               for name, c in COUNTERS.items())
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)


def _bwd_inputs(o, lse, dtype, seed):
    from repro_torch.kernels.common import row_delta
    do = _rand(o.shape, dtype, o.device, seed)
    return do, lse, row_delta(do, o)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bta_bwd_kernel(cuda, dtype):
    from repro_torch.kernels import bta
    q = _rand((B * HKV, REP, N, D), dtype, cuda, 0)
    k = _rand((B * HKV, N, D), dtype, cuda, 1)
    v = _rand((B * HKV, N, D), dtype, cuda, 2)
    kb = _bias(_mask(cuda))
    kw = dict(ball_size=BALL, n_heads=HKV)
    o, lse = bta.ball_attention_fwd(q, k, v, kb, **kw)
    rest = _bwd_inputs(o, lse, dtype, 11)
    before = bta.COUNT_BWD.n
    got = bta.ball_attention_bwd(q, k, v, kb, *rest, **kw)
    torch.cuda.synchronize()
    assert bta.COUNT_BWD.n == before + 1
    _check(got, bta.ball_attention_bwd_plain(q, k, v, kb, *rest, **kw), dtype)
    assert all(bool((g.reshape(B, -1)[2] == 0).all()) for g in got)   # dead slot


@pytest.mark.parametrize("dtype,mode", [(torch.float32, "plain"),
                                        (torch.bfloat16, "plain"),
                                        (torch.float32, "causal"),
                                        (torch.float32, "block_causal")])
def test_flash_bwd_kernels(cuda, dtype, mode):
    from repro_torch.kernels import flash
    L = N if mode == "causal" else NB - 3
    q = _rand((B * HKV, REP, N, D), dtype, cuda, 3)
    k = _rand((B * HKV, L, D), dtype, cuda, 4)
    v = _rand((B * HKV, L, D), dtype, cuda, 5)
    kv = torch.ones(B, L, dtype=torch.bool, device=cuda)
    kv[1, 5:] = False
    q_valid = _mask(cuda) if mode == "plain" else None
    kw = dict(n_heads=HKV, causal=mode == "causal",
              block_causal=mode == "block_causal", ell=ELL)
    o, lse = flash.flash_attention_fwd(q, k, v, _bias(kv), q_valid, **kw)
    rest = _bwd_inputs(o, lse, dtype, 12)
    before = (flash.COUNT_DQ.n, flash.COUNT_DKV.n)
    got = flash.flash_attention_bwd(q, k, v, _bias(kv), *rest, **kw)
    torch.cuda.synchronize()
    assert (flash.COUNT_DQ.n, flash.COUNT_DKV.n) == (before[0] + 1, before[1] + 1)
    _check(got, flash.flash_attention_bwd_plain(q, k, v, _bias(kv), *rest, **kw),
               dtype)
    if q_valid is not None:                   # the skipped tiles: exact zeros
        assert bool((got[0].reshape(B, -1)[2] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selection_bwd_kernel(cuda, dtype):
    from repro_torch.kernels import selection
    G, M, ks = NB, 4 * REP, 2
    q = _rand((B, HKV, G, M, D), dtype, cuda, 6)
    kb = _rand((B, HKV, NB, ELL, D), dtype, cuda, 7)
    vb = _rand((B, HKV, NB, ELL, D), dtype, cuda, 8)
    g = torch.Generator().manual_seed(9)
    idx = torch.randint(-1, NB, (B, HKV, G, ks), generator=g).int()
    idx[0, 0, :4, 0] = 3                      # four groups pick one block
    idx[2] = -1                               # a dead slot
    idx = idx.to(cuda)
    tok = _bias(_mask(cuda)).reshape(B, NB, ELL)
    o, lse = selection.selection_attention_fwd(q, kb, vb, idx, tok)
    rest = _bwd_inputs(o, lse, dtype, 13)
    got = selection.selection_attention_bwd(q, kb, vb, idx, tok, *rest)
    torch.cuda.synchronize()
    tol = {torch.float32: TOL[torch.float32],
           torch.bfloat16: dict(atol=6e-2, rtol=6e-2)}[dtype]
    _check(got, selection.selection_attention_bwd_plain(q, kb, vb, idx, tok, *rest),
               dtype, tol)
    assert all(bool((t[2] == 0).all()) for t in got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_epilogue_bwd_kernel(cuda, dtype):
    from repro_torch.kernels import epilogue
    R = B * N * HQ
    os_ = [_rand((R, D), dtype, cuda, 10 + i) for i in range(3)]
    gs = [torch.rand(R, device=cuda) for _ in range(3)]
    m = (torch.rand(R, device=cuda) > 0.3).float()
    do = _rand((R, D), dtype, cuda, 14)
    got = epilogue.gated_combine_bwd(*os_, *gs, m, do)
    _check(got, epilogue.gated_combine_bwd_plain(*os_, *gs, m, do), dtype)


def test_train_step_grads_match_reference(cuda):
    from repro_torch.configs import get_config
    from repro_torch.core.backend import use_backend
    from repro_torch.core.config import BSAConfig
    from repro_torch.kernels.common import COUNTERS, reset_counters
    from repro_torch.models.api import model_api
    cfg = get_config("shapenet-bsa").scaled(
        n_layers=2, d_model=64, n_heads=HQ, n_kv_heads=HKV, head_dim=D, d_ff=128,
        bsa=BSAConfig(ball_size=BALL, cmp_block=ELL, slc_block=ELL, top_k=2,
                      group_size=4))
    api = model_api(cfg)
    model = api.init(0)
    batch = api.make_batch(np.random.default_rng(0), B, N)
    batch["mask"][1, 41:] = False
    grads = {}
    for backend in ("reference", "kernels"):
        model.zero_grad(set_to_none=True)
        reset_counters()
        with use_backend(backend):
            loss, _ = api.loss(model, batch)
            loss.backward()
        grads[backend] = {n: p.grad.clone() for n, p in model.named_parameters()
                          if p.grad is not None}      # phi_q only feeds top-k
    assert all(c.n == (0 if name.startswith("varlen") else cfg.n_layers)
               for name, c in COUNTERS.items())
    for name, want in grads["reference"].items():
        torch.testing.assert_close(grads["kernels"][name], want, atol=1e-3, rtol=1e-3)


# ---------------------------------------------------------------------------
# packed-varlen kernels: clouds of 20, 45, 33 and 11 points packed at ball 16
# to capacity 160 (the tail is segment S), q_offsets = offsets and
# k_offsets = offsets / ℓ as in the compression branch
# ---------------------------------------------------------------------------

def _varlen_case(dtype, dev, seed):
    from repro_torch.core.balltree import pack_varlen
    from repro_torch.kernels.occupancy import varlen_maps
    sizes = (20, 45, 33, 11)
    _, offsets, mask = pack_varlen([np.zeros((n, 1)) for n in sizes], BALL, pad_to=160,
                                   max_samples=5)
    T, L = 160, 160 // ELL
    maps = varlen_maps(offsets, offsets // ELL, T, L, dev)
    blk = torch.from_numpy(mask.reshape(L, ELL).any(-1)).to(dev)
    blk[2] = False                            # a dead block inside a segment
    q = _rand((HKV, REP, T, D), dtype, dev, seed)
    k = _rand((HKV, L, D), dtype, dev, seed + 1)
    v = _rand((HKV, L, D), dtype, dev, seed + 2)
    return (q, k, v, _bias(blk)[None], maps.qseg[None], maps.kseg[None], maps.q_bounds,
            maps.k_bounds)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_varlen_kernel(cuda, dtype):
    from repro_torch.kernels import varlen
    args = _varlen_case(dtype, cuda, 20)
    before = varlen.COUNT.n
    got = varlen.flash_attention_varlen_fwd(*args)
    torch.cuda.synchronize()
    assert varlen.COUNT.n == before + 1
    _check(got, varlen.flash_attention_varlen_fwd_plain(*args[:6]), dtype)
    assert bool((got[1][..., 144:] == 1e30).all())       # the tail sees no valid key


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_varlen_bwd_kernels(cuda, dtype):
    from repro_torch.kernels import varlen
    args = _varlen_case(dtype, cuda, 23)
    o, lse = varlen.flash_attention_varlen_fwd(*args)
    rest = _bwd_inputs(o, lse, dtype, 26)
    before = (varlen.COUNT_DQ.n, varlen.COUNT_DKV.n)
    got = varlen.flash_attention_varlen_bwd(*args, *rest)
    torch.cuda.synchronize()
    assert (varlen.COUNT_DQ.n, varlen.COUNT_DKV.n) == (before[0] + 1, before[1] + 1)
    _check(got, varlen.flash_attention_varlen_bwd_plain(*args[:6], *rest), dtype)
    assert bool((got[0][..., 144:, :] == 0).all())       # tail rows: exact zeros
    assert bool((got[1][:, 2] == 0).all())               # the dead block


def test_packed_model_matches_reference(cuda):
    from repro_torch.configs import get_config
    from repro_torch.core.backend import use_backend
    from repro_torch.core.balltree import pack_varlen
    from repro_torch.core.config import BSAConfig
    from repro_torch.kernels.common import COUNTERS, reset_counters
    from repro_torch.models.api import model_api
    cfg = get_config("shapenet-bsa").scaled(
        n_layers=2, d_model=64, n_heads=HQ, n_kv_heads=HKV, head_dim=D, d_ff=128,
        bsa=BSAConfig(ball_size=BALL, cmp_block=ELL, slc_block=ELL, top_k=2,
                      group_size=4))
    api = model_api(cfg)
    model = api.init(0)
    rng = np.random.default_rng(1)
    items = [rng.standard_normal((n, 8)).astype(np.float32) for n in (20, 45, 33, 11)]
    packed, offsets, mask = pack_varlen(items, BALL, pad_to=160, max_samples=5)
    batch = {"feats": torch.from_numpy(packed[None, :, :7]).to(cuda),
             "target": torch.from_numpy(packed[None, :, 7:]).to(cuda),
             "mask": torch.from_numpy(mask[None]).to(cuda),
             "offsets": torch.from_numpy(offsets)}
    grads, preds = {}, {}
    for backend in ("reference", "kernels"):
        model.zero_grad(set_to_none=True)
        reset_counters()
        with use_backend(backend):
            preds[backend] = api.forward(model, batch)
            loss, _ = api.loss(model, batch)
            loss.backward()
        grads[backend] = {n: p.grad.clone() for n, p in model.named_parameters()
                          if p.grad is not None}
    packed_path = ("bta_fwd", "varlen_fwd", "selection_fwd", "epilogue_fwd")
    assert all(c.n == (2 * cfg.n_layers if name in packed_path
                       else 0 if name.startswith("flash") else cfg.n_layers)
               for name, c in COUNTERS.items())
    torch.testing.assert_close(preds["kernels"], preds["reference"], atol=1e-3, rtol=1e-3)
    for name, want in grads["reference"].items():
        torch.testing.assert_close(grads["kernels"][name], want, atol=1e-3, rtol=1e-3)
