"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: without a card every test here skips (decided inside the
fixture, never at import).  On a machine with an H100 run them with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py``.
Small shapes with rep 2, one padded sample and one fully masked slot.
Tolerance: fp32 1e-4, bf16 4e-2.
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


def _check(kernel_out, plain_out, dtype):
    for got, want in zip(kernel_out, plain_out):
        assert torch.isfinite(got.float()).all()
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


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
    assert all(c.n == cfg.n_layers for c in COUNTERS.values())
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)
