"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: without a card every test here skips (decided inside the
fixture, never at import).  On a machine with an H100 run them with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py``.
Small shapes with rep 2, one padded sample and one fully masked slot (the
varlen kernels: four clouds packed with a capacity tail and a dead block;
the fp32 ``varlen_fwd`` / ``varlen_dq`` on their planned row tiles also
with ragged tiles, a dead tail and a segment with no key, bit-for-bit on
two calls),
head_dim 16 and, for the causal LM path's kernels, 128; the flash backward
at every head dim (16-128) with rep 3 and ``flash_dkv``'s row splits forced
to 1 and 3; the tiled ``flash_fwd`` at every head dim and mask mode (ragged
tiles, skipped ``q_valid`` tiles, block-causal rows that see nothing) and
the local backward at every head dim and windows 64-256 (bf16: the tiled
path, with a bit-for-bit determinism check).
Each backward kernel gets the same (inputs, dO, lse, δ) as its plain
version.  The ball kernels on every path of ``bta_plan`` (balls of 256:
fp32 D 16 and 32 on the register-tiled path, D 64 on the row kernels, bf16
D 32–128 on the tensor cores at rep 1, 2 and 4; bf16 balls of 32 on the row
kernels; a ball with 2 valid keys, a dead ball, rows that see no key), with
bit-for-bit determinism checks of the fused fp32 backward and the bf16 one
(also at a ball of 512); the BALL 16 cases run the row kernels.  The tiled
``local_fwd`` at every head dim,
windows 64-256 and with or without segments (a padded tail, a dead block, a masked slot),
with the local backward run from its lse.  The causal LM's kernels:
``local_fwd``, ``local_dq`` and
``local_dkv`` with a mask, a dead block, a masked slot and packed segments
(windows 32 and 256), ``paged_gather`` and ``paged_gather_pair`` with
out-of-range rows and unaligned rows, int32 and int64 indices, one kernel a
call, and a 2-layer smoke tinyllama's forward, paged decode (four pair
gathers a layer and step) and (with remat)
gradients against the reference backend.  The fp32 groups path of
``selection_fwd`` at shapenet's serving and packed shapes and at D 16 / 64,
M 5 / 12 and a tail (dead groups, duplicate picks, an index of NB, a masked
tail; identical bits on two calls), the shapes that keep the warp kernel,
``epilogue_bwd`` and ``epilogue_fwd`` on both of their kernels at D 12-128
in both dtypes (odd R, an input off 16 bytes; identical bits on two calls;
the backward's two output buffers; the forward's per-head, per-row and
strided gates, with and without a mask, and ``ops.gated_combine`` one
kernel a call), and
the loaded entry points' signatures.  The paper's other workloads: the
flash kernels at a square shape with a key mask (the full baseline; two
``flash_dkv`` calls give identical bits), ``erwin_attention`` at levels 0–2
on the ball kernels' fma path against the reference backend, and
``bsa_attention`` with group compression and φ = "mlp".  Tolerance: fp32
1e-4, bf16 4e-2 (6e-2 for the selection backward, as the JAX suite's bf16
gradient tolerances); the row gather is exact.
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
@pytest.mark.parametrize("head_dim", [16, 128])
def test_flash_kernel(cuda, dtype, mode, head_dim):
    from repro_torch.kernels import flash
    L = N if mode == "causal" else NB - 3
    q = _rand((B * HKV, REP, N, head_dim), dtype, cuda, 3)
    k = _rand((B * HKV, L, head_dim), dtype, cuda, 4)
    v = _rand((B * HKV, L, head_dim), dtype, cuda, 5)
    kv = torch.ones(B, L, dtype=torch.bool, device=cuda)
    kv[1, 5:] = False
    kw = dict(n_heads=HKV, causal=mode == "causal",
              block_causal=mode == "block_causal", ell=ELL)
    got = flash.flash_attention_fwd(q, k, v, _bias(kv), **kw)
    _check(got, flash.flash_attention_fwd_plain(q, k, v, _bias(kv), **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,ell", [("plain", 8), ("causal", 8), ("block_causal", 8),
                                      ("block_causal", 64)])
@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
def test_flash_fwd_tiled_edges(cuda, head_dim, mode, ell, dtype):
    """The tiled forward (``flash_fwd_plan``: mma in bf16, fma in fp32) at
    each head dim and mask mode: rep 3, N = 200 positions (a ragged last row
    tile) against L = 70 keys (a ragged key tile; N in causal mode), a
    masked key run, and in plain mode ``q_valid`` with a skipped slot and a
    skipped tail (those rows are unspecified, the rest compared).  In
    block-causal mode the rows t < ℓ see no key: exact zeros and
    ``LSE_EMPTY`` (at ℓ 64 whole row tiles, which stop before any key)."""
    from repro_torch.kernels import flash
    from repro_torch.kernels.common import LSE_EMPTY
    rep, n = 3, 200
    L = n if mode == "causal" else 70
    q = _rand((B * HKV, rep, n, head_dim), dtype, cuda, 30)
    k = _rand((B * HKV, L, head_dim), dtype, cuda, 31)
    v = _rand((B * HKV, L, head_dim), dtype, cuda, 32)
    kv = torch.ones(B, L, dtype=torch.bool, device=cuda)
    kv[1, 5:9] = False
    q_valid = None
    if mode == "plain":
        q_valid = torch.ones(B, n, dtype=torch.bool, device=cuda)
        q_valid[1, 130:] = False                     # a skipped 64-row tile and a ragged one
        q_valid[2] = False
    kw = dict(n_heads=HKV, causal=mode == "causal", block_causal=mode == "block_causal",
              ell=ell)
    before = flash.COUNT.n
    o, lse = flash.flash_attention_fwd(q, k, v, _bias(kv), q_valid, **kw)
    torch.cuda.synchronize()
    assert flash.COUNT.n == before + 1
    want = flash.flash_attention_fwd_plain(q, k, v, _bias(kv), q_valid, **kw)
    rows = (slice(None),) if q_valid is None else \
        (q_valid.repeat_interleave(HKV, 0)[:, None, :].expand(-1, rep, -1),)
    _check((o[rows], lse[rows]), (want[0][rows], want[1][rows]), dtype)
    if q_valid is not None:                          # the skipped slot: zeros, LSE_EMPTY
        assert bool((o[2 * HKV:] == 0).all()) and bool((lse[2 * HKV:] == LSE_EMPTY).all())
    if mode == "block_causal":
        assert bool((o[:, :, :ell] == 0).all()) and bool((lse[:, :, :ell] == LSE_EMPTY).all())


# (M rows a group, ℓ keys a block): the warp path at 4·REP rows, the tiled
# path at 64 and 192 rows against blocks of 64 keys
SEL_SHAPES = [(4 * REP, ELL), (64, 64), (192, 64)]


def _selection_case(dev, dtype, M, ell, head_dim, ks=2):
    """Groups of M rows (one a block), blocks of ℓ keys: random picks with
    −1 and out-of-range ones, four groups on one block, a dead slot (batch
    2: every key masked, every pick −1) and a masked tail in batch 1."""
    G = NB
    q = _rand((B, HKV, G, M, head_dim), dtype, dev, 6)
    kb = _rand((B, HKV, NB, ell, head_dim), dtype, dev, 7)
    vb = _rand((B, HKV, NB, ell, head_dim), dtype, dev, 8)
    g = torch.Generator().manual_seed(9)
    idx = torch.randint(-1, NB, (B, HKV, G, ks), generator=g).int()
    idx[1, 1, 5, 1] = NB                      # past the last block: skipped
    idx[0, 0, :4, 0] = 3                      # four groups pick one block
    idx[2] = -1                               # a dead slot
    tok_ok = torch.ones(B, NB * ell, dtype=torch.bool)
    tok_ok[1, NB * ell * 41 // N:] = False
    tok_ok[2] = False
    return q, kb, vb, idx.to(dev), _bias(tok_ok.to(dev)).reshape(B, NB, ell)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", [16, 128])
@pytest.mark.parametrize("M,ell", SEL_SHAPES)
def test_selection_kernel(cuda, dtype, head_dim, M, ell):
    from repro_torch.kernels import selection
    q, kb, vb, idx, tok = _selection_case(cuda, dtype, M, ell, head_dim)
    before = selection.COUNT.n
    got = selection.selection_attention_fwd(q, kb, vb, idx, tok)
    torch.cuda.synchronize()
    assert selection.COUNT.n == before + 1
    plain_idx = torch.where(idx < NB, idx, -1)          # the plain version takes −1 only
    _check(got, selection.selection_attention_fwd_plain(q, kb, vb, plain_idx, tok), dtype)
    assert bool((got[0][2] == 0).all()) and bool((got[1][2] == 1e30).all())


def _groups_case(dev, B_, Hkv, G, M, NB_, ell, head_dim, ks, seed):
    """Random picks with −1 and NB, dead groups (no pick; only −1 and NB),
    a block picked twice by a group and by every group of a head, and a
    masked tail (each batch's last 3/8 of its last block, and all of batch
    0's block 1)."""
    q = _rand((B_, Hkv, G, M, head_dim), torch.float32, dev, seed)
    kb = _rand((B_, Hkv, NB_, ell, head_dim), torch.float32, dev, seed + 1)
    vb = _rand((B_, Hkv, NB_, ell, head_dim), torch.float32, dev, seed + 2)
    g = torch.Generator().manual_seed(seed + 3)
    idx = torch.randint(-1, NB_ + 1, (B_, Hkv, G, ks), generator=g).int()
    idx[0, 0, :3] = -1                         # dead groups
    idx[0, 0, 3] = NB_                         # dead: every pick is NB
    idx[0, 1, 4, :2] = 5                       # a block twice in a group
    idx[-1, -1, :, 0] = 2                      # every group of a head on block 2
    tok = torch.zeros(B_, NB_, ell)
    tok[:, -1, ell - 3 * ell // 8:] = -1e30
    tok[0, 1] = -1e30
    return q, kb, vb, idx.to(dev), tok.to(dev)


# (B, Hkv, G, M, NB, ℓ, D, k*): shapenet's serving / train shape (8 × 8
# heads of 32, 480 groups of 8 rows, 4 blocks of 8 keys), its packed one
# (one sample of 3,840 groups), D 16 and 64, two passes (M 12), a short
# pass (M 5), a stage filled by 2 blocks of 16, a tail tile (G 37)
GROUPS_SHAPES = [(8, 8, 480, 8, 480, 8, 32, 4), (1, 8, 3840, 8, 3840, 8, 32, 4),
                 (2, 3, 37, 8, 40, 8, 16, 4), (2, 3, 37, 8, 40, 8, 64, 4),
                 (2, 3, 37, 12, 40, 4, 32, 8), (2, 3, 37, 5, 40, 8, 32, 3),
                 (2, 3, 37, 4, 40, 16, 32, 2)]


@pytest.mark.parametrize("shape", GROUPS_SHAPES,
                         ids=["-".join(map(str, s)) for s in GROUPS_SHAPES])
def test_selection_fwd_groups_edges(cuda, shape):
    """The fp32 groups path (``selection_fwd_groups``) against the plain
    version (fp32 1e-4): dead groups give zeros and LSE_EMPTY, identical
    bits on two calls, one launch a call."""
    from repro_torch.kernels import selection
    B_, Hkv, G, M, NB_, ell, head_dim, ks = shape
    assert selection.selection_plan(M, ell, head_dim, torch.float32, ks).path == "groups"
    q, kb, vb, idx, tok = _groups_case(cuda, *shape, 60)
    before = selection.COUNT.n
    first = selection.selection_attention_fwd(q, kb, vb, idx, tok)
    second = selection.selection_attention_fwd(q, kb, vb, idx, tok)
    torch.cuda.synchronize()
    assert selection.COUNT.n == before + 2
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    plain_idx = torch.where(idx < NB_, idx, -1)
    _check(first, selection.selection_attention_fwd_plain(q, kb, vb, plain_idx, tok),
           torch.float32)
    o, lse = first
    assert bool((o[0, 0, :4] == 0).all()) and bool((lse[0, 0, :4] == 1e30).all())


# (dtype, D, k*): the forward shapes that keep the warp kernel at M 8, ℓ 8
WARP_KEPT = [(torch.bfloat16, 32, 4), (torch.float32, 128, 4), (torch.bfloat16, 128, 4),
             (torch.float32, 32, 5)]


@pytest.mark.parametrize("dtype,head_dim,ks", WARP_KEPT,
                         ids=[f"{str(d)[6:]}-D{h}-k{k}" for d, h, k in WARP_KEPT])
def test_selection_fwd_warp_kept(cuda, dtype, head_dim, ks):
    """bf16, D 128 and more keys than one stage stay on the warp kernel
    (``selection_fwd_warp``), against the plain version."""
    from repro_torch.kernels import selection
    assert selection.selection_plan(8, 8, head_dim, dtype, ks).path == "warp"
    q, kb, vb, idx, tok = _groups_case(cuda, 2, 2, 40, 8, 40, 8, head_dim, ks, 70)
    q, kb, vb = (t.to(dtype) for t in (q, kb, vb))
    got = selection.selection_attention_fwd(q, kb, vb, idx, tok)
    torch.cuda.synchronize()
    plain_idx = torch.where(idx < 40, idx, -1)
    _check(got, selection.selection_attention_fwd_plain(q, kb, vb, plain_idx, tok), dtype)


def test_build_signatures_loaded(cuda):
    """The loaded entry points carry ``_build.SIGNATURES``; an entry point
    refuses what it has no kernel for (the groups path in bf16)."""
    from repro_torch.kernels import _build
    _build.load()
    assert set(_build._entry) == set(_build.SIGNATURES)
    for name, argtypes in _build.SIGNATURES.items():
        assert _build._entry[name].argtypes == argtypes
    q = torch.zeros((1, 1, 1, 8, 32), dtype=torch.bfloat16, device=cuda)
    kb = torch.zeros((1, 1, 1, 8, 32), dtype=torch.bfloat16, device=cuda)
    idx = torch.zeros((1, 1, 1, 4), dtype=torch.int32, device=cuda)
    tok = torch.zeros((1, 1, 8), device=cuda)
    lse = torch.empty((1, 1, 1, 8), device=cuda)
    with pytest.raises(RuntimeError, match="selection_fwd: CUDA launch failed"):
        _build.launch("selection_fwd", q.data_ptr(), kb.data_ptr(), kb.data_ptr(),
                      idx.data_ptr(), tok.data_ptr(), q.data_ptr(), lse.data_ptr(),
                      1, 1, 1, 8, 1, 8, 4, 32, 1, 2,
                      torch.cuda.current_stream().cuda_stream)
    with pytest.raises(TypeError):
        _build.launch("epilogue_bwd", *([0] * 18))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_epilogue_kernel(cuda, dtype):
    from repro_torch.kernels import epilogue
    R = B * N * HQ
    os_ = [_rand((R, D), dtype, cuda, 10 + i) for i in range(3)]
    gs = [torch.rand(R // HQ, HQ, device=cuda) for _ in range(3)]
    m = torch.rand(R // HQ, device=cuda) > 0.3
    got = epilogue.gated_combine_fwd(*os_, *gs, m)
    want = epilogue.gated_combine_fwd_plain(*os_, *gs, m)
    _check((got,), (want,), dtype)


# (R, D, dtype, shift): the forward's vec kernel at D 16-128 in both dtypes
# on odd token counts, 12 vectors on 8 lanes (D 48), bf16 D 40; the warp
# kernel at D 12 bf16, D 30 fp32 and on inputs 4 bytes off 16 (shift)
EPI_FWD_CASES = [(R, D, dt, 0) for D in (16, 32, 64, 128)
                 for dt in (torch.float32, torch.bfloat16) for R in (3, 4101)] + [
    (519, 48, torch.float32, 0), (519, 40, torch.bfloat16, 0),
    (519, 12, torch.bfloat16, 0), (519, 30, torch.float32, 0), (519, 32, torch.float32, 1)]


@pytest.mark.parametrize("gates", ["head", "row", "slice"])
@pytest.mark.parametrize("R,head_dim,dtype,shift", EPI_FWD_CASES,
                         ids=[f"R{r}-D{d}-{str(t)[6:]}-s{s}" for r, d, t, s in EPI_FWD_CASES])
def test_epilogue_fwd_paths(cuda, R, head_dim, dtype, shift, gates):
    """``epilogue_fwd`` on both kernels of :func:`epilogue.epilogue_plan`
    against the plain version (within the tolerance: the kernel may fuse a
    product and a sum, the plain version rounds each), with one gate a head, one a row
    and the token-mode slice of a (T, 3H) projection, with and without the
    mask: identical bits on two calls, one launch a call."""
    from repro_torch.kernels import epilogue
    H = 3
    def rows(seed):
        t = _rand((R * head_dim + shift,), dtype, cuda, seed)
        return t[shift:].view(R, head_dim)
    os_ = [rows(40 + i) for i in range(3)]
    T = R // H
    g = torch.Generator(device=cuda).manual_seed(1)
    if gates == "head":
        gs = [torch.rand(1, H, device=cuda, generator=g) for _ in range(3)]
    elif gates == "row":
        gs = [torch.rand(T, H, device=cuda, generator=g) for _ in range(3)]
    else:
        proj = torch.rand(T, 3 * H, device=cuda, generator=g)
        gs = [proj[:, i * H:(i + 1) * H] for i in range(3)]
    plan = epilogue.epilogue_plan(head_dim, dtype, shift == 0)
    assert plan.path == ("warp" if shift or head_dim in (12, 30) else "vec")
    for m in (torch.rand(T, device=cuda, generator=g) > 0.3, None):
        before = epilogue.COUNT.n
        first = epilogue.gated_combine_fwd(*os_, *gs, m)
        second = epilogue.gated_combine_fwd(*os_, *gs, m)
        torch.cuda.synchronize()
        assert epilogue.COUNT.n == before + 2
        assert torch.equal(first, second)
        want = epilogue.gated_combine_fwd_plain(*os_, *gs, m)
        _check((first,), (want,), dtype)


def test_gated_combine_launches_only_the_forward_kernel(cuda):
    """The layer's call (``ops.gated_combine``, per-head gates, a mask)
    launches ``epilogue_fwd`` and no other kernel: no (R,) copy of a gate
    or of the mask."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    outs = [_rand((B, N, HQ, D), torch.float32, cuda, 50 + i) for i in range(3)]
    gates = [torch.rand(HQ, device=cuda)[None, None, :, None] for _ in range(3)]
    mask = _mask(cuda)
    ops.gated_combine(outs, gates, mask)
    torch.cuda.synchronize()
    for _ in range(3):          # a trace now and then holds no device event: take it again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ops.gated_combine(outs, gates, mask)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if kernels:
            break
    assert len(kernels) == 1 and "epilogue_fwd" in kernels[0], kernels


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


# balls of 256 (shapenet's): sample 0 holds 258 valid keys of 768, so ball 1
# is live with 2 valid keys (the padded train batch's last ball) and ball 2
# is dead; sample 1 has a hole in ball 0
BTA_BALL, BTA_N = 256, 768


def _bta_case(dev, dtype, head_dim, rep, seed, ball=BTA_BALL, n=BTA_N):
    Hkv = 2
    q = _rand((2 * Hkv, rep, n, head_dim), dtype, dev, seed)
    k = _rand((2 * Hkv, n, head_dim), dtype, dev, seed + 1)
    v = _rand((2 * Hkv, n, head_dim), dtype, dev, seed + 2)
    valid = torch.ones(2, n, dtype=torch.bool, device=dev)
    valid[0, 258:] = False
    valid[1, 5:40] = False
    return q, k, v, _bias(valid), dict(ball_size=ball, n_heads=Hkv)


_BTA_EDGES = [(torch.float32, 16, BTA_BALL, "fma", rep) for rep in (1, 2)]
_BTA_EDGES += [(torch.float32, 32, BTA_BALL, "fma", rep) for rep in (1, 2)]
_BTA_EDGES += [(torch.float32, 64, BTA_BALL, "rows", rep) for rep in (1, 2)]
_BTA_EDGES += [(torch.bfloat16, d, BTA_BALL, "mma", rep) for d in (32, 64, 128)
               for rep in (1, 2, 4)]
_BTA_EDGES += [(torch.bfloat16, 32, 32, "rows", rep) for rep in (1, 2)]


@pytest.mark.parametrize("dtype,head_dim,ball,path,rep", _BTA_EDGES)
def test_bta_tiled_edges(cuda, dtype, head_dim, ball, path, rep):
    """Every path of ``bta_plan`` against the plain versions (balls of 256:
    fp32 D 16 / 32 on fma, D 64 on rows, bf16 D 32–128 on mma at rep 1, 2
    and 4; bf16 balls of 32 on rows): forward and backward (from the
    kernel's own lse) one launch each, a live ball with 2 valid keys, a dead
    ball (zeros, ``LSE_EMPTY``, gradients exactly 0) and, with ``live``
    forced to 1 there, rows whose keys are all masked walked by the kernel
    (the same zeros and ``LSE_EMPTY``)."""
    from repro_torch.kernels import bta
    from repro_torch.kernels.common import LSE_EMPTY
    q, k, v, kb, kw = _bta_case(cuda, dtype, head_dim, rep, 40, ball)
    assert bta.bta_plan(ball, head_dim, rep, dtype).path == path
    live = bta._live(kb, ball)
    assert live.tolist() == (kb > -1).reshape(2, -1, ball).any(-1).int().tolist()
    assert live[0, 256 // ball].item() == 1                  # 2 valid keys
    for lv in (live, torch.ones_like(live)):
        n0, n1 = bta.COUNT.n, bta.COUNT_BWD.n
        o, lse = bta.ball_attention_fwd(q, k, v, kb, live=lv, **kw)
        rest = _bwd_inputs(o, lse, dtype, 41)
        got = bta.ball_attention_bwd(q, k, v, kb, *rest, live=lv, **kw)
        torch.cuda.synchronize()
        assert (bta.COUNT.n, bta.COUNT_BWD.n) == (n0 + 1, n1 + 1)
        _check((o, lse), bta.ball_attention_fwd_plain(q, k, v, kb, **kw), dtype)
        _check(got, bta.ball_attention_bwd_plain(q, k, v, kb, *rest, **kw), dtype)
        dead = slice(2 * BTA_BALL, 3 * BTA_BALL)            # sample 0's dead balls
        assert (o[:2, :, dead] == 0).all() and (lse[:2, :, dead] == LSE_EMPTY).all()
        assert all((g[:2, ..., dead, :] == 0).all() for g in got)


@pytest.mark.parametrize("dtype,head_dim,ball,rep", [(torch.float32, 32, BTA_BALL, 2),
                                                     (torch.bfloat16, 64, BTA_BALL, 2),
                                                     (torch.bfloat16, 128, BTA_BALL, 4),
                                                     (torch.bfloat16, 64, 512, 2)])
def test_bta_bwd_fma_deterministic(cuda, dtype, head_dim, ball, rep):
    """Each backward path that owns a ball's gradients in fixed blocks gives
    identical bits on two calls: the fused fp32 ``bta_bwd_fma`` and the bf16
    ``bta_bwd_mma`` (its dK/dV and dQ blocks), the latter also at a ball of
    512 (beyond any block's staged keys), held to the plain version there."""
    from repro_torch.kernels import bta
    n = 3 * ball
    q, k, v, kb, kw = _bta_case(cuda, dtype, head_dim, rep, 50, ball, n)
    assert bta.bta_plan(ball, head_dim, rep, dtype).path == (
        "fma" if dtype == torch.float32 else "mma")
    o, lse = bta.ball_attention_fwd(q, k, v, kb, **kw)
    rest = _bwd_inputs(o, lse, dtype, 51)
    first = bta.ball_attention_bwd(q, k, v, kb, *rest, **kw)
    second = bta.ball_attention_bwd(q, k, v, kb, *rest, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    if ball > BTA_BALL:
        _check((o, lse), bta.ball_attention_fwd_plain(q, k, v, kb, **kw), dtype)
        _check(first, bta.ball_attention_bwd_plain(q, k, v, kb, *rest, **kw), dtype)


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["plain", "causal", "block_causal"])
@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
def test_flash_bwd_kernels(cuda, head_dim, mode, dtype, splits, monkeypatch):
    """flash_dq / flash_dkv at each head dim, mask mode and dtype, with
    ``flash_dkv``'s row splits (``dkv_splits``) forced to 1 (direct writes)
    and to 3 (the workspace and the reduction pass), a GQA group of rep 3, N = 200 rows (a
    ragged row tile) against L = 70 keys (a ragged key tile; N in causal
    mode), a fully masked slot (plain mode: its query tiles skipped by the
    forward) and, in every mode, a 64-row span of one head set to
    LSE_EMPTY: those rows get exact zeros in dq and add nothing to dk, dv."""
    from repro_torch.kernels import flash
    from repro_torch.kernels.common import LSE_EMPTY
    rep, n = 3, 200
    L = n if mode == "causal" else 70
    q = _rand((B * HKV, rep, n, head_dim), dtype, cuda, 3)
    k = _rand((B * HKV, L, head_dim), dtype, cuda, 4)
    v = _rand((B * HKV, L, head_dim), dtype, cuda, 5)
    kv = torch.ones(B, L, dtype=torch.bool, device=cuda)
    kv[1, 5:9] = False
    q_valid = None
    if mode == "plain":
        q_valid = torch.ones(B, n, dtype=torch.bool, device=cuda)
        q_valid[1, 150:] = False
        q_valid[2] = False
    kw = dict(n_heads=HKV, causal=mode == "causal",
              block_causal=mode == "block_causal", ell=ELL)
    o, lse = flash.flash_attention_fwd(q, k, v, _bias(kv), q_valid, **kw)
    lse[0, 1, 64:128] = LSE_EMPTY                  # an empty row tile
    o[0, 1, 64:128] = 0
    do, lse, delta = _bwd_inputs(o, lse, dtype, 12)
    before = (flash.COUNT_DQ.n, flash.COUNT_DKV.n)
    args = (q, k, v, _bias(kv), do, lse, delta)
    monkeypatch.setattr(flash, "dkv_splits", lambda *a, **k: splits)
    got = (flash.flash_attention_dq(*args, **kw), *flash.flash_attention_dkv(*args, **kw))
    torch.cuda.synchronize()
    assert (flash.COUNT_DQ.n, flash.COUNT_DKV.n) == (before[0] + 1, before[1] + 1)
    _check(got, flash.flash_attention_bwd_plain(*args, **kw), dtype)
    assert bool((got[0][0, 1, 64:128] == 0).all())          # the empty tile
    if q_valid is not None:                                 # the skipped slot
        assert bool((got[0].reshape(B, -1)[2] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", [16, 128])
@pytest.mark.parametrize("M,ell", SEL_SHAPES)
def test_selection_bwd_kernel(cuda, dtype, head_dim, M, ell):
    from repro_torch.kernels import selection
    q, kb, vb, idx, tok = _selection_case(cuda, dtype, M, ell, head_dim)
    o, lse = selection.selection_attention_fwd(q, kb, vb, idx, tok)
    rest = _bwd_inputs(o, lse, dtype, 13)
    tiles = selection.selection_plan(M, ell, head_dim, dtype).path == "tiles"
    before = {c: c.n for c in (selection.COUNT_BWD, selection.COUNT_DQ, selection.COUNT_DKV)}
    got = selection.selection_attention_bwd(q, kb, vb, idx, tok, *rest)
    torch.cuda.synchronize()
    assert {c: c.n - n for c, n in before.items()} == {
        selection.COUNT_BWD: int(not tiles), selection.COUNT_DQ: int(tiles),
        selection.COUNT_DKV: int(tiles)}
    tol = {torch.float32: TOL[torch.float32],
           torch.bfloat16: dict(atol=6e-2, rtol=6e-2)}[dtype]
    plain_idx = torch.where(idx < NB, idx, -1)
    _check(got, selection.selection_attention_bwd_plain(q, kb, vb, plain_idx, tok, *rest),
           dtype, tol)
    assert all(bool((t[2] == 0).all()) for t in got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selection_bwd_tiles_deterministic(cuda, dtype):
    """The tiled backward sums each block's selections in a fixed order: two
    runs give bit-identical dK, dV (and dQ)."""
    from repro_torch.kernels import selection
    q, kb, vb, idx, tok = _selection_case(cuda, dtype, 192, 64, 64, ks=4)
    idx[:, :, :, 1] = 3                       # every group of every head picks block 3
    o, lse = selection.selection_attention_fwd(q, kb, vb, idx, tok)
    rest = _bwd_inputs(o, lse, dtype, 14)
    first = selection.selection_attention_bwd(q, kb, vb, idx, tok, *rest)
    second = selection.selection_attention_bwd(q, kb, vb, idx, tok, *rest)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("M", [4 * REP, 12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selection_bwd_warp_hot_block(cuda, dtype, M):
    """The warp path stages each selection's dK, dV and sums every block's
    in a fixed order: with every live group picking block 0 (and block 0
    twice in some groups, −1 and out-of-range picks beside), groups of 8
    rows (one pass) and 12 (two passes, the second adding to the first),
    it matches the plain version and gives identical bits on two calls."""
    from repro_torch.kernels import selection
    q, kb, vb, idx, tok = _selection_case(cuda, dtype, M, ELL, D, ks=3)
    idx[:2, :, :, 0] = 0                                # every live group (slot 2 is dead)
    idx[0, 1, :3, 2] = 0                                # block 0 twice in a group
    assert selection.selection_plan(M, ELL, D, dtype).path == "warp"
    o, lse = selection.selection_attention_fwd(q, kb, vb, idx, tok)
    rest = _bwd_inputs(o, lse, dtype, 15)
    before = selection.COUNT_BWD.n
    first = selection.selection_attention_bwd(q, kb, vb, idx, tok, *rest)
    second = selection.selection_attention_bwd(q, kb, vb, idx, tok, *rest)
    torch.cuda.synchronize()
    assert selection.COUNT_BWD.n == before + 2
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    tol = {torch.float32: TOL[torch.float32],
           torch.bfloat16: dict(atol=6e-2, rtol=6e-2)}[dtype]
    plain_idx = torch.where(idx < NB, idx, -1)
    _check(first, selection.selection_attention_bwd_plain(q, kb, vb, plain_idx, tok, *rest),
           dtype, tol)


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


# (R, D, dtype, shift): the vec kernel at D 16-128 in both dtypes on an odd
# R, 12 vectors on 8 lanes (D 48), bf16 D 40 (5 vectors on 4 lanes); the
# warp kernel at D 12 bf16, D 30 fp32 and on inputs 4 bytes off 16 (shift)
EPI_CASES = [(R, D, dt, 0) for D in (16, 32, 64, 128)
             for dt in (torch.float32, torch.bfloat16) for R in (1, 4099)] + [
    (517, 48, torch.float32, 0), (517, 40, torch.bfloat16, 0),
    (517, 12, torch.bfloat16, 0), (517, 30, torch.float32, 0), (517, 32, torch.float32, 1)]


@pytest.mark.parametrize("R,head_dim,dtype,shift", EPI_CASES,
                         ids=[f"R{r}-D{d}-{str(t)[6:]}-s{s}" for r, d, t, s in EPI_CASES])
def test_epilogue_bwd_paths(cuda, R, head_dim, dtype, shift):
    """``epilogue_bwd`` on both kernels of :func:`epilogue.epilogue_plan`
    against the plain version: identical bits on two calls, one launch a
    call, two buffers for the six outputs."""
    from repro_torch.kernels import epilogue
    def rows(seed):
        t = _rand((R * head_dim + shift,), dtype, cuda, seed)
        return t[shift:].view(R, head_dim)
    os_ = [rows(30 + i) for i in range(3)]
    do = rows(34)
    gs = [torch.rand(R, device=cuda) for _ in range(3)]
    m = (torch.rand(R, device=cuda) > 0.3).float()
    plan = epilogue.epilogue_plan(head_dim, dtype, shift == 0)
    assert plan.path == ("warp" if shift or head_dim in (12, 30) else "vec")
    before = epilogue.COUNT_BWD.n
    first = epilogue.gated_combine_bwd(*os_, *gs, m, do)
    second = epilogue.gated_combine_bwd(*os_, *gs, m, do)
    torch.cuda.synchronize()
    assert epilogue.COUNT_BWD.n == before + 2
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert len({t.untyped_storage().data_ptr() for t in first}) == 2
    want = epilogue.gated_combine_bwd_plain(*os_, *gs, m, do)
    for k in range(3):
        assert torch.equal(first[k], want[k])
    _check(first, want, dtype)


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
    padded_train = ("bta_fwd", "flash_fwd", "selection_fwd", "epilogue_fwd", "bta_bwd",
                    "flash_dq", "flash_dkv", "selection_bwd", "epilogue_bwd")
    assert all(c.n == (cfg.n_layers if name in padded_train else 0)
               for name, c in COUNTERS.items())
    for name, want in grads["reference"].items():
        torch.testing.assert_close(grads["kernels"][name], want, atol=1e-3, rtol=1e-3)


# ---------------------------------------------------------------------------
# packed-varlen kernels: clouds of 20, 45, 33 and 11 points packed at ball 16
# to capacity 160 (the tail is segment S), q_offsets = offsets and
# k_offsets = offsets / ℓ as in the compression branch
# ---------------------------------------------------------------------------

def _varlen_case(dtype, dev, seed, sizes=(20, 45, 33, 11), pad_to=160, rep=REP,
                 dead_block=2):
    """Packed-varlen inputs and the host offsets (q_offsets, k_offsets) of
    clouds of ``sizes`` points packed at ball 16 to ``pad_to`` rows."""
    from repro_torch.core.balltree import pack_varlen
    from repro_torch.kernels.occupancy import varlen_maps
    _, offsets, mask = pack_varlen([np.zeros((n, 1)) for n in sizes], BALL, pad_to=pad_to,
                                   max_samples=len(sizes) + 1)
    T, L = pad_to, pad_to // ELL
    maps = varlen_maps(offsets, offsets // ELL, T, L, dev)
    blk = torch.from_numpy(mask.reshape(L, ELL).any(-1)).to(dev)
    blk[dead_block] = False                   # a dead block inside a segment
    q = _rand((HKV, rep, T, D), dtype, dev, seed)
    k = _rand((HKV, L, D), dtype, dev, seed + 1)
    v = _rand((HKV, L, D), dtype, dev, seed + 2)
    return ((q, k, v, _bias(blk)[None], maps.qseg[None], maps.kseg[None], maps.q_bounds,
             maps.k_bounds), (offsets, offsets // ELL))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_varlen_kernel(cuda, dtype):
    from repro_torch.kernels import varlen
    args, offsets = _varlen_case(dtype, cuda, 20)
    before = varlen.COUNT.n
    got = varlen.flash_attention_varlen_fwd(*args, offsets=offsets)
    torch.cuda.synchronize()
    assert varlen.COUNT.n == before + 1
    _check(got, varlen.flash_attention_varlen_fwd_plain(*args[:6]), dtype)
    assert bool((got[1][..., 144:] == 1e30).all())       # the tail sees no valid key


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_varlen_bwd_kernels(cuda, dtype):
    from repro_torch.kernels import varlen
    args, offsets = _varlen_case(dtype, cuda, 23)
    o, lse = varlen.flash_attention_varlen_fwd(*args, offsets=offsets)
    rest = _bwd_inputs(o, lse, dtype, 26)
    before = (varlen.COUNT_DQ.n, varlen.COUNT_DKV.n)
    got = varlen.flash_attention_varlen_bwd(*args, *rest, offsets=offsets)
    torch.cuda.synchronize()
    assert (varlen.COUNT_DQ.n, varlen.COUNT_DKV.n) == (before[0] + 1, before[1] + 1)
    _check(got, varlen.flash_attention_varlen_bwd_plain(*args[:6], *rest), dtype)
    assert bool((got[0][..., 144:, :] == 0).all())       # tail rows: exact zeros
    assert bool((got[1][:, 2] == 0).all())               # the dead block
    if dtype == torch.float32:                           # the fma path needs the offsets
        for fn in (varlen.flash_attention_varlen_dq, varlen.flash_attention_varlen_dkv):
            with pytest.raises(ValueError, match="offsets"):
                fn(*args, *rest)


@pytest.mark.parametrize("sms", [0, 10, 1000])
@pytest.mark.parametrize("rep", [1, 3])
def test_varlen_dkv_fma_edges(cuda, rep, sms, monkeypatch):
    """The fp32 ``varlen_dkv`` on its planned walk: segments of 76, 8 and 136
    pooled keys (ragged 64-key tiles; the 8-key segment has 32 rows, under
    one 64-row tile), a capacity tail of 20 keys with no valid key, a dead
    key block, every row of segment 1 set to LSE_EMPTY (a segment whose rows
    are all padding), rep 1 and 3, the row splits at 1, 3 and 9 (``sms``);
    against the plain version, with exact zeros on the tail's keys and on
    segment 1's, and identical bits on a second call."""
    from repro_torch.kernels import occupancy, varlen
    from repro_torch.kernels.common import LSE_EMPTY
    args, offsets = _varlen_case(torch.float32, cuda, 40, sizes=(300, 20, 530), pad_to=960,
                                 rep=rep, dead_block=5)
    plan = occupancy.varlen_dkv_tiles(*offsets, 960, 240, cuda, keys=64, rows=64,
                                      heads=HKV, sms=sms)
    assert plan.splits == {0: 1, 10: 3, 1000: 9}[sms] and plan.table.shape[0] == 7
    orig = occupancy.varlen_dkv_tiles
    monkeypatch.setattr(varlen, "varlen_dkv_tiles",
                        lambda *a, **kw: orig(*a, **{**kw, "sms": sms}))
    o, lse = varlen.flash_attention_varlen_fwd(*args, offsets=offsets)
    q0, q1 = int(offsets[0][1]), int(offsets[0][2])      # segment 1's rows
    lse[:, :, q0:q1] = LSE_EMPTY
    o[:, :, q0:q1] = 0
    rest = _bwd_inputs(o, lse, torch.float32, 41)
    before = varlen.COUNT_DKV.n
    got = varlen.flash_attention_varlen_dkv(*args, *rest, offsets=offsets)
    again = varlen.flash_attention_varlen_dkv(*args, *rest, offsets=offsets)
    torch.cuda.synchronize()
    assert varlen.COUNT_DKV.n == before + 2
    _check(got, varlen.flash_attention_varlen_bwd_plain(*args[:6], *rest)[1:], torch.float32)
    k0, k1, tail = int(offsets[1][1]), int(offsets[1][2]), int(offsets[1][-1])
    assert all(bool((g[:, k0:k1] == 0).all()) and bool((g[:, tail:] == 0).all())
               for g in got)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _varlen_no_keys_case(dev, rep):
    """Hand-made offsets: segment 0 owns rows [0, 32) and no key, segment 1
    rows [32, 96) and keys [0, 24) (key 5 dead), the capacity tail rows
    [96, 128) and keys [24, 32), all dead."""
    from repro_torch.kernels.occupancy import varlen_maps
    offsets = (np.array([0, 32, 96]), np.array([0, 0, 24]))
    T, L = 128, 32
    maps = varlen_maps(*offsets, T, L, dev)
    live = torch.arange(L, device=dev) < 24
    live[5] = False
    q = _rand((HKV, rep, T, D), torch.float32, dev, 60)
    k = _rand((HKV, L, D), torch.float32, dev, 61)
    v = _rand((HKV, L, D), torch.float32, dev, 62)
    return ((q, k, v, _bias(live)[None], maps.qseg[None], maps.kseg[None], maps.q_bounds,
             maps.k_bounds), offsets)


@pytest.mark.parametrize("case", ["packed", "no-keys"])
@pytest.mark.parametrize("rep", [1, 3])
def test_varlen_fwd_dq_fma_edges(cuda, rep, case):
    """The fp32 ``varlen_fwd`` and ``varlen_dq`` on their planned row walk.
    ``packed``: clouds of 300, 20 and 530 points packed to 960 rows
    (segments of 304, 32 and 544 rows: ragged 64-row tiles, a segment under
    one tile, key ranges that start off a multiple of 32), a capacity tail
    of 80 rows whose 20 keys hold no valid key, a dead key block.
    ``no-keys``: a segment with rows and an empty key range, a dead tail.
    rep 1 and 3; against the plain versions, with zeros, ``LSE_EMPTY`` and
    a zero dq on the rows that see no valid key, identical bits on a second
    call, and a ``ValueError`` without ``offsets``."""
    from repro_torch.kernels import occupancy, varlen
    from repro_torch.kernels.common import LSE_EMPTY
    if case == "packed":
        args, offsets = _varlen_case(torch.float32, cuda, 50, sizes=(300, 20, 530),
                                     pad_to=960, rep=rep, dead_block=5)
        T, L, n_tiles, empty = 960, 240, 17, slice(880, 960)
    else:
        args, offsets = _varlen_no_keys_case(cuda, rep)
        T, L, n_tiles, empty = 128, 32, 3, [*range(32), *range(96, 128)]
    plan = occupancy.varlen_row_tiles(*offsets, T, L, cuda, rows=64)
    assert plan.shape == (n_tiles, 4)
    before = (varlen.COUNT.n, varlen.COUNT_DQ.n)
    o, lse = varlen.flash_attention_varlen_fwd(*args, offsets=offsets)
    again = varlen.flash_attention_varlen_fwd(*args, offsets=offsets)
    rest = _bwd_inputs(o, lse, torch.float32, 51)
    dq = varlen.flash_attention_varlen_dq(*args, *rest, offsets=offsets)
    dq_again = varlen.flash_attention_varlen_dq(*args, *rest, offsets=offsets)
    torch.cuda.synchronize()
    assert (varlen.COUNT.n, varlen.COUNT_DQ.n) == (before[0] + 2, before[1] + 2)
    _check((o, lse), varlen.flash_attention_varlen_fwd_plain(*args[:6]), torch.float32)
    _check((dq,), varlen.flash_attention_varlen_bwd_plain(*args[:6], *rest)[:1],
           torch.float32)
    assert bool((lse[..., empty] == LSE_EMPTY).all())
    assert bool((o[..., empty, :] == 0).all()) and bool((dq[..., empty, :] == 0).all())
    assert all(torch.equal(a, b) for a, b in zip((o, lse, dq), (*again, dq_again)))
    for fn, extra in ((varlen.flash_attention_varlen_fwd, ()),
                      (varlen.flash_attention_varlen_dq, rest)):
        with pytest.raises(ValueError, match="offsets"):
            fn(*args, *extra)


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
    packed_bwd = ("bta_bwd", "varlen_dq", "varlen_dkv", "selection_bwd", "epilogue_bwd")
    assert all(c.n == (2 * cfg.n_layers if name in packed_path
                       else cfg.n_layers if name in packed_bwd else 0)
               for name, c in COUNTERS.items())
    torch.testing.assert_close(preds["kernels"], preds["reference"], atol=1e-3, rtol=1e-3)
    for name, want in grads["reference"].items():
        torch.testing.assert_close(grads["kernels"][name], want, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,segmented", [(32, False), (32, True), (256, False)])
@pytest.mark.parametrize("head_dim", [16, 128])
def test_local_kernel(cuda, dtype, window, segmented, head_dim):
    from repro_torch.kernels import local
    n = 4 * window
    q = _rand((B * HKV, REP, n, head_dim), dtype, cuda, 80)
    k = _rand((B * HKV, n, head_dim), dtype, cuda, 81)
    v = _rand((B * HKV, n, head_dim), dtype, cuda, 82)
    mask = torch.ones(B, n, dtype=torch.bool, device=cuda)
    mask[1, window + 5:2 * window + 9] = False      # a dead block and a ragged hole
    mask[2] = False                                 # a fully masked slot
    seg = None
    if segmented:
        seg = torch.tensor([[0, 0, 1, 1], [0, 1, 1, 2], [0, 0, 0, 0]], dtype=torch.int32,
                           device=cuda)
    kw = dict(window=window, n_heads=HKV)
    got = local.local_window_fwd(q, k, v, _bias(mask), seg, **kw)
    want = local.local_window_fwd_plain(q, k, v, _bias(mask), seg, **kw)
    _check(got, want, dtype)
    assert bool((got[0][2 * HKV:] == 0).all())     # the masked slot: exact zeros


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,segmented", [(32, False), (32, True), (256, False)])
@pytest.mark.parametrize("head_dim", [16, 128])
def test_local_bwd_kernels(cuda, dtype, window, segmented, head_dim):
    from repro_torch.kernels import local
    n = 4 * window
    q = _rand((B * HKV, REP, n, head_dim), dtype, cuda, 86)
    k = _rand((B * HKV, n, head_dim), dtype, cuda, 87)
    v = _rand((B * HKV, n, head_dim), dtype, cuda, 88)
    mask = torch.ones(B, n, dtype=torch.bool, device=cuda)
    mask[1, window + 5:2 * window + 9] = False      # a dead block and a ragged hole
    mask[2] = False                                 # a fully masked slot
    seg = None
    if segmented:
        seg = torch.tensor([[0, 0, 1, 1], [0, 1, 1, 2], [0, 0, 0, 0]], dtype=torch.int32,
                           device=cuda)
    kw = dict(window=window, n_heads=HKV)
    o, lse = local.local_window_fwd(q, k, v, _bias(mask), seg, **kw)
    rest = _bwd_inputs(o, lse, dtype, 15)
    before = (local.COUNT_DQ.n, local.COUNT_DKV.n)
    got = local.local_window_bwd(q, k, v, _bias(mask), seg, *rest, **kw)
    torch.cuda.synchronize()
    assert (local.COUNT_DQ.n, local.COUNT_DKV.n) == (before[0] + 1, before[1] + 1)
    _check(got, local.local_window_bwd_plain(q, k, v, _bias(mask), seg, *rest, **kw),
           dtype)
    assert all(bool((g[2 * HKV:] == 0).all()) for g in got)   # the masked slot


def _local_edges_case(dev, dtype, window, head_dim, rep=3):
    """Four blocks of ``window`` positions a sample, rep 3: sample 0 packed
    into two segments at block 2, sample 1 with a dead block (block 1
    wholly masked) and a ragged hole in block 2, sample 2 a masked slot."""
    n = 4 * window
    q = _rand((B * HKV, rep, n, head_dim), dtype, dev, 90)
    k = _rand((B * HKV, n, head_dim), dtype, dev, 91)
    v = _rand((B * HKV, n, head_dim), dtype, dev, 92)
    mask = torch.ones(B, n, dtype=torch.bool, device=dev)
    mask[1, window:2 * window] = False               # a dead block: its halves dead
    mask[1, 2 * window + 3:2 * window + 40] = False  # a ragged hole
    mask[2] = False                                  # a fully masked slot
    seg = torch.tensor([[0, 0, 1, 1], [0, 0, 0, 0], [0, 0, 0, 0]], dtype=torch.int32,
                       device=dev)
    return q, k, v, _bias(mask), seg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [64, 128, 256])
@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
def test_local_bwd_tiled_edges(cuda, head_dim, window, dtype):
    """``local_dq`` / ``local_dkv`` on the path ``local_plan`` picks (bf16:
    the tiled path at windows 64–256; fp32: the lanes path) against the
    plain version: rep 3, packed segments, a dead block, a ragged hole, a
    masked slot, and a 64-row span of one head set to ``LSE_EMPTY`` (those
    rows get exact zeros in dq and add nothing to dk, dv).  One launch of
    each kernel a call."""
    from repro_torch.kernels import local
    from repro_torch.kernels.common import LSE_EMPTY
    q, k, v, kb, seg = _local_edges_case(cuda, dtype, window, head_dim)
    kw = dict(window=window, n_heads=HKV)
    o, lse = local.local_window_fwd(q, k, v, kb, seg, **kw)
    lse[0, 1, 64:128] = LSE_EMPTY
    o[0, 1, 64:128] = 0
    rest = _bwd_inputs(o, lse, dtype, 93)
    before = (local.COUNT_DQ.n, local.COUNT_DKV.n)
    got = local.local_window_bwd(q, k, v, kb, seg, *rest, **kw)
    torch.cuda.synchronize()
    assert (local.COUNT_DQ.n, local.COUNT_DKV.n) == (before[0] + 1, before[1] + 1)
    _check(got, local.local_window_bwd_plain(q, k, v, kb, seg, *rest, **kw), dtype)
    assert bool((got[0][0, 1, 64:128] == 0).all())
    assert all(bool((g[2 * HKV:] == 0).all()) for g in got)   # the masked slot


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("window", [64, 128, 256])
@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
def test_local_fwd_tiled_edges(cuda, head_dim, window, segmented, dtype):
    """``local_fwd`` on the path ``local_plan`` picks (bf16: the tiled
    ``local_fwd_mma``; fp32: ``local_fwd_rows``) against the plain version,
    rep 3: a padded tail, a ragged hole, a fully masked slot and a block with
    both halves dead (its rows: exact zeros and ``LSE_EMPTY``), with and
    without packed segments; then ``local_dq`` / ``local_dkv`` from the new
    forward's (o, lse) against their plain version.  One launch a call."""
    from repro_torch.kernels import local
    from repro_torch.kernels.common import LSE_EMPTY
    w, n = window, 4 * window
    q = _rand((B * HKV, 3, n, head_dim), dtype, cuda, 95)
    k = _rand((B * HKV, n, head_dim), dtype, cuda, 96)
    v = _rand((B * HKV, n, head_dim), dtype, cuda, 97)
    mask = torch.ones(B, n, dtype=torch.bool, device=cuda)
    mask[0, 3 * w + w // 3:] = False                 # a padded tail
    mask[1, :2 * w] = False                          # block 1: both halves dead
    mask[1, 2 * w + 3:2 * w + 40] = False            # a ragged hole
    mask[2] = False                                  # a fully masked slot
    seg = (torch.tensor([[0, 0, 1, 1], [0, 1, 1, 2], [0, 0, 0, 0]], dtype=torch.int32,
                        device=cuda) if segmented else None)
    kw = dict(window=w, n_heads=HKV)
    assert local.local_plan(w, head_dim, dtype).path == (
        "tiles" if dtype == torch.bfloat16 else "lanes")
    before = local.COUNT.n
    o, lse = local.local_window_fwd(q, k, v, _bias(mask), seg, **kw)
    torch.cuda.synchronize()
    assert local.COUNT.n == before + 1
    _check((o, lse), local.local_window_fwd_plain(q, k, v, _bias(mask), seg, **kw), dtype)
    assert bool((o[HKV:2 * HKV, :, :2 * w] == 0).all())             # dead halves
    assert bool((lse[HKV:2 * HKV, :, :2 * w] == LSE_EMPTY).all())
    assert bool((o[2 * HKV:] == 0).all()) and bool((lse[2 * HKV:] == LSE_EMPTY).all())
    rest = _bwd_inputs(o, lse, dtype, 98)
    got = local.local_window_bwd(q, k, v, _bias(mask), seg, *rest, **kw)
    torch.cuda.synchronize()
    _check(got, local.local_window_bwd_plain(q, k, v, _bias(mask), seg, *rest, **kw),
           dtype)


def test_local_bwd_tiles_deterministic(cuda):
    """The tiled backward sums in a fixed order: two bf16 runs give
    bit-identical dq, dk, dv."""
    from repro_torch.kernels import local
    q, k, v, kb, seg = _local_edges_case(cuda, torch.bfloat16, 256, 64)
    kw = dict(window=256, n_heads=HKV)
    assert local.local_plan(256, 64, torch.bfloat16).path == "tiles"
    o, lse = local.local_window_fwd(q, k, v, kb, seg, **kw)
    rest = _bwd_inputs(o, lse, torch.bfloat16, 94)
    first = local.local_window_bwd(q, k, v, kb, seg, *rest, **kw)
    second = local.local_window_bwd(q, k, v, kb, seg, *rest, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_lm_train_step_grads_match_reference(cuda):
    """A 2-layer smoke tinyllama with remat on the card: the backward
    launches each LM backward kernel once a layer and each forward kernel
    twice (the forward and its recompute), and every gradient matches the
    reference backend's."""
    from repro_torch.configs import get_config
    from repro_torch.configs.reduce import smoke_config
    from repro_torch.core.backend import use_backend
    from repro_torch.kernels.common import COUNTERS, reset_counters
    from repro_torch.models.api import model_api
    cfg = smoke_config(get_config("tinyllama-1.1b")).scaled(remat=True)
    api = model_api(cfg)
    model = api.init(0)
    batch = api.make_batch(np.random.default_rng(0), 2, 128)
    grads = {}
    for backend in ("reference", "auto"):              # "auto" → kernels on cuda
        model.zero_grad(set_to_none=True)
        reset_counters()
        with use_backend(backend):
            loss, _ = api.loss(model, batch)
            loss.backward()
        grads[backend] = {n: p.grad.clone() for n, p in model.named_parameters()
                          if p.grad is not None}      # phi_q only feeds top-k
    lm_fwd = ("local_fwd", "flash_fwd", "selection_fwd", "epilogue_fwd")
    lm_bwd = ("local_dq", "local_dkv", "flash_dq", "flash_dkv", "selection_dq",
              "selection_dkv", "epilogue_bwd")
    assert {n: c.n for n, c in COUNTERS.items()} == {
        n: (2 * cfg.n_layers if n in lm_fwd else cfg.n_layers if n in lm_bwd else 0)
        for n in COUNTERS}
    assert sorted(grads["auto"]) == sorted(grads["reference"])
    for name, want in grads["reference"].items():
        torch.testing.assert_close(grads["auto"][name], want, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("index", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype,shape", [(torch.float32, (40, 2, 16)),
                                         (torch.bfloat16, (40, 2, 16)),
                                         (torch.float32, (40, 1, 3)),     # 4-byte words
                                         (torch.bfloat16, (40, 1, 3))])   # bytes
def test_paged_gather_kernel(cuda, dtype, shape, index):
    """int32 and int64 rows, exact, past the end, from the end and before 0;
    one call is one kernel on the card (the profiler's trace), whatever the
    index type."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import paged
    pool = _rand(shape, dtype, cuda, 85)
    g = torch.Generator(device=cuda).manual_seed(0)
    rows = torch.randint(0, 40, (5, 9), generator=g, device=cuda).to(index)
    rows[0, :4] = torch.tensor([40, 57, -1, -45])  # past the end, from the end, before 0
    got = paged.paged_gather(pool, rows)
    assert got.shape == (5, 9) + shape[1:]
    torch.testing.assert_close(got, paged.paged_gather_plain(pool, rows), atol=0, rtol=0)
    torch.cuda.synchronize()
    for _ in range(3):          # a trace now and then holds no device event: take it again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            paged.paged_gather(pool, rows)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if kernels:
            break
    assert [e.name for e in kernels if "paged_gather" in e.name] == \
        [e.name for e in kernels] and len(kernels) == 1, [e.name for e in kernels]


@pytest.mark.parametrize("index", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype,shape,shift", [(torch.float32, (40, 2, 16), 0),
                                               (torch.bfloat16, (40, 2, 16), 0),
                                               (torch.float32, (40, 2, 16), 1),  # words
                                               (torch.bfloat16, (40, 1, 3), 0)])  # bytes
def test_paged_gather_pair_kernel(cuda, dtype, shape, shift, index):
    """The pair kernel equals two plain gathers exactly, int32 and int64
    rows past the end, from the end and before 0, pools off 16 bytes;
    two calls give the same bits, and one call is one kernel on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import paged
    n = int(np.prod(shape))
    pools = [_rand((n + shift,), dtype, cuda, 86 + i)[shift:].view(shape) for i in range(2)]
    g = torch.Generator(device=cuda).manual_seed(1)
    rows = torch.randint(0, 40, (5, 9), generator=g, device=cuda).to(index)
    rows[0, :4] = torch.tensor([40, 57, -1, -45])
    before = paged.COUNT_PAIR.n
    k, v = paged.paged_gather_pair(*pools, rows)
    k2, v2 = paged.paged_gather_pair(*pools, rows)
    torch.cuda.synchronize()
    assert paged.COUNT_PAIR.n == before + 2
    assert k.shape == v.shape == (5, 9) + shape[1:]
    for got, again, want in zip((k, v), (k2, v2), paged.paged_gather_pair_plain(*pools, rows)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
        assert torch.equal(got, again)
    for _ in range(3):          # a trace now and then holds no device event: take it again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            paged.paged_gather_pair(*pools, rows)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if kernels:
            break
    assert len(kernels) == 1 and "paged_gather" in kernels[0], kernels


def test_lm_kernels_match_reference(cuda):
    """A 2-layer smoke tinyllama on the card: the forward launches the four
    LM forward kernels once a layer and matches the reference backend; the
    paged decode launches 4 pair gathers a layer and step and matches too."""
    from repro_torch.configs import get_config
    from repro_torch.configs.reduce import smoke_config
    from repro_torch.core.backend import use_backend
    from repro_torch.kernels.common import COUNTERS, reset_counters
    from repro_torch.models.api import model_api
    cfg = smoke_config(get_config("tinyllama-1.1b"))
    api = model_api(cfg)
    model = api.init(0)
    batch = api.make_batch(np.random.default_rng(0), 2, 128)
    with use_backend("reference"):
        want = api.forward(model, batch)
    reset_counters()
    got = api.forward(model, batch)                    # "auto" → kernels on cuda
    lm_fwd = ("local_fwd", "flash_fwd", "selection_fwd", "epilogue_fwd")
    assert {n: c.n for n, c in COUNTERS.items()} == {
        n: (cfg.n_layers if n in lm_fwd else 0) for n in COUNTERS}
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)
    caches = {b: api.paged_cache_init(2, 8, 32, torch.float32) for b in ("kernels", "ref")}
    table = torch.tensor([[3, 0, 8, 8], [5, 1, 2, 8]], device=cuda)
    for t in range(40):
        tok = batch["tokens"][:, t]
        lengths = torch.tensor([t, max(t - 3, 0)], device=cuda)
        reset_counters()
        got, caches["kernels"] = api.paged_decode_step(model, tok, caches["kernels"], table,
                                                       lengths, 32)
        assert COUNTERS["paged_gather_pair"].n == 4 * cfg.n_layers
        assert COUNTERS["paged_gather"].n == 0
        with use_backend("reference"):
            want, caches["ref"] = api.paged_decode_step(model, tok, caches["ref"], table,
                                                        lengths, 32)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the paper's other workloads: full attention (the flash kernels at a square
# shape), Erwin (the ball kernels on pooled sequences), group compression
# with φ = "mlp"
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", [16, 32])
def test_flash_square_key_mask(cuda, head_dim, dtype):
    """The full baseline's shape: N queries against N keys with a key mask
    (a padded tail, a fully masked slot), no ``q_valid``: forward, dq and
    dkv against the plain versions, one launch each, and ``flash_dkv``'s
    bits identical on two calls."""
    from repro_torch.kernels import flash
    n = 200
    q = _rand((B * HKV, REP, n, head_dim), dtype, cuda, 60)
    k = _rand((B * HKV, n, head_dim), dtype, cuda, 61)
    v = _rand((B * HKV, n, head_dim), dtype, cuda, 62)
    kv = torch.ones(B, n, dtype=torch.bool, device=cuda)
    kv[1, 131:] = False
    kv[2] = False
    kw = dict(n_heads=HKV)
    before = (flash.COUNT.n, flash.COUNT_DQ.n, flash.COUNT_DKV.n)
    o, lse = flash.flash_attention_fwd(q, k, v, _bias(kv), **kw)
    _check((o, lse), flash.flash_attention_fwd_plain(q, k, v, _bias(kv), **kw), dtype)
    args = (q, k, v, _bias(kv), *_bwd_inputs(o, lse, dtype, 63))
    dq = flash.flash_attention_dq(*args, **kw)
    dkv = flash.flash_attention_dkv(*args, **kw)
    again = flash.flash_attention_dkv(*args, **kw)
    torch.cuda.synchronize()
    assert (flash.COUNT.n, flash.COUNT_DQ.n, flash.COUNT_DKV.n) == (
        before[0] + 1, before[1] + 1, before[2] + 2)
    _check((dq, *dkv), flash.flash_attention_bwd_plain(*args, **kw), dtype)
    assert all(torch.equal(a, b) for a, b in zip(dkv, again))


@pytest.mark.parametrize("level", [0, 1, 2])
def test_erwin_attention_kernels_match_reference(cuda, level):
    """``erwin_attention`` on the ``kernels`` backend (the ball kernels on
    the fma path: fp32, D 16, ball 64) against ``reference``, forward and
    gradients, one ``bta_fwd`` and one ``bta_bwd`` a call."""
    from repro_torch.core.backend import use_backend
    from repro_torch.core.erwin import erwin_attention
    from repro_torch.kernels import bta
    from repro_torch.kernels.common import COUNTERS, reset_counters
    n, ball = 256, 64
    assert bta.bta_plan(ball, D, REP, torch.float32).path == "fma"
    leaves = [_rand((B, n, h, D), torch.float32, cuda, 70 + i)
              for i, h in enumerate((HQ, HKV, HKV))]
    mask = torch.ones(B, n, dtype=torch.bool, device=cuda)
    mask[1, 99:] = False                       # a partial pooled token at levels 1, 2
    mask[2, 128:] = False                      # a dead coarse ball at level 1
    do = _rand((B, n, HQ, D), torch.float32, cuda, 73)
    got = {}
    for backend in ("reference", "kernels"):
        xs = [t.clone().requires_grad_(True) for t in leaves]
        reset_counters()
        with use_backend(backend):
            out = erwin_attention(*xs, ball_size=ball, level=level, mask=mask)
        out.backward(do)
        got[backend] = (out.detach(), *(x.grad for x in xs))
    assert {name: c.n for name, c in COUNTERS.items()} == {
        name: int(name in ("bta_fwd", "bta_bwd")) for name in COUNTERS}
    _check(got["kernels"], got["reference"], torch.float32)


def test_group_compression_mlp_phi_kernels_match_reference(cuda):
    """``bsa_attention`` with group compression and φ = "mlp": the pooled
    queries (the MLP φ) against the pooled keys in ``flash``, on the
    ``kernels`` backend against ``reference``, forward and gradients
    (parameters too)."""
    from repro_torch.core.backend import use_backend
    from repro_torch.core.bsa import bsa_attention, bsa_init
    from repro_torch.core.config import BSAConfig
    cfg = BSAConfig(ball_size=BALL, cmp_block=ELL, slc_block=ELL, top_k=2, group_size=4,
                    group_compression=True, phi="mlp")
    params = bsa_init(cfg, n_heads=HQ, n_kv_heads=HKV, head_dim=D, d_model=32,
                      generator=torch.Generator().manual_seed(0), device=cuda)
    leaves = [_rand((B, N, h, D), torch.float32, cuda, 80 + i)
              for i, h in enumerate((HQ, HKV, HKV))]
    do = _rand((B, N, HQ, D), torch.float32, cuda, 83)
    got = {}
    for backend in ("reference", "kernels"):
        params.zero_grad(set_to_none=True)
        xs = [t.clone().requires_grad_(True) for t in leaves]
        with use_backend(backend):
            out = bsa_attention(params, *xs, cfg=cfg, mask=_mask(cuda))
        out.backward(do)
        got[backend] = (out.detach(), *(x.grad for x in xs),
                        *(p.grad for p in params.parameters() if p.grad is not None))
    assert len(got["kernels"]) == len(got["reference"]) > 4 + 10   # φ_q/k/v's fc1, fc2
    _check(got["kernels"], got["reference"], torch.float32,
           tol=dict(atol=1e-3, rtol=1e-3))
