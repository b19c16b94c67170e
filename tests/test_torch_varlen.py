"""The port's packed-varlen layout against the JAX package, on the CPU.

All clouds of a batch on one token axis with an ``offsets`` boundary array:
``numerics.segment_ids_from_offsets``, ``balltree.pack_varlen`` /
``unpack_varlen``, the varlen maps, the varlen kernel's plain versions
(forward and backward, against the Pallas kernel in interpret mode), a
plain walk of the fp32 ``varlen_dkv``'s planned key tiles and row splits
(against the plain backward and the Pallas ``_dkv_kernel``), one of the
fp32 ``varlen_fwd`` / ``varlen_dq``'s planned row tiles (against the plain
versions and the Pallas ``_fwd_kernel`` / ``_dq_kernel``),
``ops.flash_attention_varlen``, ``bsa_attention_varlen`` (branch by branch
and its gradients), ``pc_apply`` with offsets, a 2-layer packed train step
and ``GeometryEngine`` in its default (packed) layout.  The same numpy
inputs from a seed go to both packages.  Size mixes of prime-ish lengths, a
singleton cloud and a max-variance pair, ball 16, ℓ 8, Hq 4 / Hkv 2, D 16.
Tolerances: the kernels' plain versions fp32 1e-4, bf16 4e-2; BSA and its
gradients 1e-5 on the reference backend, 1e-3 on the kernel path (as the
JAX suite's varlen tests); whole models 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.core import balltree as j_bt
from repro.core import bsa as j_bsa
from repro.core.config import BSAConfig as JBSAConfig
from repro.kernels import occupancy as j_occ
from repro.kernels import ops as j_ops
from repro.kernels import varlen as j_varlen
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import pointcloud as j_pc
from repro.models.api import model_api as j_model_api
from repro.numerics import segment_ids_from_offsets as j_segment_ids
from repro.optim import adamw as j_adamw
from repro.serving.engine import GeometryEngine as JGeometryEngine
from repro_torch.configs import ModelConfig
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core import balltree as t_bt
from repro_torch.core import bsa as t_bsa
from repro_torch.core.backend import (ReferenceBackend, get_varlen, register_backend,
                                      use_backend)
from repro_torch.core.config import BSAConfig
from repro_torch.kernels import occupancy as t_occ
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import varlen as t_varlen
from repro_torch.kernels.common import LSE_EMPTY, p_from_lse, row_delta
from repro_torch.launch.steps import make_train_step
from repro_torch.models import pointcloud as t_pc
from repro_torch.models.api import model_api
from repro_torch.models.attention_layer import attention_layer_apply
from repro_torch.numerics import NEG_INF, segment_ids_from_offsets
from repro_torch.optim import adamw_init
from repro_torch.serving.engine import GeometryEngine

MIXES = [(20, 45, 33, 11), (64, 1, 37), (128, 16)]
BALL, ELL, HQ, HKV, D, DM = 16, 8, 4, 2, 16, 64
BSA = dict(ball_size=BALL, cmp_block=ELL, slc_block=ELL, top_k=2, group_size=8)
TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=4e-2, rtol=4e-2)}
MODEL_TOL = dict(atol=1e-3, rtol=1e-3)
MODEL = dict(name="tiny-bsa", family="pointcloud", n_layers=2, d_model=32, n_heads=HQ,
             n_kv_heads=HKV, head_dim=D, d_ff=64, in_dim=7, out_dim=1, attention="bsa",
             param_dtype="float32", compute_dtype="float32")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _clouds(sizes, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda n, h: rng.standard_normal((n, h, D)).astype(np.float32)
    return [mk(n, HQ) for n in sizes], [mk(n, HKV) for n in sizes], [mk(n, HKV) for n in sizes]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def _assert_trees_close(got: dict, want: dict, **tol):
    g, w = _flat(got), _flat(jax.tree.map(np.asarray, want))
    assert sorted(g) == sorted(w)
    for name in w:
        np.testing.assert_allclose(g[name], w[name], err_msg=name, **tol)


def _pack(arrays, **kw):
    packed, offsets, mask = t_bt.pack_varlen(arrays, BALL, **kw)
    return packed, offsets, mask


# ---------------------------------------------------------------------------
# host side: segment ids, packing, maps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offsets,length", [([0, 16, 48, 64, 64], 80),
                                            ([0, 32, 32, 96], 96),
                                            ([0, 0, 16], 40),
                                            ([0, 128], 128)])
def test_segment_ids_match_jax(offsets, length):
    got = segment_ids_from_offsets(np.asarray(offsets, np.int32), length)
    want = np.asarray(j_segment_ids(jnp.asarray(offsets, jnp.int32), length))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[offsets[-1]:] == len(offsets) - 1).all()   # the tail: id S


@pytest.mark.parametrize("kw", [{}, dict(pad_to=256), dict(max_samples=6),
                                dict(geometric=False)], ids=str)
@pytest.mark.parametrize("sizes", MIXES)
def test_pack_varlen_matches_jax(sizes, kw):
    rng = np.random.default_rng(len(sizes))
    arrays = [rng.standard_normal((n, 5)).astype(np.float32) for n in sizes]
    got = t_bt.pack_varlen(arrays, BALL, **kw)
    want = j_bt.pack_varlen(arrays, BALL, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    packed, offsets, mask = got
    for a, b, c in zip(t_bt.unpack_varlen(packed, offsets, mask),
                       j_bt.unpack_varlen(packed, offsets, mask), arrays + [None] * 6):
        np.testing.assert_array_equal(a, b)
        if c is not None:
            np.testing.assert_array_equal(a, c)
    for a, b in zip(t_bt.unpack_varlen(packed, offsets), j_bt.unpack_varlen(packed, offsets)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [dict(pad_to=16), dict(pad_to=50), dict(max_samples=3)],
                         ids=str)
def test_pack_varlen_refusals_match_jax(kw):
    arrays = [np.zeros((20, 2), np.float32)] * 4
    with pytest.raises(ValueError):
        j_bt.pack_varlen(arrays, BALL, **kw)
    with pytest.raises(ValueError):
        t_bt.pack_varlen(arrays, BALL, **kw)
    with pytest.raises(ValueError):
        t_bt.pack_varlen([], BALL)


@pytest.mark.parametrize("sizes", MIXES)
def test_varlen_maps_match_jax(sizes):
    _, offsets, _ = _pack([np.zeros((n, 1)) for n in sizes], pad_to=256, max_samples=4)
    T, L, tq, tk = 256, 256 // ELL, 64, 16
    maps = t_occ.varlen_maps(torch.from_numpy(offsets), offsets // ELL, T, L, "cpu")
    jq, jk, jqr, jkr = j_occ.cached_varlen_maps(offsets, offsets // ELL, T, L, tq, tk)
    np.testing.assert_array_equal(maps.qseg.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(maps.kseg.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(maps.q_bounds.numpy(), list(offsets) + [T])
    np.testing.assert_array_equal(maps.k_bounds.numpy(), list(offsets // ELL) + [L])
    qrng, krng = t_occ.tile_seg_ranges(maps.qseg, tq), t_occ.tile_seg_ranges(maps.kseg, tk)
    np.testing.assert_array_equal(qrng.numpy(), np.asarray(jqr))
    np.testing.assert_array_equal(krng.numpy(), np.asarray(jkr))
    np.testing.assert_array_equal(t_occ.ranges_live_map(qrng, krng).numpy(),
                                  np.asarray(j_occ.ranges_live_map(jqr, jkr)))
    # one build per layout: a second call hands back the same tensors
    again = t_occ.varlen_maps(offsets, torch.from_numpy(offsets // ELL), T, L, "cpu")
    assert all(a is b for a, b in zip(maps, again))
    with pytest.raises(ValueError, match="host"):        # never read back from a card
        t_occ.offsets_key(torch.zeros(3, dtype=torch.int32, device="meta"))
    for bad in ([0, 48, 32], [0, 16, T + 16], [-16, 16]):  # the kernels would read past
        with pytest.raises(ValueError, match="non-decreasing"):
            t_occ.varlen_maps(bad, bad, T, T, "cpu")


# ---------------------------------------------------------------------------
# the kernel's plain versions against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

def _kernel_case(sizes, seed, dtype):
    """The compression branch's shapes: T packed rows against L = T/ℓ
    pooled keys, q_offsets = offsets, k_offsets = offsets / ℓ, the key bias
    of the block validity.  Returns numpy (q, k, v, key_bias), offsets."""
    _, offsets, mask = _pack([np.zeros((n, 1)) for n in sizes], max_samples=len(sizes) + 1)
    T = mask.shape[0]
    L = T // ELL
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((HKV, HQ // HKV, T, D)).astype(np.float32)
    k = rng.standard_normal((HKV, L, D)).astype(np.float32)
    v = rng.standard_normal((HKV, L, D)).astype(np.float32)
    kb = np.where(mask.reshape(L, ELL).any(-1), 0.0, -1e30).astype(np.float32)[None]
    if dtype == "bfloat16":     # both packages see the same bf16 values
        q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (q, k, v))
    return (q, k, v, kb), offsets


def _jax_maps(offsets, T, L, tq=64, tk=16):
    return j_occ.cached_varlen_maps(offsets, offsets // ELL, T, L, min(tq, T), min(tk, L))


def _torch_args(arrays, offsets, dtype):
    q, k, v, kb = arrays
    T, L = q.shape[2], k.shape[1]
    maps = t_occ.varlen_maps(offsets, offsets // ELL, T, L, "cpu")
    dt = getattr(torch, dtype)
    return ([torch.from_numpy(np.asarray(a, np.float32)).to(dt) for a in (q, k, v)]
            + [torch.from_numpy(kb), maps.qseg[None], maps.kseg[None], maps.q_bounds,
               maps.k_bounds])


@pytest.mark.parametrize("sizes,dtype", [(MIXES[0], "float32"), (MIXES[1], "float32"),
                                         (MIXES[2], "float32"), (MIXES[0], "bfloat16")])
def test_varlen_fwd_plain_matches_pallas(sizes, dtype):
    arrays, offsets = _kernel_case(sizes, 1, dtype)
    q, k, v, kb = arrays
    T, L = q.shape[2], k.shape[1]
    qseg, kseg, qrng, krng = _jax_maps(offsets, T, L)
    jdt = getattr(jnp, dtype)
    want = j_varlen._fwd_call(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                              jnp.asarray(kb), qseg[None], kseg[None], qrng, krng,
                              tq=min(64, T), tk=min(16, L), interpret=True, compute=dtype)
    got = t_varlen.flash_attention_varlen_fwd(*_torch_args(arrays, offsets, dtype))
    assert got[0].dtype == getattr(torch, dtype) and got[1].dtype == torch.float32
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), **TOL[dtype])
    empty = np.asarray(want[1]) >= 5e29                  # rows that see no valid key
    assert empty[..., offsets[-1]:].all()                # the capacity tail among them
    np.testing.assert_array_equal(_np(got[1]) >= 5e29, empty)
    np.testing.assert_allclose(_np(got[1])[~empty], np.asarray(want[1])[~empty],
                               **TOL[dtype])


@pytest.mark.parametrize("sizes,dtype", [(MIXES[0], "float32"), (MIXES[1], "bfloat16")])
def test_varlen_bwd_plain_matches_pallas(sizes, dtype):
    arrays, offsets = _kernel_case(sizes, 2, dtype)
    q, k, v, kb = arrays
    T, L = q.shape[2], k.shape[1]
    do = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)
    qseg, kseg, qrng, krng = _jax_maps(offsets, T, L)
    jdt = getattr(jnp, dtype)

    def j_fn(q, k, v):
        return j_varlen.flash_attention_varlen_kernel_call(
            q, k, v, jnp.asarray(kb), qseg[None], kseg[None], qrng, krng,
            tq=min(64, T), tk=min(16, L), interpret=True)

    _, vjp = jax.vjp(j_fn, *(jnp.asarray(a, jdt) for a in (q, k, v)))
    want = vjp(jnp.asarray(do, jdt))
    args = _torch_args(arrays, offsets, dtype)
    o, lse = t_varlen.flash_attention_varlen_fwd(*args)
    tdo = torch.from_numpy(do).to(getattr(torch, dtype))
    got = t_varlen.flash_attention_varlen_bwd(*args, tdo, lse, row_delta(tdo, o))
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **TOL[dtype])
    assert (_np(got[0])[..., offsets[-1]:, :] == 0).all()  # tail rows: exact zeros


def _planned_dkv_walk(q, k, v, key_bias, do, lse, delta, tiles):
    """A plain-PyTorch walk of ``varlen_dkv``'s fma plan: each (key tile,
    split) block's dK, dV partials over its rows (no segment test: a tile's
    rows are its segment's), summed in split order, as the kernel and its
    second pass sum them."""
    H, rep, T, D = q.shape
    scale = D ** -0.5
    S = tiles.splits
    parts = torch.zeros((2, S) + tuple(k.shape))
    for t in tiles.table.tolist():
        for s, (j0, nk, lo, hi) in enumerate(t):
            keys = slice(j0, j0 + nk)
            qf, dof = q[:, :, lo:hi].float(), do[:, :, lo:hi].float()
            logits = (torch.matmul(qf, k[:, None, keys].float().transpose(-1, -2)) * scale
                      + key_bias[0, keys])
            p = p_from_lse(logits, lse[:, :, lo:hi, None])
            dp = torch.matmul(dof, v[:, None, keys].float().transpose(-1, -2))
            ds = p * (dp - delta[:, :, lo:hi, None]) * scale
            parts[1, s, :, keys] = torch.einsum("hrnl,hrnd->hld", p, dof)
            parts[0, s, :, keys] = torch.einsum("hrnl,hrnd->hld", ds, qf)
    out = parts[:, 0]
    for s in range(1, S):
        out = out + parts[:, s]
    return out[0], out[1]


@pytest.mark.parametrize("keys,rows", [(64, 64), (4, 16)], ids=["kernel", "small"])
@pytest.mark.parametrize("sizes", MIXES)
def test_varlen_dkv_planned_walk_matches_plain_and_pallas(sizes, keys, rows):
    """The fp32 ``varlen_dkv``'s planned walk (``occupancy.varlen_dkv_tiles``
    at the kernel's 64 keys / 64 rows, and at 4 keys / 16 rows for many
    tiles and splits a segment) summed in split order equals the plain
    backward's dk, dv and JAX's ``_dkv_kernel`` in interpret mode (fp32,
    1e-4), capacity tail and empty segments included."""
    arrays, offsets = _kernel_case(sizes, 7, "float32")
    q, k, v, kb = arrays
    T, L = q.shape[2], k.shape[1]
    args = _torch_args(arrays, offsets, "float32")
    o, lse = t_varlen.flash_attention_varlen_fwd_plain(*args[:6])
    do = torch.from_numpy(np.random.default_rng(8).standard_normal(q.shape).astype(np.float32))
    delta = row_delta(do, o)
    tiles = t_occ.varlen_dkv_tiles(offsets, offsets // ELL, T, L, "cpu", keys=keys, rows=rows,
                                   heads=HKV, sms=1000)
    assert tiles.splits > 1 or keys == 64
    got = _planned_dkv_walk(*args[:4], do, lse, delta, tiles)
    want = t_varlen.flash_attention_varlen_bwd_plain(*args[:6], do, lse, delta)[1:]
    qseg, kseg, qrng, krng = _jax_maps(offsets, T, L)
    jax_dkv = j_varlen._bwd_calls(
        *(jnp.asarray(a) for a in (q, k, v, kb)), qseg[None], kseg[None], qrng, krng,
        jnp.asarray(do.numpy()), jnp.asarray(lse.numpy()), jnp.asarray(delta.numpy()),
        tq=min(64, T), tk=min(16, L), interpret=True, compute="float32")[1:]
    for g, w, j, name in zip(got, want, jax_dkv, ("dk", "dv")):
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **TOL["float32"])
        np.testing.assert_allclose(_np(g), _np(j), err_msg=name, **TOL["float32"])


def _planned_row_walk(q, k, v, key_bias, do, table):
    """A plain-PyTorch walk of the fp32 ``varlen_fwd`` / ``varlen_dq``'s plan
    (``occupancy.varlen_row_tiles``): each row tile against its key range
    with the key bias only (no segment test).  The forward ends each row's
    softmax as the kernel's store does (zeros and ``LSE_EMPTY`` for a row
    that sees no valid key, or a tile with no key); dq comes from that lse
    and δ.  Returns (o, lse, dq), NaN where no tile wrote."""
    H, rep, T, D = q.shape
    scale = D ** -0.5
    o, dq = torch.full(q.shape, float("nan")), torch.full(q.shape, float("nan"))
    lse = torch.full((H, rep, T), float("nan"))
    tiles = [(slice(t0, t0 + n), slice(k0, k1)) for t0, n, k0, k1 in table.tolist()]
    for rows, keys in tiles:
        logits = (torch.matmul(q[:, :, rows], k[:, None, keys].transpose(-1, -2)) * scale
                  + key_bias[0, keys])
        live = logits > NEG_INF / 2
        m = logits.amax(-1, keepdim=True) if keys.stop > keys.start else 0.0
        p = torch.where(live, torch.exp(logits - m), 0.0)
        l = p.sum(-1, keepdim=True)
        o[:, :, rows] = torch.where(l > 0, torch.matmul(p, v[:, None, keys]) / l, 0.0)
        lse[:, :, rows] = torch.where(l > 0, m + torch.log(l), LSE_EMPTY)[..., 0]
    delta = row_delta(do, o)
    for rows, keys in tiles:
        logits = (torch.matmul(q[:, :, rows], k[:, None, keys].transpose(-1, -2)) * scale
                  + key_bias[0, keys])
        p = p_from_lse(logits, lse[:, :, rows, None])
        dp = torch.matmul(do[:, :, rows], v[:, None, keys].transpose(-1, -2))
        ds = p * (dp - delta[:, :, rows, None]) * scale
        dq[:, :, rows] = torch.matmul(ds, k[:, None, keys])
    return o, lse, dq


@pytest.mark.parametrize("rows", [64, 16], ids=["kernel", "small"])
@pytest.mark.parametrize("sizes", MIXES)
def test_varlen_row_walk_matches_plain_and_pallas(sizes, rows):
    """The fp32 ``varlen_fwd`` and ``varlen_dq``'s planned walk
    (``occupancy.varlen_row_tiles`` at the kernels' 64 rows, and at 16 for
    many tiles that end at segment boundaries off a multiple of 64) equals
    the plain versions' (o, lse) and dq and JAX's ``_fwd_kernel`` /
    ``_dq_kernel`` in interpret mode (fp32, 1e-4), capacity tail and empty
    segments included; every row is written, and the tail's rows end with
    lse = ``LSE_EMPTY`` and dq = 0."""
    arrays, offsets = _kernel_case(sizes, 9, "float32")
    q, k, v, kb = arrays
    T, L = q.shape[2], k.shape[1]
    args = _torch_args(arrays, offsets, "float32")
    table = t_occ.varlen_row_tiles(offsets, offsets // ELL, T, L, "cpu", rows=rows)
    do = torch.from_numpy(np.random.default_rng(10).standard_normal(q.shape).astype(np.float32))
    got = _planned_row_walk(*args[:4], do, table)
    o, lse = t_varlen.flash_attention_varlen_fwd_plain(*args[:6])
    dq = t_varlen.flash_attention_varlen_bwd_plain(*args[:6], do, lse, row_delta(do, o))[0]
    qseg, kseg, qrng, krng = _jax_maps(offsets, T, L)
    jargs = [jnp.asarray(a) for a in (q, k, v, kb)] + [qseg[None], kseg[None], qrng, krng]
    kw = dict(tq=min(64, T), tk=min(16, L), interpret=True, compute="float32")
    jo, jlse = j_varlen._fwd_call(*jargs, **kw)
    jdq = j_varlen._bwd_calls(*jargs, jnp.asarray(do.numpy()), jlse,
                              jnp.asarray(row_delta(do, o).numpy()), **kw)[0]
    assert not any(bool(torch.isnan(g).any()) for g in got)          # every row written
    empty = np.asarray(jlse) >= 5e29
    assert empty[..., offsets[-1]:].all()
    np.testing.assert_array_equal(_np(got[1]) >= 5e29, empty)
    np.testing.assert_array_equal(_np(got[1])[empty], np.float32(LSE_EMPTY))
    for g, want, j, name in ((got[0], o, jo, "o"), (got[2], dq, jdq, "dq")):
        np.testing.assert_allclose(_np(g), _np(want), err_msg=name, **TOL["float32"])
        np.testing.assert_allclose(_np(g), _np(j), err_msg=name, **TOL["float32"])
    for want in (lse, jlse):
        np.testing.assert_allclose(_np(got[1])[~empty], _np(want)[~empty], **TOL["float32"])
    assert (_np(got[2])[..., offsets[-1]:, :] == 0).all()


def test_varlen_bwd_plain_is_autograd_of_forward():
    arrays, offsets = _kernel_case(MIXES[2], 4, "float32")
    args = _torch_args(arrays, offsets, "float32")
    leaves = [a.clone().requires_grad_(True) for a in args[:3]]
    o, lse = t_varlen.flash_attention_varlen_fwd_plain(*leaves, *args[3:6])
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(5))
    o.backward(do)
    got = t_varlen.flash_attention_varlen_bwd_plain(*args[:6], do, lse,
                                                    row_delta(do, o.detach()), chunk=48)
    for g, t in zip(got, leaves):
        torch.testing.assert_close(g, t.grad, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# ops.flash_attention_varlen against the JAX op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes", MIXES)
def test_flash_attention_varlen_op_matches_jax(sizes):
    """The compression branch's call: q_offsets = offsets, k_offsets =
    offsets / ℓ, a key mask; forward and gradients."""
    qs, _, _ = _clouds(sizes)
    q, offsets, mask = _pack(qs, max_samples=len(sizes) + 1)
    L = q.shape[0] // ELL
    rng = np.random.default_rng(6)
    k = rng.standard_normal((L, HKV, D)).astype(np.float32)
    v = rng.standard_normal((L, HKV, D)).astype(np.float32)
    kv = mask.reshape(L, ELL).any(-1)
    do = rng.standard_normal(q.shape).astype(np.float32)
    k_off = offsets // ELL

    def j_fn(q, k, v):
        return j_ops.flash_attention_varlen(q, k, v, jnp.asarray(offsets),
                                            jnp.asarray(k_off), key_valid=jnp.asarray(kv),
                                            interpret=True)

    want, vjp = jax.vjp(j_fn, *(jnp.asarray(a) for a in (q, k, v)))
    want_g = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = t_ops.flash_attention_varlen(*leaves, torch.from_numpy(offsets), k_off,
                                       key_valid=torch.from_numpy(kv))
    real = mask                                          # the tail is unspecified in JAX
    np.testing.assert_allclose(_np(got)[real], np.asarray(want)[real], **TOL["float32"])
    got.backward(torch.from_numpy(do))
    for t, w, name in zip(leaves, want_g, ("dq", "dk", "dv")):
        np.testing.assert_allclose(_np(t.grad), np.asarray(w), err_msg=name,
                                   **TOL["float32"])
    assert (_np(leaves[1].grad)[~kv] == 0).all()          # masked keys: no gradient


def test_flash_attention_varlen_no_cross_sample_leak():
    """Changing sample 1's keys leaves sample 0's outputs bit for bit."""
    sizes = (32, 48)
    qs, ks, vs = _clouds(sizes, seed=7)
    q, offsets, mask = _pack(qs)
    k, _, _ = _pack(ks)
    v, _, _ = _pack(vs)
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    key_valid = torch.from_numpy(mask)
    out = t_ops.flash_attention_varlen(q, k, v, offsets, offsets, key_valid=key_valid)
    k2, v2 = k.clone(), v.clone()
    k2[offsets[1]:] += 7.0
    v2[offsets[1]:] -= 3.0
    out2 = t_ops.flash_attention_varlen(q, k2, v2, offsets, offsets, key_valid=key_valid)
    assert torch.equal(out[:sizes[0]], out2[:sizes[0]])
    a = int(offsets[1])
    assert (out2[a:a + sizes[1]] - out[a:a + sizes[1]]).abs().max() > 1e-3


# ---------------------------------------------------------------------------
# bsa_attention_varlen: branch by branch and gradients against JAX
# ---------------------------------------------------------------------------

def _bsa_setup(seed=0, **kw):
    jcfg = JBSAConfig(**{**BSA, **kw}, backend="jnp")
    tcfg = BSAConfig(**{**BSA, **kw})
    jp = j_bsa.bsa_init(jax.random.PRNGKey(seed), jcfg, n_heads=HQ, n_kv_heads=HKV,
                        head_dim=D, d_model=DM)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda a: np.asarray(a) + rng.normal(0, 0.5, a.shape)
                        .astype(np.float32), jp)          # gates away from ½
    tp = t_bsa.bsa_init(tcfg, n_heads=HQ, n_kv_heads=HKV, head_dim=D, d_model=DM,
                        generator=torch.Generator().manual_seed(seed))
    params_from_jax(tree, tp)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), tp


def _allowed_blocks(offsets, mask, cfg):
    """(G, NB) bool: the blocks a group may pick (valid, same segment, not
    its own ball), none for a group with no real token (all its scores tie,
    and its picks are invalidated before the gather)."""
    T = mask.shape[0]
    seg = segment_ids_from_offsets(offsets, T).numpy()
    nb, g = T // cfg.cmp_block, cfg.group_size
    blk_ok = mask.reshape(nb, cfg.cmp_block).any(-1)
    grp_ok = mask.reshape(T // g, g).any(-1)
    grp, blk = np.arange(T // g) * g, np.arange(nb) * cfg.cmp_block
    same = seg[grp][:, None] == seg[blk][None, :]
    own = (grp // cfg.ball_size)[:, None] == (blk // cfg.ball_size)[None, :]
    return grp_ok[:, None] & blk_ok[None, :] & same & ~own


def _valid_pick_sets(idx, allowed):
    """{(group, head): set of picks the group may make}: the picks compared
    across the packages (ties among NEG_INF candidates order freely)."""
    return {(gi, h): {int(j) for j in idx[gi, h] if allowed[gi, j]}
            for gi in range(idx.shape[0]) for h in range(idx.shape[1])}


@pytest.mark.parametrize("backend", ["reference", "kernels"])
@pytest.mark.parametrize("variant", ["paper", "group_cmp", "token_gates"])
@pytest.mark.parametrize("sizes", MIXES)
def test_bsa_attention_varlen_matches_jax(sizes, variant, backend):
    kw = {"paper": {}, "group_cmp": dict(group_compression=True),
          "token_gates": dict(gate_mode="token")}[variant]
    jcfg, tcfg, jp, tp = _bsa_setup(**kw)
    qs, ks, vs = _clouds(sizes)
    q, offsets, mask = _pack(qs, max_samples=len(sizes) + 1)
    k, _, _ = _pack(ks, max_samples=len(sizes) + 1)
    v, _, _ = _pack(vs, max_samples=len(sizes) + 1)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((q.shape[0], DM)).astype(np.float32)
    do = rng.standard_normal(q.shape).astype(np.float32)

    def j_fn(p, q, k, v, x):
        return j_bsa.bsa_attention_varlen(p, q, k, v, cfg=jcfg, offsets=jnp.asarray(offsets),
                                          mask=jnp.asarray(mask), x=x, return_aux=True)

    want, vjp, jaux = jax.vjp(jax.jit(j_fn), jp, *(jnp.asarray(a) for a in (q, k, v, x)),
                              has_aux=True)
    want_g = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, x)]
    with use_backend(backend):
        got, taux = t_bsa.bsa_attention_varlen(tp, *leaves[:3], cfg=tcfg,
                                               offsets=torch.from_numpy(offsets),
                                               mask=torch.from_numpy(mask), x=leaves[3],
                                               return_aux=True)
    tol = dict(atol=1e-5, rtol=1e-5) if backend == "reference" else MODEL_TOL
    for name in ("ball", "cmp", "slc"):
        np.testing.assert_allclose(_np(taux[name])[mask], _np(jaux[name])[mask],
                                   err_msg=name, **tol)
        np.testing.assert_allclose(_np(taux["gates"][name]), _np(jaux["gates"][name]),
                                   **tol)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    assert (_np(got)[~mask] == 0).all()
    allowed = _allowed_blocks(offsets, mask, tcfg)
    assert (_valid_pick_sets(taux["indices"].numpy(), allowed)
            == _valid_pick_sets(np.asarray(jaux["indices"]), allowed))
    got.backward(torch.from_numpy(do))
    _assert_trees_close(params_to_jax(tp, grads=True), want_g[0], **tol)
    for t, w, name in zip(leaves, want_g[1:], ("q", "k", "v", "x")):
        g = t.grad if t.grad is not None else torch.zeros_like(t)
        np.testing.assert_allclose(_np(g), np.asarray(w), err_msg=name, **tol)


@pytest.mark.parametrize("backend", ["reference", "kernels"])
def test_packed_equals_per_sample_equals_padded(backend):
    """In the port itself: the packed layout, each sample alone, and the
    padded layout of the same clouds agree, forward and gradients."""
    sizes = (64, 40, 24)
    _, tcfg, _, tp = _bsa_setup(seed=3)
    qs, ks, vs = _clouds(sizes, seed=9)
    rng = np.random.default_rng(10)
    dos = [rng.standard_normal((n, HQ, D)).astype(np.float32) for n in sizes]
    with use_backend(backend):
        packed = [torch.from_numpy(a).requires_grad_(True)
                  for a in (_pack(qs)[0], _pack(ks)[0], _pack(vs)[0])]
        _, offsets, mask = _pack(qs)
        out_p = t_bsa.bsa_attention_varlen(tp, *packed, cfg=tcfg, offsets=offsets,
                                           mask=torch.from_numpy(mask))
        out_p.backward(torch.from_numpy(_pack(dos)[0]))
        padded = [torch.from_numpy(t_bt.pack_ragged(a, BALL, pad_to=64)[0])
                  .requires_grad_(True) for a in (qs, ks, vs)]
        maskb = torch.from_numpy(t_bt.pack_ragged(qs, BALL, pad_to=64)[1])
        out_b = t_bsa.bsa_attention(tp, *padded, cfg=tcfg, mask=maskb)
        out_b.backward(torch.from_numpy(t_bt.pack_ragged(dos, BALL, pad_to=64)[0]))
        for i, n in enumerate(sizes):
            a = int(offsets[i])
            solo = [torch.from_numpy(t_bt.pack_ragged([x[i]], BALL)[0]) for x in (qs, ks, vs)]
            m1 = torch.from_numpy(t_bt.pack_ragged([qs[i]], BALL)[1])
            out_1 = t_bsa.bsa_attention(tp, *solo, cfg=tcfg, mask=m1)[0, :n]
            torch.testing.assert_close(out_p[a:a + n], out_1, atol=1e-5, rtol=1e-5)
            torch.testing.assert_close(out_p[a:a + n], out_b[i, :n], atol=1e-5, rtol=1e-5)
            for tp_, tb in zip(packed, padded):          # input gradients per sample
                torch.testing.assert_close(tp_.grad[a:a + n], tb.grad[i, :n],
                                           atol=1e-5, rtol=1e-5)


def test_get_varlen_falls_back_for_a_backend_without_varlen_ops():
    class Minimal:
        ball = ReferenceBackend.ball
        flash = ReferenceBackend.flash
        selection = ReferenceBackend.selection
        gated_combine = ReferenceBackend.gated_combine

    register_backend("minimal-varlen", Minimal(), overwrite=True)
    fn = get_varlen(Minimal(), "flash")
    assert fn.__self__.name == "reference"
    jcfg, tcfg, jp, tp = _bsa_setup(seed=4)
    qs, ks, vs = _clouds(MIXES[1], seed=11)
    q, offsets, mask = _pack(qs)
    k, v = _pack(ks)[0], _pack(vs)[0]
    with use_backend("minimal-varlen"):
        got = t_bsa.bsa_attention_varlen(tp, *(torch.from_numpy(a) for a in (q, k, v)),
                                         cfg=tcfg, offsets=offsets,
                                         mask=torch.from_numpy(mask))
    want = j_bsa.bsa_attention_varlen(jp, *(jnp.asarray(a) for a in (q, k, v)), cfg=jcfg,
                                      offsets=jnp.asarray(offsets), mask=jnp.asarray(mask))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the model, a packed train step and the engine against JAX
# ---------------------------------------------------------------------------

def _models(seed=0):
    jcfg = JModelConfig(**MODEL, vocab_size=0, remat=False,
                        bsa=JBSAConfig(**BSA, backend="jnp"))
    tcfg = ModelConfig(**MODEL, bsa=BSAConfig(**BSA))
    jp = j_pc.pc_init(jax.random.PRNGKey(seed), jcfg)
    model = model_api(tcfg).init(seed, device="cpu")
    params_from_jax(jax.tree.map(np.asarray, jp), model)
    return jcfg, jp, tcfg, model


def _packed_batch(sizes, seed=0, **kw):
    """Numpy packed batch {feats (1, T, 7), target (1, T, 1), mask (1, T),
    offsets (S+1,)}, as ``pack_varlen`` makes it."""
    rng = np.random.default_rng(seed)
    rows = [rng.standard_normal((n, 8)).astype(np.float32) for n in sizes]
    packed, offsets, mask = _pack(rows, **kw)
    return {"feats": packed[None, :, :7], "target": packed[None, :, 7:],
            "mask": mask[None], "offsets": offsets}


@pytest.mark.parametrize("backend", ["auto", "kernels"])
@pytest.mark.parametrize("sizes", MIXES[:2])
def test_pc_apply_offsets_matches_jax(sizes, backend):
    jcfg, jp, tcfg, model = _models()
    b = _packed_batch(sizes, max_samples=4)
    want = np.asarray(j_pc.pc_apply(jp, jnp.asarray(b["feats"]), mcfg=jcfg,
                                    mask=jnp.asarray(b["mask"]),
                                    offsets=jnp.asarray(b["offsets"])))
    with use_backend(backend):
        got = t_pc.pc_apply(model, torch.from_numpy(b["feats"]), mcfg=tcfg,
                            mask=torch.from_numpy(b["mask"]),
                            offsets=torch.from_numpy(b["offsets"]))
    assert got.shape == b["mask"].shape + (1,)
    real = b["mask"]
    np.testing.assert_allclose(_np(got)[real], want[real], **MODEL_TOL)


def test_attention_layer_offsets_need_one_packed_row():
    _, _, tcfg, model = _models()
    x = torch.zeros(2, 32, tcfg.d_model)
    with pytest.raises(ValueError, match="single packed row"):
        attention_layer_apply(model.layers[0].attn, x, mcfg=tcfg,
                              offsets=np.asarray([0, 16, 32], np.int32))


def test_packed_train_step_matches_jax():
    jcfg, jp, tcfg, model = _models(seed=1)
    japi, tapi = j_model_api(jcfg), model_api(tcfg)
    batch = _packed_batch(MIXES[0], seed=2, pad_to=160, max_samples=5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    kw = dict(base_lr=1e-3, weight_decay=0.01, total_steps=10, warmup_steps=1)
    jstep, tstep = jax.jit(j_make_train_step(japi, **kw)), make_train_step(tapi, **kw)
    jstate = j_adamw.adamw_init(jp)
    tstate = adamw_init(dict(model.named_parameters()))
    for _ in range(2):
        jp, jstate, jout = jstep(jp, jstate, jbatch)
        model, tstate, tout = tstep(model, tstate, tbatch)
        np.testing.assert_allclose(float(tout["loss"]), float(jout["loss"]), **MODEL_TOL)
        np.testing.assert_allclose(float(tout["grad_norm"]), float(jout["grad_norm"]),
                                   **MODEL_TOL)
    # the second step's clipped gradients, and the parameters after it
    (_, _), jgrads = jax.jit(jax.value_and_grad(japi.loss, has_aux=True))(jp, jbatch)
    model.zero_grad(set_to_none=True)
    loss, _ = tapi.loss(model, tbatch)
    loss.backward()
    _assert_trees_close(params_to_jax(model, grads=True), jgrads, **MODEL_TOL)
    _assert_trees_close(params_to_jax(model), jp, **MODEL_TOL)


@pytest.mark.parametrize("pad_to", [None, 160])
def test_geometry_engine_packed_matches_jax(pad_to):
    jcfg, jp, tcfg, model = _models(seed=2)
    rng = np.random.default_rng(12)
    clouds = [(rng.standard_normal((n, 3)).astype(np.float32),
               rng.standard_normal((n, 7)).astype(np.float32)) for n in (20, 45, 33, 11, 9)]
    jeng = JGeometryEngine(j_model_api(jcfg), jp, batch_slots=3, pad_to=pad_to, backend="jnp")
    teng = GeometryEngine(model_api(tcfg), model, batch_slots=3, pad_to=pad_to)
    assert teng.layout == jeng.layout == "packed"          # the default for BSA
    batch, _, _ = teng.pack_batch(clouds[:3])
    assert batch["offsets"].device.type == "cpu" and batch["feats"].shape[0] == 1
    want = jeng.predict(clouds)
    got = teng.predict(clouds)                             # short final batch too
    assert teng.clouds_served == 5 and teng.points_served == 20 + 45 + 33 + 11 + 9
    for g, w, (p, _) in zip(got, want, clouds):
        assert g.shape == (p.shape[0], 1) and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, **MODEL_TOL)
