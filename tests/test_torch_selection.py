"""The selection kernels' dispatch rule, their scatter step and their plain
versions at a group of the LM's kind, against the JAX package.

- :func:`selection.selection_plan`, the one rule that sends a shape to the
  warp path or the tiled path, for the shapes the port's configurations
  give (shapenet-bsa: M 8, ℓ 8, D 32; tinyllama-1.1b: M 512, ℓ 64, D 64;
  phi4-mini-3.8b's heads: M 192, ℓ 64, D 128), held to the tile constants
  of ``csrc/selection_{fwd,bwd}.cu``; a shape no path takes raises.
- The tiled backward's scatter step: :func:`selection.scatter_plan`'s
  inverse index and :func:`selection.reduce_staged_plain` (the plain version
  of ``selection_dkv``'s second pass) against
  ``repro.kernels.selection._scatter_blocks`` on numpy inputs; the warp
  path's at M = 8 (:func:`selection.scatter_ranks`' slots, the same
  reduce) against the plain backward and ``_scatter_blocks``.
- The plain forward and backward (what the wrappers run on CPU tensors and
  what ``chip_smoke.py`` holds the CUDA kernels to) against the Pallas
  kernel in interpret mode (``_fwd_call`` and ``jax.vjp`` through
  ``selection_attention_kernel_call``) at groups of g 16 × rep 4 = 64 rows,
  ℓ 16, D 16, with a dead group and masked keys.

Tolerances: fp32 1e-3; bf16 4e-2, 6e-2 for the backward (the JAX suite's).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels import selection as j_sel
from repro_torch.configs import get_config
from repro_torch.core.branches import sdpa
from repro_torch.kernels import selection
from repro_torch.kernels.common import row_delta

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
TOL = {"float32": dict(atol=1e-3, rtol=1e-3), "bfloat16": dict(atol=4e-2, rtol=4e-2)}
BWD_TOL = {"float32": TOL["float32"], "bfloat16": dict(atol=6e-2, rtol=6e-2)}


def _group_shape(cfg):
    """(M, ℓ, D, dtype) a configuration gives the selection kernels."""
    rep = cfg.n_heads // cfg.n_kv_heads
    M = (cfg.bsa.group_size or 1) * rep
    return M, cfg.bsa.slc_block, cfg.resolved_head_dim, getattr(torch, cfg.compute_dtype)


# configuration (port's, or the JAX package's for phi4-mini's D 128 heads),
# its (M, ℓ, D) and the plan expected for it
PLAN_CASES = [
    ("shapenet-bsa", get_config, (8, 8, 32), ("warp", 8, 8, 0)),
    ("tinyllama-1.1b", get_config, (512, 64, 64), ("tiles", 64, 64, 64)),
    ("phi4-mini-3.8b", j_get_config, (192, 64, 128), ("tiles", 64, 64, 32)),
]


@pytest.mark.parametrize("name,getter,shape,plan", PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
def test_selection_plan_for_configs(name, getter, shape, plan):
    cfg = getter(name)
    M, ell, D, dtype = _group_shape(cfg)
    assert (M, ell, D) == shape
    assert tuple(selection.selection_plan(M, ell, D, torch.bfloat16)) == plan
    # fp32 (the tests', shapenet's dtype) takes the same path, 32-key chunks
    want32 = plan if plan[0] == "warp" else plan[:2] + (32,) + plan[3:]
    assert tuple(selection.selection_plan(M, ell, D, torch.float32)) == want32
    assert selection.selection_plan(M, ell, D, dtype).path == plan[0]


def test_selection_plan_boundary_and_source_constants():
    """The warp path ends at M = 15; the tiled path's rows and key chunks
    are the constants the CUDA sources build with."""
    assert selection.selection_plan(15, 64, 64, torch.bfloat16).path == "warp"
    assert selection.selection_plan(16, 8, 16, torch.float32).path == "tiles"
    src = (CSRC / "selection_fwd.cu").read_text() + (CSRC / "selection_bwd.cu").read_text()

    def consts(struct):
        body = re.search(r"struct %s \{\n\s*static constexpr int ([^;]*);" % struct, src)
        return dict(re.findall(r"(\w+) = ([^,]+)", body.group(1)))

    for dt, fwd, dq in ((torch.bfloat16, "FwdMma", "DqMma"), (torch.float32, "FwdFma", "DqFma")):
        for D in (64, 128):
            plan = selection.selection_plan(512, 64, D, dt)
            for struct in (fwd, dq):
                c = consts(struct)
                assert (int(c["BM"]), int(c["BK"])) == (plan.rows, plan.keys), struct
    for struct in ("DkvMma", "DkvFma"):
        assert consts(struct)["BM"] == "D > 64 ? 32 : 64"
    assert selection.selection_plan(512, 64, 128, torch.float32).dkv_rows == 32
    assert selection.selection_plan(512, 64, 64, torch.float32).dkv_rows == 64


@pytest.mark.parametrize("M,ell,D,dtype", [(0, 64, 64, torch.bfloat16),
                                           (512, 0, 64, torch.bfloat16),
                                           (512, 64, 48, torch.bfloat16),
                                           (8, 8, 32, torch.float16)])
def test_selection_plan_raises(M, ell, D, dtype):
    with pytest.raises(ValueError, match=rf"selection kernels: no path takes M {M}, ℓ {ell}, "
                                         rf"D {D}"):
        selection.selection_plan(M, ell, D, dtype)


def _scatter_case(kind, rng):
    B, Hkv, G, k_star, NB = 2, 3, 6, 3, 7
    idx = np.stack([rng.permutation(NB)[:k_star] for _ in range(B * Hkv * G)])
    idx = idx.reshape(B, Hkv, G, k_star).astype(np.int32)
    idx[rng.random(idx.shape) < 0.2] = -1                 # invalid selections
    if kind == "duplicates":
        idx[0, 1, :4, 0] = 5                              # four groups on one block
        idx[1, 0, 2, 1] = idx[1, 0, 2, 0] = 4             # twice within one group
    elif kind == "every_group_one_block":
        idx[:, :, :, 2] = 0                               # every group picks block 0
        idx[1, 2] = -1                                    # a head with nothing valid
    return idx, NB


@pytest.mark.parametrize("kind", ["duplicates", "every_group_one_block", "random"])
def test_scatter_plan_matches_jax_scatter_blocks(kind):
    rng = np.random.default_rng(["duplicates", "every_group_one_block", "random"].index(kind))
    idx, NB = _scatter_case(kind, rng)
    B, Hkv, G, k_star = idx.shape
    ell, D = 4, 8
    d_sel = rng.standard_normal((B, Hkv, G, k_star, ell, D)).astype(np.float32)
    d_sel[idx < 0] = 0.0                     # the JAX kernel writes invalid tiles as zeros
    want = np.asarray(j_sel._scatter_blocks(jnp.asarray(d_sel), jnp.asarray(idx), NB))

    order, offsets = selection.scatter_plan(torch.from_numpy(idx), NB)
    assert order.dtype == offsets.dtype == torch.int32
    n_valid = int((idx >= 0).sum())
    assert offsets.shape == (B * Hkv * NB + 1,) and int(offsets[-1]) == n_valid
    blocks = (np.arange(B * Hkv).reshape(B, Hkv, 1, 1) * NB + idx).reshape(-1)
    o = order.numpy()
    for i in range(B * Hkv * NB):            # block i's selections, in (g, j) order
        own = o[offsets[i]:offsets[i + 1]]
        assert (blocks[own] == i).all() and (np.diff(own) > 0).all()
        assert len(own) == int(((blocks == i) & (idx.reshape(-1) >= 0)).sum())
    assert (idx.reshape(-1)[o[n_valid:]] < 0).all()
    # slot s of the staging buffer holds the s-th selection in that order
    staged = torch.from_numpy(d_sel).reshape(-1, ell, D)[order.long()]
    got = selection.reduce_staged_plain(staged, offsets, (B, Hkv, NB, ell, D))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("kind", ["duplicates", "every_group_one_block", "random"])
def test_warp_rank_staging_matches_plain_and_jax(kind):
    """The warp path's backward at groups of M = 8 rows: each selection's dK,
    dV tile (autograd of the plain forward through the gathered blocks)
    stored at slot ``rank[flat position]`` (:func:`selection.scatter_ranks`,
    the plain version of the kernel's first pass) and summed by
    :func:`selection.reduce_staged_plain` equals the plain backward's dkb,
    dvb and JAX's ``_scatter_blocks``; duplicate picks within a group, −1
    picks, a block picked by every group and a head with nothing valid
    (``_scatter_case``).  Each block's slots hold its selections in
    :func:`selection.scatter_plan`'s order; invalid selections get −1 and
    their slots (NaN here) are never read."""
    rng = np.random.default_rng(10 + ["duplicates", "every_group_one_block",
                                      "random"].index(kind))
    idx, NB = _scatter_case(kind, rng)
    B, Hkv, G, k_star = idx.shape
    M, ell, D = 8, 4, 16
    assert selection.selection_plan(M, ell, D, torch.float32).path == "warp"
    q, do = (torch.from_numpy(rng.standard_normal((B, Hkv, G, M, D)).astype(np.float32))
             for _ in range(2))
    kb, vb = (torch.from_numpy(rng.standard_normal((B, Hkv, NB, ell, D)).astype(np.float32))
              for _ in range(2))
    tok = np.zeros((B, NB, ell), np.float32)
    tok[0, 2, 1:] = -1e30                                # masked keys
    tok = torch.from_numpy(tok)
    tidx = torch.from_numpy(idx)
    kg, vg, bias, _ = selection._gather(kb, vb, tidx, tok)
    kg, vg = kg.requires_grad_(True), vg.requires_grad_(True)
    o, lse = sdpa(q, kg, vg, bias, return_lse=True)
    o.backward(do)
    d_sel = [g.reshape(B, Hkv, G, k_star, ell, D) for g in (kg.grad, vg.grad)]

    rank, offsets = selection.scatter_ranks(tidx, NB)
    order, flat_offsets = selection.scatter_plan(tidx, NB)
    assert rank.dtype == offsets.dtype == torch.int32 and offsets.shape == (B * Hkv, NB + 1)
    valid = torch.from_numpy(((idx >= 0) & (idx < NB)).reshape(-1))
    n = G * k_star
    assert bool((rank[~valid] == -1).all()) and len(set(rank[valid].tolist())) == int(valid.sum())
    head = torch.arange(rank.numel()) // n
    assert bool((rank[valid] // n == head[valid]).all())      # a head's slots are its own
    # per block the same selections in the same (g, j) order as scatter_plan's
    counts = flat_offsets[1:] - flat_offsets[:-1]
    assert torch.equal(offsets[:, 1:] - offsets[:, :-1], counts.reshape(B * Hkv, NB))
    by_slot = torch.full((rank.numel(),), -1, dtype=torch.long)
    by_slot[rank[valid].long()] = torch.arange(rank.numel())[valid]
    for i, (lo, hi) in enumerate(zip(offsets[:, :-1].reshape(-1).tolist(),
                                     offsets[:, 1:].reshape(-1).tolist())):
        own = order[flat_offsets[i]:flat_offsets[i + 1]].long()
        assert torch.equal(by_slot[lo:hi], own)
    want = selection.selection_attention_bwd_plain(q, kb, vb, tidx, tok, do, lse.detach(),
                                                   row_delta(do, o.detach()))[1:]
    for d, w in zip(d_sel, want):
        staged = torch.full((rank.numel(), ell, D), float("nan"))   # unwritten slots
        flat = d.reshape(-1, ell, D).detach()
        staged[rank[valid].long()] = flat[valid]
        got = selection.reduce_staged_plain(staged, offsets, (B, Hkv, NB, ell, D))
        jax_want = np.asarray(j_sel._scatter_blocks(jnp.asarray(d.detach().numpy()),
                                                    jnp.asarray(idx), NB))
        np.testing.assert_allclose(got.numpy(), w.numpy(), **BWD_TOL["float32"])
        np.testing.assert_allclose(got.numpy(), jax_want, atol=1e-5, rtol=1e-5)


def _lm_group_case(seed):
    """B 1, 2 KV heads, 4 groups of g 16 × rep 4 = 64 rows, 8 blocks of 16
    keys, D 16, k* 3: group 2 of head 1 has no valid selection, block 6's
    last 5 keys and all of block 7 are padding."""
    B, Hkv, G, M, NB, ell, D, k_star = 1, 2, 4, 64, 8, 16, 16, 3
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hkv, G, M, D)).astype(np.float32)
    kb = rng.standard_normal((B, Hkv, NB, ell, D)).astype(np.float32)
    vb = rng.standard_normal((B, Hkv, NB, ell, D)).astype(np.float32)
    do = rng.standard_normal((B, Hkv, G, M, D)).astype(np.float32)
    idx = np.stack([rng.permutation(NB)[:k_star] for _ in range(B * Hkv * G)])
    idx = idx.reshape(B, Hkv, G, k_star).astype(np.int32)
    idx[0, 0, :, 0] = 6                      # every group of head 0 on block 6
    idx[0, 0, 1, 2] = -1
    idx[0, 1, 2] = -1                        # a dead group
    tok = np.zeros((B, NB, ell), np.float32)
    tok[0, 6, -5:] = -1e30
    tok[0, 7] = -1e30
    return q, kb, vb, do, idx, tok


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_selection_plain_matches_pallas_lm_group(dtype):
    q, kb, vb, do, idx, tok = _lm_group_case(5)
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, kb, vb))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, kb, vb))
    jo, jl = j_sel._fwd_call(jq, jk, jv, jnp.asarray(idx), jnp.asarray(tok),
                             interpret=True, compute=dtype)
    to, tl = selection.selection_attention_fwd(tq, tk, tv, torch.from_numpy(idx),
                                               torch.from_numpy(tok))
    np.testing.assert_allclose(to.float().numpy(), np.asarray(jo, np.float32), **TOL[dtype])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL[dtype])
    assert (to[0, 1, 2] == 0).all() and (tl[0, 1, 2] == 1e30).all()   # the dead group


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_selection_bwd_plain_matches_pallas_lm_group(dtype):
    q, kb, vb, do, idx, tok = _lm_group_case(6)
    fn = lambda q_, k_, v_: j_sel.selection_attention_kernel_call(   # noqa: E731
        q_, k_, v_, jnp.asarray(idx), jnp.asarray(tok), interpret=True)
    primals = [jnp.asarray(a).astype(dtype) for a in (q, kb, vb)]
    out, vjp = jax.vjp(fn, *primals)
    want = vjp(jnp.asarray(do).astype(out.dtype))
    leaves = [torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_(True)
              for a in (q, kb, vb)]
    o = selection.SelectionAttentionFn.apply(*leaves, torch.from_numpy(idx),
                                             torch.from_numpy(tok))
    o.backward(torch.from_numpy(do).to(o.dtype))
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.float().numpy(), np.asarray(w, np.float32),
                                   **BWD_TOL[dtype])
    assert (leaves[0].grad[0, 1, 2] == 0).all()                       # the dead group
    assert (leaves[1].grad[0, :, 7] == 0).all() and (leaves[2].grad[0, :, 7] == 0).all()
