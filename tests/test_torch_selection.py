"""The selection kernels' dispatch rule, their scatter step and their plain
versions at a group of the LM's kind, against the JAX package.

- :func:`selection.selection_plan`, the one rule that sends a shape to the
  groups, warp or tiled path, for the shapes the port's configurations
  give (shapenet-bsa: M 8, ℓ 8, D 32, k* 4, whose fp32 forward takes the
  groups path; tinyllama-1.1b: M 512, ℓ 64, D 64; phi4-mini-3.8b's heads:
  M 192, ℓ 64, D 128), held to the tile constants of
  ``csrc/selection_{fwd,bwd}.cu``; a shape no path takes raises.
- The groups path's walk (``selection_fwd_groups``: tiles of consecutive
  groups, one warp a group, the valid picks staged, 8-row passes scored in
  one pass, the lanes' tiles of S and of P V) mirrored in PyTorch against
  the plain forward and the Pallas ``_fwd_kernel`` in interpret mode, with
  a tail tile, dead groups, duplicate picks, an index of NB and masked
  keys.
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
# its (M, ℓ, D), the plan expected for it (the backward's, and the
# forward's given k* in bf16) and the fp32 forward's given k*
PLAN_CASES = [
    ("shapenet-bsa", get_config, (8, 8, 32), ("warp", 8, 8, 0), ("groups", 8, 32, 0)),
    ("tinyllama-1.1b", get_config, (512, 64, 64), ("tiles", 64, 64, 64), ("tiles", 64, 32, 64)),
    ("phi4-mini-3.8b", j_get_config, (192, 64, 128), ("tiles", 64, 64, 32),
     ("tiles", 64, 32, 32)),
]


@pytest.mark.parametrize("name,getter,shape,plan,fwd32", PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
def test_selection_plan_for_configs(name, getter, shape, plan, fwd32):
    cfg = getter(name)
    M, ell, D, dtype = _group_shape(cfg)
    k_star = cfg.bsa.top_k
    assert (M, ell, D) == shape
    assert tuple(selection.selection_plan(M, ell, D, torch.bfloat16)) == plan
    # fp32 (the tests', shapenet's dtype) takes the same path, 32-key chunks
    want32 = plan if plan[0] == "warp" else plan[:2] + (32,) + plan[3:]
    assert tuple(selection.selection_plan(M, ell, D, torch.float32)) == want32
    assert selection.selection_plan(M, ell, D, dtype).path == plan[0]
    # the forward's rule (given k*): the groups path for shapenet's fp32 only
    assert tuple(selection.selection_plan(M, ell, D, torch.bfloat16, k_star)) == plan
    assert tuple(selection.selection_plan(M, ell, D, torch.float32, k_star)) == fwd32
    want = fwd32 if dtype == torch.float32 else plan
    assert selection.selection_plan(M, ell, D, dtype, k_star).path == want[0]


# (M, ℓ, D, dtype, k*) -> the forward's path
GROUPS_RULE = [
    ((8, 8, 32, torch.float32, 4), "groups"),     # shapenet
    ((8, 8, 16, torch.float32, 4), "groups"),
    ((8, 8, 64, torch.float32, 4), "groups"),
    ((15, 8, 32, torch.float32, 4), "groups"),    # two passes of 8 rows
    ((1, 32, 32, torch.float32, 1), "groups"),
    ((8, 8, 32, torch.float32, None), "warp"),    # the backward's rule: no k*
    ((8, 8, 32, torch.float32, 0), "warp"),
    ((8, 8, 32, torch.bfloat16, 4), "warp"),      # bf16
    ((8, 8, 128, torch.float32, 4), "warp"),      # D 128
    ((8, 8, 32, torch.float32, 5), "warp"),       # 40 keys: past one stage
    ((8, 33, 32, torch.float32, 1), "warp"),
    ((16, 8, 32, torch.float32, 4), "tiles"),
]


@pytest.mark.parametrize("shape,path", GROUPS_RULE,
                         ids=["-".join(str(x).replace("torch.", "") for x in c[0])
                              for c in GROUPS_RULE])
def test_selection_plan_groups_rule(shape, path):
    M, ell, D, dtype, k_star = shape
    plan = selection.selection_plan(M, ell, D, dtype, k_star)
    assert plan.path == path
    if path == "groups":
        assert tuple(plan) == ("groups", 8, selection.GROUPS_KEYS, 0)


def _struct_consts(src, struct):
    """The first line of ``static constexpr int`` constants of a struct."""
    body = re.search(r"struct %s \{\n\s*static constexpr int ([^;]*);" % struct, src)
    return dict(re.findall(r"(\w+) = ([^,]+)", body.group(1)))


def test_selection_groups_source_constants():
    """``FwdGroups`` in ``csrc/selection_fwd.cu``: 8 rows a pass and one
    stage of ``GROUPS_KEYS`` keys, as :func:`selection.selection_plan`
    names them; one group (a warp) a block; the dims it is built for; the
    launcher refuses what the rule does not send to it."""
    src = (CSRC / "selection_fwd.cu").read_text()
    c = _struct_consts(src, "FwdGroups")
    plan = selection.selection_plan(8, 8, 32, torch.float32, 4)
    assert (int(c["ROWS"]), int(c["KEYS"])) == (plan.rows, plan.keys)
    assert c["GT"] == "1"                                  # a warp a block: none waits on another
    assert selection.GROUPS_DIMS == (16, 32, 64)
    assert "if constexpr (D > 64) {                 // built for D 16, 32, 64 only" in src
    assert "if (M >= 16 || k_star * ell > C::KEYS) return (int)cudaErrorInvalidValue;" in src
    assert "return bf16 ? (int)cudaErrorInvalidValue" in src
    assert selection.PATH_CODES == {"warp": 0, "tiles": 1, "groups": 2}
    assert "path: 0 = warp, 1 = tiles, 2 = groups" in src

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


def _groups_at(D, r, c):
    """``FwdGroups::at``: the float offset of 16-byte chunk c of row r in a
    Q, K or V tile (D ≥ 32: unpadded rows, chunk c at c ^ (r % 8); D 16:
    rows padded to D + 4)."""
    return r * D + (c ^ (r % 8)) * 4 if D >= 32 else r * (D + 4) + c * 4


def _groups_walk(q, kb, vb, idx, tok):
    """A PyTorch mirror of ``selection_fwd_groups``'s walk: a warp a group
    (one a block); its valid picks (0 ≤ idx < NB) in the order of idx fill
    the first ``keys`` key slots, ℓ keys each (slot r: pick r // ℓ, key
    r % ℓ), the rest stage zero K, V and a NEG_INF bias; a group with no
    valid pick writes zeros and ``LSE_EMPTY``.  A pass of ``rows`` query
    rows scores every slot in one pass: lane (rp, kx) holds S of rows 2rp,
    2rp+1 × keys kx + 8i, one max and one sum a row over its 8 lanes, and O
    of the same rows × the dims of vectors kx + 8j; lse goes out 4 rows a
    lane from lanes 0 and 1 when M is a multiple of 4, else from lanes kx =
    0.  Every (row, key) pair of S, (row, dim) of O and row of lse is
    counted once.  Returns (o, lse) as the kernel writes them (NaN where
    nothing was written)."""
    B, Hkv, G, M, D = q.shape
    NB, ell = kb.shape[2], kb.shape[3]
    k_star = idx.shape[-1]
    plan = selection.selection_plan(M, ell, D, torch.float32, k_star)
    assert plan.path == "groups"
    rows, keys = plan.rows, plan.keys
    vw = 4 if D >= 32 else D // 8
    nv = D // (8 * vw)
    scale = D ** -0.5
    o = torch.full((B * Hkv * G, M, D), float("nan"))
    lse = torch.full((B * Hkv * G, M), float("nan"))
    qf, kf, vf = q.reshape(-1, M, D), kb.reshape(-1, NB, ell, D), vb.reshape(-1, NB, ell, D)
    picks = idx.reshape(-1, k_star)
    for item in range(B * Hkv * G):
        bh = item // G
        b = bh // Hkv
        sel = [int(j) for j in picks[item] if 0 <= int(j) < NB]
        if not sel:
            o[item] = 0.0
            lse[item] = LSE_EMPTY_F
            continue
        ks = torch.zeros(keys, D)
        vs = torch.zeros(keys, D)
        bs = torch.full((keys,), -1e30)
        for r in range(len(sel) * ell):
            ks[r], vs[r] = kf[bh, sel[r // ell], r % ell], vf[bh, sel[r // ell], r % ell]
            bs[r] = tok[b, sel[r // ell], r % ell]
        for r0 in range(0, M, rows):
            n = min(rows, M - r0)
            qs = torch.zeros(rows, D)
            qs[:n] = qf[item, r0:r0 + n]
            s = torch.full((rows, keys), float("nan"))
            seen = torch.zeros(rows, keys, dtype=torch.int64)
            for lane in range(32):
                rp, kx = lane // 8, lane % 8
                for h in range(2):
                    for i in range(keys // 8):
                        r, c = 2 * rp + h, kx + 8 * i
                        s[r, c] = (qs[r] @ ks[c]) * scale + bs[c]
                        seen[r, c] += 1
            assert (seen == 1).all()
            ms = s.max(-1, keepdim=True).values.clamp(min=-5e29)
            p = torch.where(s > -5e29, torch.exp(s - ms), 0.0)
            l = p.sum(-1)
            acc = torch.full((rows, D), float("nan"))
            cover = torch.zeros(rows, D, dtype=torch.int64)
            for lane in range(32):
                rp, kx = lane // 8, lane % 8
                for h in range(2):
                    for j in range(nv):
                        dims = slice((kx + 8 * j) * vw, (kx + 8 * j + 1) * vw)
                        acc[2 * rp + h, dims] = p[2 * rp + h] @ vs[:, dims]
                        cover[2 * rp + h, dims] += 1
            assert (cover == 1).all()
            inv = torch.where(l > 0, 1.0 / l, 0.0)
            o[item, r0:r0 + n] = (acc * inv[:, None])[:n]
            lv = torch.where(l > 0, ms[:, 0] + torch.log(l.clamp(min=1e-30)), LSE_EMPTY_F)
            writers = ([(t, range(4 * t, 4 * t + 4)) for t in range(2)] if M % 4 == 0 else
                       [(8 * rp, (2 * rp, 2 * rp + 1)) for rp in range(4)])
            for _, rs in writers:
                for r in rs:
                    if r0 + r < M:
                        assert torch.isnan(lse[item, r0 + r])
                        lse[item, r0 + r] = lv[r]
    return o.reshape(q.shape), lse.reshape(B, Hkv, G, M)


LSE_EMPTY_F = 1e30


def _groups_case(M, ell, D, k_star, G, seed):
    """B 2 × Hkv 2 × G groups (a tail tile when 4·G is no multiple of the
    block's groups), blocks of ℓ keys: random picks with −1 and NB, a dead
    group, duplicate picks within a group and across groups, a group whose
    only valid pick is a block of masked keys, and a masked tail."""
    B, Hkv, NB = 2, 2, 7
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hkv, G, M, D)).astype(np.float32)
    kb = rng.standard_normal((B, Hkv, NB, ell, D)).astype(np.float32)
    vb = rng.standard_normal((B, Hkv, NB, ell, D)).astype(np.float32)
    idx = rng.integers(-1, NB + 1, (B, Hkv, G, k_star)).astype(np.int32)
    idx[0, 0, 0] = -1                                     # a dead group
    idx[0, 1, 1, :2] = 2                                  # a block picked twice
    idx[1, 0, :, 0] = 4                                   # every group of a head on block 4
    idx[1, 1, 2] = -1
    idx[1, 1, 2, -1] = NB                                 # dead: its one pick is NB
    idx[0, 0, 2] = -1
    idx[0, 0, 2, 0] = 6                                   # only block 6: all masked
    tok = np.zeros((B, NB, ell), np.float32)
    tok[0, 6] = -1e30
    tok[1, NB - 1, ell // 2:] = -1e30                     # a masked tail
    return q, kb, vb, idx, tok


# (M, ℓ, D, k*, G): shapenet's group at D 16 / 32 / 64, two passes at M 12,
# a short pass at M 5 (lse from lanes kx = 0) with 24 of 32 key slots, M 4
# (lse from lanes 0, 1) and a stage filled by 2 blocks of 16
GROUPS_WALK = [(8, 8, 32, 4, 5), (8, 8, 16, 4, 3), (8, 8, 64, 4, 3),
               (12, 4, 32, 8, 3), (5, 8, 32, 3, 3), (4, 16, 32, 2, 3)]


@pytest.mark.parametrize("M,ell,D,k_star,G", GROUPS_WALK,
                         ids=[f"M{c[0]}-l{c[1]}-D{c[2]}-k{c[3]}" for c in GROUPS_WALK])
def test_selection_groups_walk_matches_plain_and_pallas(M, ell, D, k_star, G):
    """The groups path's walk (:func:`_groups_walk`) writes every row, and
    equals the plain forward and JAX's ``_fwd_kernel`` in interpret mode
    (fp32, 1e-4); a dead group (no pick, or only −1 and NB) and the group
    whose keys are all masked give zeros and ``LSE_EMPTY``."""
    q, kb, vb, idx, tok = _groups_case(M, ell, D, k_star, G, 20 + M + D)
    NB = kb.shape[2]
    t = [torch.from_numpy(a) for a in (q, kb, vb, idx, tok)]
    o, lse = _groups_walk(*t)
    assert not torch.isnan(o).any() and not torch.isnan(lse).any()
    plain_idx = np.where(idx < NB, idx, -1).astype(np.int32)
    wo, wl = selection.selection_attention_fwd_plain(*t[:3], torch.from_numpy(plain_idx), t[4])
    jo, jl = j_sel._fwd_call(*(jnp.asarray(a) for a in (q, kb, vb, plain_idx, tok)),
                             interpret=True, compute="float32")
    tol = dict(atol=1e-4, rtol=1e-4)
    for want_o, want_l in ((wo.numpy(), wl.numpy()), (np.asarray(jo), np.asarray(jl))):
        np.testing.assert_allclose(o.numpy(), want_o, **tol)
        np.testing.assert_allclose(lse.numpy(), want_l, **tol)
    for b, h, g in ((0, 0, 0), (1, 1, 2), (0, 0, 2)):
        assert (o[b, h, g] == 0).all() and (lse[b, h, g] == LSE_EMPTY_F).all()


@pytest.mark.parametrize("D", [16, 32, 64])
def test_selection_groups_tile_layout(D):
    """``FwdGroups::at`` places each row's 16-byte chunks once, and the
    groups kernel's shared-memory reads meet no bank conflict within a
    quarter warp (8 lanes, one 16-byte access each): S's K reads (lane kx:
    row kx + 8i, chunk d) and P V's V reads (row c, chunk kx + 8j)."""
    ch, ld = D // 4, (D if D >= 32 else D + 4)
    for r in range(32):
        assert sorted(_groups_at(D, r, c) for c in range(ch)) == [r * ld + 4 * c
                                                                 for c in range(ch)]

    def banks(offsets):                        # each 16-byte access: 4 banks
        return [(off // 4 * 4 + k) % 32 for off in offsets for k in range(4)]

    for d in range(ch):
        for i in range(4):
            b = banks(_groups_at(D, kx + 8 * i, d) for kx in range(8))
            assert len(set(b)) == len(b), (d, i)
    for c in range(32):
        for j in range(max(1, D // 32)):
            if D >= 32:
                b = banks(_groups_at(D, c, kx + 8 * j) for kx in range(8))
            else:                                  # D 16: 8-byte vectors, padded rows
                b = [(c * ld + 2 * kx + k) % 32 for kx in range(8) for k in range(2)]
            assert len(set(b)) == len(b), (c, j)
