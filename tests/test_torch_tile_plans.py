"""The walks of the tiled ``flash_fwd`` and local kernels, and the rules
that pick their paths, checked on the CPU.

- :func:`flash.fwd_walk` (the key tiles each row tile of ``flash_fwd``
  stages) and :func:`local.dq_walk` / :func:`local.dkv_walk` (the key tiles
  a tiled ``local_fwd`` or ``local_dq`` row block stages, the forward's
  driven by the liveness map the wrapper computes over masks with holes,
  padded tails, dead halves and rows that see nothing; the row tiles a
  ``local_dkv`` key block stages in block i and block i+1) against the
  plain versions' masks
  (``flash.visible_keys``, ``local._window_bias``) by brute force: every
  visible (row, key) pair is covered; in the causal and block-causal modes
  (and the banded local mask) no staged tile is wholly masked; rows that see
  no key are the rows a walk reports empty.  Plain, causal and
  block-causal modes, ℓ 8 and 64, L 480 (a ragged key tile) and 512;
  windows 64–256, live and dead halves.
- :func:`bta.fwd_walk` and :func:`bta.bwd_walk` (the row blocks and key
  tiles of the tiled ball kernels) over a live ball: every (row, key) pair
  visited exactly once, on the fma path at balls 64–256 and rep 1–2, on
  the mma path at balls 64–512, rep 1–4 and D 64 / 128, in the forward and
  in each role of the backward (the dK/dV blocks' row tiles, the dQ
  blocks' key tiles).
- :func:`flash.flash_fwd_plan`, :func:`local.local_plan` (the path of
  ``local_fwd``, ``local_dq`` and ``local_dkv``) and :func:`bta.bta_plan`
  (the path of ``bta_fwd`` and ``bta_bwd``) at every configuration the port
  registers and at the windows', balls', head dims' and dtypes' boundaries,
  with their tiles pinned to the constants of ``csrc/flash_fwd.cu``,
  ``csrc/local_fwd.cu``, ``csrc/local_bwd.cu``, ``csrc/bta_fwd.cu`` and
  ``csrc/bta_bwd.cu``.
- :func:`occupancy.varlen_dkv_tiles` (the fp32 ``varlen_dkv``'s walk) on
  offsets from ``pack_varlen``: every pooled key of every segment, the
  capacity tail's too, in exactly one tile that lies in one segment, each
  tile's splits covering that segment's rows in whole row tiles and in
  order; ragged segments, a segment shorter than one row tile, empty
  segments, and the paper's ball 256 / ℓ 8 at shapenet's packed batch.
  :func:`occupancy.varlen_row_tiles` (the fp32 ``varlen_fwd`` / ``varlen_dq``'s
  walk) on the same offsets and on hand-made ones: every row, the capacity
  tail's too, in exactly one tile that lies in one segment and carries
  exactly that segment's keys; empty segments, a segment with no keys, the
  cache.  :func:`varlen.varlen_plan` at its boundaries, pinned to
  ``FwdFma`` (``csrc/fma_fwd.cuh``), ``DqFma`` and ``DkvFma``
  (``csrc/fma_bwd.cuh``) and the row kernels of ``csrc/varlen_fwd.cu`` and
  ``csrc/varlen_bwd.cu``.
- :func:`epilogue.epilogue_plan`, the one rule of both epilogues, at every
  configuration the port registers (its head dim, both dtypes, aligned or
  not), with both ``vec`` kernels taking their rows and lanes from
  ``csrc/epilogue.cuh`` (``RowLane``, ``epilogue_vec_blocks``, ``Vec``),
  the lanes each entry point instantiates being the rule's, and the
  forward's threads, rows and lanes covering every element of R rows once
  for every R up to a few blocks.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, list_configs
from repro_torch.core.balltree import pack_varlen
from repro_torch.kernels import bta, epilogue, flash, local, varlen
from repro_torch.kernels.common import HEAD_DIMS
from repro_torch.kernels.occupancy import (local_half_live, varlen_dkv_tiles,
                                            varlen_row_tiles)
from repro_torch.numerics import NEG_INF, segment_ids_from_offsets

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
DTYPES = [torch.bfloat16, torch.float32]


def _consts(path: Path, struct: str, D: int) -> dict[str, int]:
    """The first ``static constexpr int`` line of a tile struct, evaluated
    at head dim D (``a ? b : c`` included)."""
    body = re.search(r"struct %s \{\n\s*static constexpr int ([^;]*);" % struct,
                     path.read_text())
    out = {}
    for name, expr in re.findall(r"(\w+) = ([^,]+)", body.group(1)):
        m = re.fullmatch(r"D > (\d+) \? (\d+) : (\d+)", expr.strip())
        out[name] = ((int(m.group(2)) if D > int(m.group(1)) else int(m.group(3))) if m
                     else int(expr) if expr.strip().isdigit() else expr.strip())
    return out


# ---------------------------------------------------------------------------
# flash_fwd
# ---------------------------------------------------------------------------

# (mode, ℓ, L): N = L·ℓ positions block-causal (the pooled keys of N
# tokens), N = L causal, N = 3840 plain
FWD_CASES = [("plain", 8, 480), ("causal", 1, 480), ("causal", 1, 512)] + [
    ("block_causal", ell, L) for ell in (8, 64) for L in (480, 512)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode,ell,L", FWD_CASES)
def test_flash_fwd_walk_covers_visible_pairs(mode, ell, L, dtype):
    N = {"plain": 3840, "causal": L, "block_causal": L * ell}[mode]
    kw = dict(causal=mode == "causal", block_causal=mode == "block_causal", ell=ell)
    vis = flash.visible_keys(N, L, **kw)
    vis = torch.ones(N, L, dtype=torch.bool) if vis is None else vis
    plan = flash.flash_fwd_plan(64, dtype)
    walk = flash.fwd_walk(N, L, 64, dtype, **kw)
    assert [t0 for t0, _, _ in walk] == list(range(0, N, plan.rows))
    assert walk[-1][1] == N
    covered = torch.zeros(N, L, dtype=torch.bool)
    reported_empty = torch.zeros(N, dtype=torch.bool)
    for t0, t1, n_kt in walk:
        covered[t0:t1, :n_kt * plan.keys] = True
        reported_empty[t0:t1] = n_kt == 0
        assert n_kt * plan.keys < L + plan.keys            # never past the last key tile
        if mode != "plain":                                 # no staged tile wholly masked
            for kt in range(n_kt):
                assert vis[t0:t1, kt * plan.keys:(kt + 1) * plan.keys].any(), (t0, kt)
    assert not (vis & ~covered).any()                       # every visible pair staged
    sees_none = ~vis.any(1)
    assert not (reported_empty & ~sees_none).any()          # an empty tile sees nothing
    if mode == "block_causal" and ell % plan.rows == 0:     # ℓ 64: whole empty tiles
        assert torch.equal(reported_empty, sees_none)
        assert reported_empty[:ell].all() and not reported_empty[ell:].any()


def test_fwd_walk_stops_at_last_visible_tile():
    """Block-causal at the prefill shape (32,768 positions, ℓ 64, 512 keys):
    the 64-row tile ending at t_last stages ⌈⌊t_last / ℓ⌋ / 64⌉ key tiles,
    none for t < ℓ, and 56% of the 8 on average (a walk over every key
    would stage all 8)."""
    walk = flash.fwd_walk(32768, 512, 64, torch.bfloat16, block_causal=True, ell=64)
    assert len(walk) == 512 and walk[0] == (0, 64, 0) and walk[-1] == (32704, 32768, 8)
    assert [n for _, _, n in walk] == [-(-((t1 - 1) // 64) // 64) for _, t1, _ in walk]
    assert sum(n for _, _, n in walk) == 2296                   # of 512 · 8 = 4096


# ---------------------------------------------------------------------------
# local_dq / local_dkv
# ---------------------------------------------------------------------------

def _block_visibility(window: int, segmented: bool):
    """Visible pairs of block i = 1 of a 3-block sample (n_heads 1): rows
    of block i against [block i-1, block i] (w × 2w), and rows of block
    i+1 against block i (w × w).  ``segmented``: block i-1 and block i+1
    each lie in another segment than block i, so both prev halves are dead."""
    w = window
    key_bias = torch.zeros(1, 3 * w)
    seg = torch.tensor([[0, 1, 2]], dtype=torch.int32) if segmented else None
    ok = local._window_bias(key_bias, seg, w, 1)[0, :, 0] > NEG_INF / 2   # (nb, w, 2w)
    return ok[1], ok[2, :, :w]


@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("window", [64, 128, 256])
@pytest.mark.parametrize("D", [64, 128])
def test_local_walks_cover_visible_pairs(D, window, segmented):
    w = window
    plan = local.local_plan(w, D, torch.bfloat16)
    assert plan.path == "tiles"
    own, nxt = _block_visibility(w, segmented)
    # local_dq: block i's rows against keys −w..w (block i−1's at −w..0)
    covered = torch.zeros(w, 2 * w, dtype=torch.bool)
    for t0, t1, tiles in local.dq_walk(w, D, torch.bfloat16, live_prev=not segmented):
        assert t1 - t0 == plan.rows
        for j0, j1, diag in tiles:
            assert j1 - j0 == plan.key_tile and diag == (j0 == t0)
            blk = own[t0:t1, w + j0:w + j1]
            assert blk.any()                                    # never wholly masked
            assert blk.all() != diag                            # masked iff diagonal
            covered[t0:t1, w + j0:w + j1] = True
    assert not (own & ~covered).any()                           # every visible pair staged
    # local_dkv: block i's keys against the rows of blocks i and i+1
    vis = torch.cat([own[:, w:], nxt], dim=0)                   # (2w rows, w keys)
    covered = torch.zeros(2 * w, w, dtype=torch.bool)
    for j0, j1, tiles in local.dkv_walk(w, D, torch.bfloat16, live_next=not segmented):
        assert j1 - j0 == plan.keys
        for t0, t1, causal in tiles:
            assert t1 - t0 == plan.row_tile
            blk = vis[t0:t1, j0:j1]
            assert blk.any()
            assert blk.all() != causal
            covered[t0:t1, j0:j1] = True
    assert not (vis & ~covered).any()
    assert not covered[w:].any() if segmented else covered[w:].all()


def test_local_walk_rows_that_see_nothing():
    """Block 0 (no prev half) with a dead self half: ``dq_walk`` stages
    nothing, and its rows see no key in the plain version's mask."""
    ok = local._window_bias(torch.full((1, 128), NEG_INF), None, 64, 1)[0, 0, 0] > NEG_INF / 2
    assert not ok.any()
    assert all(not tiles for _, _, tiles in
               local.dq_walk(64, 64, torch.bfloat16, live_prev=False, live_self=False))


# (name, masked positions of a 3-block sample as slices in units of w/64,
# segment ids of the blocks or None)
FWD_LOCAL_MASKS = {
    "full": ([], None),
    "segmented": ([], [0, 1, 2]),
    "hole": ([(65, 104)], None),                 # a ragged hole in block 1
    "padded_tail": ([(145, 192)], None),         # block 2's last 47 positions
    "dead_block": ([(64, 128)], None),           # block 1: self half dead
    "dead_halves": ([(0, 128)], None),           # block 1: both halves dead
    "masked_lead": ([(0, 100)], None),           # rows that see nothing, walked
}


@pytest.mark.parametrize("case", list(FWD_LOCAL_MASKS))
@pytest.mark.parametrize("window", [64, 128, 256])
@pytest.mark.parametrize("D", [64, 128])
def test_local_fwd_walk_covers_visible_pairs(D, window, case):
    """Every block of a 3-block sample, walked as ``local_fwd_mma`` walks it
    (:func:`local.dq_walk` with the halves' liveness the wrapper computes),
    against the plain version's (w, 2w) mask: every visible pair staged, only
    the diagonal tile index-masked, and a row block that stages nothing
    holds rows that see nothing; rows that see nothing inside a walked block
    finish with l = 0 (zeros and ``LSE_EMPTY``) in the kernel."""
    w = window
    spans, seg = FWD_LOCAL_MASKS[case]
    valid = torch.ones(1, 3 * w, dtype=torch.bool)
    for a, b in spans:
        valid[0, a * w // 64:b * w // 64] = False
    key_bias = torch.where(valid, 0.0, NEG_INF)
    blk_seg = None if seg is None else torch.tensor([seg], dtype=torch.int32)
    plan = local.local_plan(w, D, torch.bfloat16)
    assert plan.path == "tiles"
    ok = local._window_bias(key_bias, blk_seg, w, 1)[0, :, 0] > NEG_INF / 2  # (3, w, 2w)
    index_ok = local._window_bias(torch.zeros(1, 3 * w), None, w, 1)[0, 1, 0] > NEG_INF / 2
    live = local_half_live(key_bias, w, blk_seg)[0]
    sees_nothing, walked_nothing = 0, 0
    for i in range(3):
        vis = ok[i]
        walk = local.dq_walk(w, D, torch.bfloat16, live_prev=bool(live[i, 0]),
                             live_self=bool(live[i, 1]))
        assert [t0 for t0, _, _ in walk] == list(range(0, w, plan.rows))
        covered = torch.zeros(w, 2 * w, dtype=torch.bool)
        for t0, t1, tiles in walk:
            nothing = ~vis[t0:t1].any(1)
            if not tiles:                                       # zeros, LSE_EMPTY
                assert nothing.all()
            walked_nothing += int(nothing.sum()) if tiles else 0
            for j0, j1, diag in tiles:
                assert j1 - j0 == plan.key_tile and diag == (j0 == t0)
                blk = index_ok[t0:t1, w + j0:w + j1]
                assert blk.any() and blk.all() != diag          # masked iff diagonal
                covered[t0:t1, w + j0:w + j1] = True
        assert not (vis & ~covered).any()                       # every visible pair staged
        sees_nothing += int((~vis.any(1)).sum())
    # dead_halves: blocks 0 and 1 see nothing and stage nothing; masked_lead:
    # block 0 stages nothing, block 1's first 36/64 of w rows are walked
    # (its self half is live) and see nothing
    assert sees_nothing == {"dead_halves": 2 * w, "masked_lead": 100 * w // 64}.get(case, 0)
    assert walked_nothing == (36 * w // 64 if case == "masked_lead" else 0)


# ---------------------------------------------------------------------------
# bta_fwd / bta_bwd (the fma path)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rep", [1, 2])
@pytest.mark.parametrize("m", [64, 128, 256])
@pytest.mark.parametrize("D", [16, 32])
def test_bta_walks_visit_each_pair_once(D, m, rep):
    """The fma forward's row blocks × key tiles and the fused backward's
    row tiles × key warps over one live ball: every (row, key) pair of the
    ball's rep·m rows and m keys exactly once, each row block or tile inside
    one query head (it divides m), in order."""
    plan = bta.bta_plan(m, D, rep, torch.float32)
    assert plan.path == "fma"
    for walk, rows in ((bta.fwd_walk(m, D, rep, torch.float32), plan.rows),
                       (bta.bwd_walk(m, D, rep, torch.float32), plan.row_tile)):
        seen = torch.zeros(rep * m, m, dtype=torch.int32)
        assert [t0 for t0, _, _ in walk] == list(range(0, rep * m, rows))
        for t0, t1, keys in walk:
            assert t1 - t0 == rows and t0 // m == (t1 - 1) // m     # one query head
            assert keys[0][0] == 0 and keys[-1][1] == m
            assert all(a[1] == b[0] for a, b in zip(keys, keys[1:]))
            for j0, j1 in keys:
                seen[t0:t1, j0:j1] += 1
        assert bool((seen == 1).all())


@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("m", [64, 256, 512])
@pytest.mark.parametrize("D", [64, 128])
def test_bta_mma_walks_visit_each_pair_once(D, m, rep):
    """The bf16 mma path over one live ball: the forward's 64-row blocks ×
    64-key tiles, the backward's dQ blocks (64 rows × the ball's key tiles)
    and dK/dV blocks (64 keys × the ball's rep·m rows in row tiles of 64, 32
    at D 128) each visit every (row, key) pair of the ball exactly once,
    each block or tile inside one query head, in order."""
    plan = bta.bta_plan(m, D, rep, torch.bfloat16)
    assert plan == ("mma", 64, 64, 32 if D > 64 else 64)
    fwd = bta.fwd_walk(m, D, rep, torch.bfloat16)
    dq = bta.bwd_walk(m, D, rep, torch.bfloat16, role="dq")
    dkv = bta.bwd_walk(m, D, rep, torch.bfloat16, role="dkv")
    assert fwd == dq
    assert [(t0, t1) for t0, t1, _ in dkv] == [
        (t, t + plan.row_tile) for _ in range(m // plan.key_tile)
        for t in range(0, rep * m, plan.row_tile)]
    for walk in (fwd, dkv):
        seen = torch.zeros(rep * m, m, dtype=torch.int32)
        for t0, t1, keys in walk:
            assert t0 // m == (t1 - 1) // m                          # one query head
            assert all(j1 - j0 == plan.key_tile for j0, j1 in keys)
            assert all(a[1] == b[0] for a, b in zip(keys, keys[1:]))
            for j0, j1 in keys:
                seen[t0:t1, j0:j1] += 1
        assert bool((seen == 1).all())
    with pytest.raises(ValueError):
        bta.bwd_walk(m, D, rep, torch.bfloat16, role="dk")


def test_bta_bwd_walk_paper_shape():
    """shapenet's ball (256 keys, D 32, rep 1): the fused backward walks 8
    row tiles of 32, each against the ball's 8 key warps of 32 keys, and the
    forward 4 blocks of 64 rows, each over 8 key tiles of 32."""
    assert [(t0, t1, len(keys)) for t0, t1, keys in bta.bwd_walk(256, 32, 1, torch.float32)] \
        == [(t, t + 32, 8) for t in range(0, 256, 32)]
    assert [(t0, t1, len(keys)) for t0, t1, keys in bta.fwd_walk(256, 32, 1, torch.float32)] \
        == [(t, t + 64, 8) for t in range(0, 256, 64)]
    with pytest.raises(ValueError):
        bta.bwd_walk(256, 64, 1, torch.float32)                      # the rows path


# ---------------------------------------------------------------------------
# the rules, at the port's configurations, pinned to the CUDA sources
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list_configs())
def test_plans_for_configs(name):
    cfg = get_config(name)
    D, dtype = cfg.resolved_head_dim, getattr(torch, cfg.compute_dtype)
    if cfg.attention == "none":
        # mamba2: no attention layer, so no kernel; its resolved head dim
        # (d_model) is one no attention kernel takes
        assert cfg.family == "ssm" and not cfg.n_heads
        with pytest.raises(ValueError, match="flash_fwd: no path"):
            flash.flash_fwd_plan(D, dtype)
        return
    fwd = flash.flash_fwd_plan(D, dtype)
    assert fwd.path == ("mma" if dtype == torch.bfloat16 else "fma")
    if cfg.bsa.local_window:
        w = cfg.bsa.effective_local_window
        plan = local.local_plan(w, D, dtype)            # local_fwd's path and the backward's
        assert plan.path == ("tiles" if dtype == torch.bfloat16 and w % 64 == 0 else "lanes")
    if name == "tinyllama-1.1b":
        assert tuple(fwd) == ("mma", 64, 64)
        assert tuple(local.local_plan(256, 64, dtype)) == ("tiles", 64, 64, 64, 64)
    if name == "shapenet-bsa":
        assert tuple(fwd) == ("fma", 64, 32)
    if cfg.attention == "bsa" and D not in HEAD_DIMS["bta_fwd"]:
        # D 128 (phi4-mini, granite, the MoE LMs, jamba, llava; all bf16 with
        # balls of 256): the ball kernels' mma path takes them (the causal LM
        # runs the local window in place of the ball branch), fp32 none
        assert cfg.family in ("dense", "moe", "hybrid", "vlm")
        m, rep = cfg.bsa.ball_size, cfg.n_heads // cfg.n_kv_heads
        assert dtype == torch.bfloat16 and m % 64 == 0
        assert tuple(bta.bta_plan(m, D, rep, dtype)) == ("mma", 64, 64, 32)
        with pytest.raises(ValueError, match="bta: no path"):
            bta.bta_plan(m, D, rep, torch.float32)
    elif cfg.attention == "bsa":
        m, rep = cfg.bsa.ball_size, cfg.n_heads // cfg.n_kv_heads
        ball = bta.bta_plan(m, D, rep, dtype)           # bta_fwd's path and bta_bwd's
        fma = dtype == torch.float32 and D in (16, 32) and m % 64 == 0 and m <= 256
        mma = dtype == torch.bfloat16 and m % 64 == 0
        assert ball.path == ("fma" if fma else "mma" if mma else "rows")
        if name == "shapenet-bsa":
            assert tuple(ball) == ("fma", 64, 32, 32)
        if name == "seamless-m4t-medium":
            assert tuple(ball) == ("mma", 64, 64, 64)


@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_plans_match_source_constants(D):
    fwd_src, bwd_src, common = (CSRC / f for f in ("flash_fwd.cu", "local_bwd.cu",
                                                   "common.cuh"))
    for dtype, src, struct in ((torch.bfloat16, fwd_src, "FwdMma"),
                               (torch.float32, CSRC / "fma_fwd.cuh", "FwdFma")):
        plan, c = flash.flash_fwd_plan(D, dtype), _consts(src, struct, D)
        assert (plan.rows, plan.keys) == (c["BM"], c["BK"]), struct
    tiles = local.local_plan(256, D, torch.bfloat16)
    dq, dkv = _consts(bwd_src, "DqMma", D), _consts(bwd_src, "DkvMma", D)
    assert (tiles.rows, tiles.key_tile) == (dq["BM"], dq["BK"])
    lfwd_src = CSRC / "local_fwd.cu"
    lfwd = _consts(lfwd_src, "FwdMma", D)              # local_fwd_mma: 64 rows, 64-key tiles
    assert (tiles.rows, tiles.key_tile) == (lfwd["BM"], lfwd["BK"]) == (64, 64)
    assert int(re.search(r"kRows = (\d+);", lfwd_src.read_text()).group(1)) == 128
    assert (tiles.keys, tiles.row_tile) == (dkv["BK"], dkv["BM"])
    lanes = local.local_plan(32, D, torch.bfloat16)
    text = bwd_src.read_text()
    threads = int(re.search(r"kThreads = (\d+);", text).group(1))
    lanes_a_row = int(re.search(r"kLanes = (\d+);", text).group(1))
    assert lanes.rows == lanes.keys == threads // lanes_a_row
    staged = re.search(r"kTileRows = D > 64 \? (\d+) / D : (\d+);", common.read_text())
    assert lanes.key_tile == lanes.row_tile == (int(staged.group(1)) // D if D > 64
                                                else int(staged.group(2)))


@pytest.mark.parametrize("D", [16, 32, 64])
def test_bta_plan_matches_source_constants(D):
    """The fma path's tiles are ``FwdFma``'s (``csrc/bta_fwd.cu``: 64 rows a
    block, 32-key tiles) and ``BwdFma``'s (``csrc/bta_bwd.cu``: 32-row
    tiles, balls up to MMAX keys); the rows path's forward block is one
    thread a row, up to 256."""
    fwd = _consts(CSRC / "bta_fwd.cu", "FwdFma", D)
    bwd = _consts(CSRC / "bta_bwd.cu", "BwdFma", D)
    assert bwd["MMAX"] == bta.FMA_MAX_BALL
    for m in (64, 256):
        plan = bta.bta_plan(m, D, 1, torch.float32)
        if D == 64:                                     # dK, dV would not fit the registers
            assert plan == ("rows", min(256, m), m, m)
        else:
            assert (plan.rows, plan.key_tile, plan.row_tile) == (fwd["BM"], fwd["BK"], bwd["BM"])
    text = (CSRC / "bta_bwd.cu").read_text()
    assert "atomicAdd" not in text                      # each ball's gradients owned by a block


@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_bta_mma_plan_matches_source_constants(D):
    """The mma path's tiles are ``FwdMma``'s (``csrc/bta_fwd.cu``: 64 rows a
    block, 64-key tiles) and ``BwdMma``'s (``csrc/bta_bwd.cu``: dQ blocks of
    BM rows over BK-key tiles, dK/dV blocks of BK keys over RT-row tiles),
    at every ball that is a multiple of 64; the entry points take the
    wrapper's path code as their last int."""
    fwd = _consts(CSRC / "bta_fwd.cu", "FwdMma", D)
    bwd = _consts(CSRC / "bta_bwd.cu", "BwdMma", D)
    for m in (64, 256, 1024):
        plan = bta.bta_plan(m, D, 3, torch.bfloat16)
        assert plan.path == "mma"
        assert (plan.rows, plan.key_tile) == (fwd["BM"], fwd["BK"]) == (bwd["BM"], bwd["BK"])
        assert plan.row_tile == bwd["RT"]
    assert bta.PATH_CODES == {"rows": 0, "fma": 1, "mma": 2}
    # the tile steps are shared: the forward's with flash_fwd_mma and
    # local_fwd_mma, the backward's two with local_dq_mma / local_dkv_mma
    assert "rt::mma_fwd_walk" in (CSRC / "bta_fwd.cu").read_text()
    for src in ("bta_bwd.cu", "local_bwd.cu"):
        text = (CSRC / src).read_text()
        assert "rt::mma_dq_tile" in text and "rt::mma_dkv_tile" in text
    for src in ("bta_fwd.cu", "bta_bwd.cu"):
        text = (CSRC / src).read_text()
        assert "if (path == 2)" in text and "if (path == 1)" in text
        assert not re.search(r"\batomic\w*\(", text)             # no atomic of any kind


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [16, 32, 64, 256])
@pytest.mark.parametrize("D", [16, 32, 64])
def test_bta_plan_boundaries(D, m, dtype):
    """bf16 with a ball that is a multiple of 64 takes the mma path at every
    head dim, with no upper limit on the ball; fp32 at D 16 / 32 with a
    ball that is a multiple of 64 up to 256 takes the fma path (both
    kernels); the small balls (the tests' 16, the smoke config's 32) and
    fp32 at D 64 or above 256 take the rows path, whose walks the mirrors
    refuse."""
    plan = bta.bta_plan(m, D, 2, dtype)
    bf16 = dtype == torch.bfloat16
    tiled = "mma" if bf16 else "fma" if D != 64 else "rows"
    assert plan.path == (tiled if m % 64 == 0 else "rows")
    if plan.path == "rows":
        assert plan.rows == min(256, 2 * m) and plan.key_tile == plan.row_tile == m
        with pytest.raises(ValueError):
            bta.bwd_walk(m, D, 2, dtype)
    # a ball of 512: over the fma block's registers, streamed by the mma path
    assert bta.bta_plan(512, D, 1, dtype).path == ("mma" if bf16 else "rows")


@pytest.mark.parametrize("window,dtype,path", [(256, torch.bfloat16, "tiles"),
                                               (64, torch.bfloat16, "tiles"),
                                               (32, torch.bfloat16, "lanes"),
                                               (96, torch.bfloat16, "lanes"),
                                               (256, torch.float32, "lanes")])
def test_local_plan_boundary(window, dtype, path):
    assert local.local_plan(window, 64, dtype).path == path


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [32, 64, 256])
@pytest.mark.parametrize("D", [64, 128])
def test_local_fwd_plan_boundaries(D, window, dtype):
    """The forward's path at windows 32 / 64 / 256 × fp32 / bf16: the tiled
    ``local_fwd_mma`` for bf16 at a multiple of 64, ``local_fwd_rows``
    otherwise (whose walk the tiled mirror refuses)."""
    plan = local.local_plan(window, D, dtype)
    tiles = dtype == torch.bfloat16 and window % 64 == 0
    assert plan.path == ("tiles" if tiles else "lanes")
    if tiles:
        walk = local.dq_walk(window, D, dtype)
        assert len(walk) == window // 64
        assert [len(t) for _, _, t in walk] == [window // 64 + c + 1
                                                for c in range(window // 64)]
    else:
        with pytest.raises(ValueError):
            local.dq_walk(window, D, dtype)


# ---------------------------------------------------------------------------
# varlen_dkv's planned walk
# ---------------------------------------------------------------------------

# (cloud sizes, ball, ℓ, capacity): ragged segments with an empty one; a
# segment shorter than one 64-row tile; shapenet's packed train batch (8
# clouds of 2800–3586 points at ball 256, ℓ 8, capacity 30,720)
VARLEN_LAYOUTS = {
    "ragged": ((300, 20, 530, 0, 97), 16, 4, 1280),
    "short": ((40, 700, 12), 16, 8, 1024),
    "paper": ((3586, 2800, 3100, 3333, 2950, 3500, 3010, 2871), 256, 8, 30720),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("heads", [1, 8])
@pytest.mark.parametrize("layout", list(VARLEN_LAYOUTS))
def test_varlen_dkv_tiles_cover_each_key_once(layout, heads, dtype):
    sizes, ball, ell, T = VARLEN_LAYOUTS[layout]
    _, offsets, _ = pack_varlen([np.zeros((n, 1)) for n in sizes], ball, pad_to=T,
                                max_samples=len(sizes))
    L = T // ell
    plan = varlen.varlen_plan(32, torch.float32)
    tiles = varlen_dkv_tiles(offsets, offsets // ell, T, L, "cpu", keys=plan.keys,
                             rows=plan.row_tile, heads=heads)
    table, S = tiles.table, tiles.splits
    assert table.dtype == torch.int32 and table.shape[1:] == (S, 4)
    qseg = segment_ids_from_offsets(torch.from_numpy(offsets), T)
    kseg = segment_ids_from_offsets(torch.from_numpy(offsets // ell), L)
    seen = torch.zeros(L, dtype=torch.long)
    longest = 0
    for t in table.tolist():
        j0, nk = t[0][:2]
        assert all(sp[:2] == [j0, nk] for sp in t) and 1 <= nk <= plan.keys
        seen[j0:j0 + nk] += 1
        seg = int(kseg[j0])
        assert bool((kseg[j0:j0 + nk] == seg).all())              # one segment
        assert nk == plan.keys or j0 + nk == L or int(kseg[j0 + nk]) != seg  # ragged: last
        rows = (qseg == seg).nonzero().flatten()
        r0, r1 = (int(rows[0]), int(rows[-1]) + 1) if rows.numel() else (t[0][2],) * 2
        assert r1 - r0 == rows.numel()                            # the segment's rows
        longest = max(longest, r1 - r0)
        assert t[0][2] == r0 and t[-1][3] == r1                   # covered, in order
        for a, b in zip(t[:-1], t[1:]):
            assert a[3] == b[2] and a[2] <= a[3]
            assert (a[3] - a[2]) % plan.row_tile == 0 or b[2] == b[3] == r1
    assert bool((seen == 1).all())                                # each key once
    blocks = table.shape[0] * heads
    assert S == max(1, min(-(-4 * 132 // blocks), -(-longest // plan.row_tile)))
    if layout == "paper":             # 62 tiles, 4 of them ragged: 2 splits for 8 heads
        assert (table.shape[0], S) == (62, {1: 9, 8: 2}[heads])
        assert int((table[:, 0, 1] < plan.keys).sum()) == 4
    if dtype == torch.bfloat16:
        assert varlen.varlen_plan(32, dtype).path == "rows"


@pytest.mark.parametrize("rows", [64, 16])
@pytest.mark.parametrize("layout", list(VARLEN_LAYOUTS))
def test_varlen_row_tiles_cover_each_row_once(layout, rows):
    """Every row of [0, T), the capacity tail's too, lies in exactly one
    tile of at most ``rows`` rows inside one segment (only a segment's last
    tile ragged, the tiles in order), and each tile carries exactly its
    segment's keys; an empty segment gives no tile; equal offsets give the
    cached table back."""
    sizes, ball, ell, T = VARLEN_LAYOUTS[layout]
    _, offsets, _ = pack_varlen([np.zeros((n, 1)) for n in sizes], ball, pad_to=T,
                                max_samples=len(sizes))
    L = T // ell
    table = varlen_row_tiles(offsets, offsets // ell, T, L, "cpu", rows=rows)
    assert table.dtype == torch.int32 and table.shape[1] == 4
    qseg = segment_ids_from_offsets(torch.from_numpy(offsets), T)
    kseg = segment_ids_from_offsets(torch.from_numpy(offsets // ell), L)
    seen = torch.zeros(T, dtype=torch.long)
    segs = []
    for t0, n, k0, k1 in table.tolist():
        assert 1 <= n <= rows
        seen[t0:t0 + n] += 1
        seg = int(qseg[t0])
        assert bool((qseg[t0:t0 + n] == seg).all())                 # one segment
        assert n == rows or t0 + n == T or int(qseg[t0 + n]) != seg  # ragged: the last
        keys = (kseg == seg).nonzero().flatten()
        assert k1 - k0 == keys.numel() and k0 == int(keys[0])        # exactly its keys
        segs.append(seg)
    assert bool((seen == 1).all())                                    # each row once
    assert segs == sorted(segs)
    counts = torch.bincount(qseg, minlength=len(offsets)).tolist()
    assert len(table) == sum(-(-c // rows) for c in counts)           # none for an empty one
    if layout == "paper":             # every segment a multiple of 64 rows: 480 tiles
        assert len(table) == T // rows
    again = varlen_row_tiles(list(offsets), torch.from_numpy(offsets // ell), T, L, "cpu",
                             rows=rows)
    assert again is table


@pytest.mark.parametrize("q_offsets,k_offsets,T,L,want", [
    # segment 0 has rows but no keys; segment 1 none of either; the tail has both
    ([0, 16, 16], [0, 0, 0], 40, 6, [(0, 16, 0, 0), (16, 16, 0, 6), (32, 8, 0, 6)]),
    # no capacity tail; segment 0 empty; a tail of keys with no rows
    ([0, 0, 20], [0, 0, 3], 20, 5, [(0, 16, 0, 3), (16, 4, 0, 3)]),
    # an empty axis gives no tile
    ([0, 0], [0, 0], 0, 0, []),
], ids=["no-keys", "no-tail", "empty"])
def test_varlen_row_tiles_edges(q_offsets, k_offsets, T, L, want):
    """Hand-made offsets: a segment with rows and no keys gets a tile with an
    empty key range (the kernels write zeros and ``LSE_EMPTY`` for it), a
    segment with no rows gets no tile, whatever its keys."""
    table = varlen_row_tiles(q_offsets, k_offsets, T, L, "cpu", rows=16)
    assert [tuple(t) for t in table.tolist()] == want and table.shape == (len(want), 4)


@pytest.mark.parametrize("D", [16, 32, 64])
def test_varlen_plan_matches_source_constants(D):
    """fp32 takes the fma path of all three kernels with the tiles of the
    shared blocks: ``FwdFma`` (``csrc/fma_fwd.cuh``, shared with
    ``flash_fwd_fma``) and ``DqFma`` (``csrc/fma_bwd.cuh``, shared with
    ``flash_dq_fma``), 64 rows against 32-key tiles, one row plan for both;
    ``DkvFma``'s 64 keys against 64-row tiles.  bf16 takes the rows path:
    ``kRows`` rows against ``kTile``-key tiles (``csrc/varlen_fwd.cu`` and
    ``csrc/varlen_bwd.cu`` alike), ``kKeys`` keys against ``kQTile``-row
    tiles.  Each tile struct lives once, in its shared header."""
    fma = varlen.varlen_plan(D, torch.float32)
    fwd = _consts(CSRC / "fma_fwd.cuh", "FwdFma", D)
    dq = _consts(CSRC / "fma_bwd.cuh", "DqFma", D)
    dkv = _consts(CSRC / "fma_bwd.cuh", "DkvFma", D)
    assert fma == ("fma", fwd["BM"], dkv["BK"], fwd["BK"], dkv["BM"]) == ("fma", 64, 64, 32, 64)
    assert (dq["BM"], dq["BK"]) == (fwd["BM"], fwd["BK"])
    rows = varlen.varlen_plan(D, torch.bfloat16)
    fwd_src, bwd_src = ((CSRC / f).read_text() for f in ("varlen_fwd.cu", "varlen_bwd.cu"))

    def const(text, name):
        return int(re.search(r"%s = (\d+);" % name, text).group(1))

    for text in (fwd_src, bwd_src):
        assert (rows.rows, rows.key_tile) == (const(text, "kRows"), const(text, "kTile"))
    assert rows == ("rows", 128, const(bwd_src, "kKeys"), 64, const(bwd_src, "kQTile"))
    assert "rt::fma_fwd_walk" in fwd_src and "atomicAdd" not in fwd_src + bwd_src
    flash_fwd, flash_bwd = ((CSRC / f).read_text() for f in ("flash_fwd.cu", "flash_bwd.cu"))
    for block, users in (("rt::fma_dkv_block", (flash_bwd, bwd_src)),
                         ("rt::fma_dq_block", (flash_bwd, bwd_src))):
        assert all(block in text for text in users)                  # one shared block
    assert not re.search(r"struct (FwdFma|DqFma|DkvFma)\b", flash_fwd + flash_bwd)


@pytest.mark.parametrize("call", [lambda: flash.flash_fwd_plan(48, torch.bfloat16),
                                  lambda: flash.flash_fwd_plan(64, torch.float16),
                                  lambda: local.local_plan(0, 64, torch.bfloat16),
                                  lambda: local.local_plan(256, 48, torch.float32),
                                  lambda: local.dkv_walk(32, 64, torch.bfloat16),
                                  lambda: bta.bta_plan(256, 48, 1, torch.float32),
                                  lambda: bta.bta_plan(256, 128, 1, torch.float32),
                                  lambda: bta.bta_plan(32, 128, 1, torch.bfloat16),
                                  lambda: bta.bta_plan(256, 32, 1, torch.float16),
                                  lambda: bta.bta_plan(0, 32, 1, torch.float32),
                                  lambda: bta.fwd_walk(32, 32, 1, torch.float32),
                                  lambda: varlen.varlen_plan(128, torch.float32),
                                  lambda: varlen.varlen_plan(48, torch.bfloat16),
                                  lambda: varlen.varlen_plan(32, torch.float16),
                                  lambda: varlen_row_tiles([0, 8], [0, 1, 2], 8, 2, "cpu",
                                                           rows=64),
                                  lambda: varlen_row_tiles([0, 48, 32], [0, 6, 4], 64, 8,
                                                           "cpu", rows=64)],
                         ids=["fwd-D48", "fwd-fp16", "local-w0", "local-D48", "walk-lanes",
                              "bta-D48", "bta-D128", "bta-D128-ball32", "bta-fp16", "bta-m0",
                              "bta-walk-rows",
                              "varlen-D128", "varlen-D48", "varlen-fp16", "rows-lengths",
                              "rows-order"])
def test_plans_raise(call):
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(n for n in list_configs()
                                        if get_config(n).attention != "none"))
def test_epilogue_plan_is_one_rule_for_both_kernels(name, dtype):
    """Each registered configuration with attention (mamba2 has none, so no
    combine) sends its head dim to ``vec`` when its
    rows are 16-byte vectors (lanes D / per-vector, up to 32, times rows a
    warp = 32), to ``warp`` when an input is off 16 bytes; both kernels
    read the rule from ``csrc/epilogue.cuh`` and instantiate its lanes."""
    D = get_config(name).head_dim
    per_vec = 16 // dtype.itemsize
    plan = epilogue.epilogue_plan(D, dtype)
    if D % per_vec == 0:
        assert plan.path == "vec" and plan.lanes * plan.rows == 32
        assert plan.lanes == min(32, 1 << ((D // per_vec).bit_length() - 1))
    assert epilogue.epilogue_plan(D, dtype, aligned=False).path == "warp"
    head = (CSRC / "epilogue.cuh").read_text()
    assert "struct RowLane" in head and "epilogue_vec_blocks" in head
    for src in ("epilogue_fwd.cu", "epilogue_bwd.cu"):
        text = (CSRC / src).read_text()
        assert '#include "epilogue.cuh"' in text and "struct Vec" not in text
        assert "rt::RowLane<L>" in text and "rt::epilogue_vec_blocks(R, L)" in text
    fwd = (CSRC / "epilogue_fwd.cu").read_text()
    assert [int(n) for n in re.findall(r"EPI_VEC\((\d+)\)", fwd)] == [1, 2, 4, 8, 16, 32]


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
def test_epilogue_vec_rows_and_lanes_cover_each_element_once(lanes):
    """``RowLane``'s map (thread t of ``epilogue_vec_blocks(R, L)`` blocks
    of 256: row t // L, lane t % L, vectors lane, lane + L, ...) writes
    every vector of R rows of D = 2·L vectors exactly once, at R from 1 to
    past two blocks' rows."""
    threads = 256
    vectors = 2 * lanes
    for R in (1, 7, threads // lanes + 1, 2 * threads // lanes + 3):
        blocks = -(-R * lanes // threads)
        t = torch.arange(blocks * threads)
        row, sub = t // lanes, t % lanes
        live = row < R
        hits = torch.zeros(R, vectors, dtype=torch.int64)
        for k in range(0, vectors, lanes):
            hits.index_put_((row[live], sub[live] + k), torch.ones(int(live.sum()),
                            dtype=torch.int64), accumulate=True)
        assert (hits == 1).all()
