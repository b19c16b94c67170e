"""The epilogue backward's rule and the walk of its ``vec`` kernel, against
the plain version and the JAX package.

- :func:`epilogue.epilogue_bwd_plan`, the one rule that sends rows of D
  elements to the ``vec`` kernel (a row on L lanes, 16-byte vectors) or the
  ``warp`` kernel (one warp a row), held to ``csrc/epilogue_bwd.cu``'s
  lanes, vector widths and block size.
- The ``vec`` kernel's walk (``epilogue_bwd_vec``: blocks of 256 threads,
  thread t on row t / L and lane t % L, the lane's vectors sub, sub + L,
  ..., the sums over D for d gᵦ a butterfly over the row's L lanes, lane
  k < 3 storing d g_k) mirrored in PyTorch against
  ``gated_combine_bwd_plain`` and JAX's ``_bwd_kernel`` in interpret mode,
  at D 16 / 32 / 64 / 128 in fp32 and bf16 and R no multiple of a block's
  rows.

Tolerances: fp32 1e-4, bf16 4e-2 (the port's kernel tolerances); d oᵦ is
the same product in both, so it is held to the plain version's bits.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import epilogue as j_epi
from repro_torch.kernels import epilogue

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4), torch.bfloat16: dict(atol=4e-2, rtol=4e-2)}
THREADS = 256

# (D, dtype, aligned) -> (path, lanes, rows a warp)
PLANS = [
    ((32, torch.float32, True), ("vec", 8, 4)),       # shapenet
    ((64, torch.bfloat16, True), ("vec", 8, 4)),      # tinyllama
    ((128, torch.float32, True), ("vec", 32, 1)),     # phi4-mini's heads
    ((128, torch.bfloat16, True), ("vec", 16, 2)),
    ((16, torch.float32, True), ("vec", 4, 8)),
    ((16, torch.bfloat16, True), ("vec", 2, 16)),
    ((256, torch.float32, True), ("vec", 32, 1)),     # two vectors a lane
    ((48, torch.float32, True), ("vec", 8, 4)),       # 12 vectors on 8 lanes
    ((8, torch.bfloat16, True), ("vec", 1, 32)),
    ((4, torch.float32, True), ("vec", 1, 32)),
    ((12, torch.bfloat16, True), ("warp", 32, 1)),    # no whole vector
    ((2, torch.float32, True), ("warp", 32, 1)),
    ((30, torch.float32, True), ("warp", 32, 1)),
    ((32, torch.float32, False), ("warp", 32, 1)),    # an input off 16 bytes
]


@pytest.mark.parametrize("case,plan", PLANS,
                         ids=[f"D{c[0]}-{str(c[1])[6:]}-{'al' if c[2] else 'off'}"
                              for c, _ in PLANS])
def test_epilogue_bwd_plan(case, plan):
    assert tuple(epilogue.epilogue_bwd_plan(*case)) == plan


def test_epilogue_bwd_source_constants():
    """The lanes the C entry point takes (0 = the warp kernel), the vector
    widths (16 bytes) and the block of the ``vec`` kernel."""
    src = (CSRC / "epilogue_bwd.cu").read_text()
    assert re.search(r"constexpr int kThreads = (\d+);", src).group(1) == str(THREADS)
    cases = re.findall(r"case (\d+): return launch_(\w+)<", src)
    assert cases == [("0", "warp")] + [(str(n), "vec") for n in (1, 2, 4, 8, 16, 32)]
    widths = dict(re.findall(r"struct Vec<(\w+)> \{\n\s*static constexpr int N = (\d+);", src))
    assert widths == {"float": "4", "__nv_bfloat16": "8"}
    for dt in (torch.float32, torch.bfloat16):
        for D in (16, 32, 64, 128, 256):
            plan = epilogue.epilogue_bwd_plan(D, dt)
            assert plan.lanes in (1, 2, 4, 8, 16, 32) and plan.lanes * plan.rows == 32


def _case(R, D, dtype, seed):
    rng = np.random.default_rng(seed)
    os_ = [rng.standard_normal((R, D)).astype(np.float32) for _ in range(3)]
    gs = [rng.random(R).astype(np.float32) for _ in range(3)]
    m = (rng.random(R) > 0.3).astype(np.float32)
    do = rng.standard_normal((R, D)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dtype)            # noqa: E731
    return [t(o) for o in os_], [torch.from_numpy(g) for g in gs], torch.from_numpy(m), t(do)


def _vec_walk(os_, gs, m, do):
    """A PyTorch mirror of ``epilogue_bwd_vec``'s walk: ceil(R·L / 256)
    blocks of 256 threads; thread t takes row t // L (none past R) and lane
    sub = t % L, loads the row's gates and mask and its vectors sub, sub +
    L, ... of N = 16 / itemsize elements, stores their d oᵦ and sums
    g·oᵦ over them in order; the row's L partial sums meet by a butterfly
    (xor 1, 2, ..., L/2) and lane k < 3 (lanes k, k + L, ... when L < 3)
    stores d g_k.  Every element of d oᵦ and every d g_k is written once.
    Returns (d o₁, d o₂, d o₃, d g₁, d g₂, d g₃)."""
    R, D = do.shape
    dtype = do.dtype
    plan = epilogue.epilogue_bwd_plan(D, dtype)
    assert plan.path == "vec"
    L, N = plan.lanes, 16 // dtype.itemsize
    n_threads = -(-R * L // THREADS) * THREADS
    douts = torch.full((3, R, D), float("nan")).to(dtype)
    dgs = torch.full((3, R), float("nan"))
    written = torch.zeros(3, R, D, dtype=torch.int64)
    dg_written = torch.zeros(3, R, dtype=torch.int64)
    for t in range(n_threads):
        r, sub = t // L, t % L
        if r >= R:
            continue
        g = do[r].float() * m[r]
        for c in range(sub * N, D, L * N):
            e = slice(c, c + N)
            for k in range(3):
                douts[k, r, e] = (gs[k][r] * g[e]).to(dtype)
                written[k, r, e] += 1
    # each lane's three sums over its vectors, element by element (all rows at once)
    sums = torch.zeros(3, R, L)
    for sub in range(L):
        for c in range(sub * N, D, L * N):
            for e in range(c, c + N):
                g = do[:, e].float() * m
                for k in range(3):
                    sums[k, :, sub] += g * os_[k][:, e].float()
    off = 1
    while off < L:
        sums = sums + sums[:, :, torch.arange(L) ^ off]
        off <<= 1
    for sub in range(L):
        for k in range(sub, 3, L):
            dgs[k] = sums[k, :, sub]
            dg_written[k] += 1
    assert (written == 1).all() and (dg_written == 1).all()
    return (*douts.unbind(0), *dgs.unbind(0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_epilogue_bwd_vec_walk_matches_plain_and_pallas(D, dtype):
    """R = 37 rows: no multiple of a block's rows at any L, so the last
    block has threads past R; the walk equals the plain version (d oᵦ bit
    for bit, d gᵦ within the tolerance) and JAX's ``_bwd_kernel``."""
    R = 37
    os_, gs, m, do = _case(R, D, dtype, D + (dtype == torch.bfloat16))
    plan = epilogue.epilogue_bwd_plan(D, dtype)
    assert R % (THREADS // plan.lanes) != 0
    got = _vec_walk(os_, gs, m, do)
    want = epilogue.gated_combine_bwd_plain(*os_, *gs, m, do)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jo = [jnp.asarray(o.float().numpy()).astype(jdt) for o in os_]
    jg = [jnp.asarray(g.numpy())[:, None] for g in gs]
    jwant = j_epi._bwd_call(*jo, *jg, jnp.asarray(m.numpy())[:, None],
                            jnp.asarray(do.float().numpy()).astype(jdt), tile=R,
                            interpret=True)
    for k in range(3):
        assert torch.equal(got[k], want[k])
        np.testing.assert_allclose(got[k].float().numpy(),
                                   np.asarray(jwant[k], np.float32), **TOL[dtype])
        np.testing.assert_allclose(got[3 + k].numpy(), want[3 + k].numpy(), **TOL[dtype])
        np.testing.assert_allclose(got[3 + k].numpy(), np.asarray(jwant[3 + k])[:, 0],
                                   **TOL[dtype])
    assert (got[3][m == 0] == 0).all()                        # a masked row: no gate gradient
