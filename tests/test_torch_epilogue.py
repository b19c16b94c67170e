"""The epilogues' rule and the walks of their ``vec`` kernels, and the
layer's ``ops.gated_combine``, against the plain versions and the JAX
package.

- :func:`epilogue.epilogue_plan`, the one rule that sends rows of D
  elements to the ``vec`` kernel (a row on L lanes, 16-byte vectors) or the
  ``warp`` kernel (one warp a row) of either epilogue, held to
  ``csrc/epilogue.cuh``'s and ``csrc/epilogue_bwd.cu``'s lanes, vector
  widths and block size.
- The ``vec`` kernel's walk (``epilogue_bwd_vec``: blocks of 256 threads,
  thread t on row t / L and lane t % L, the lane's vectors sub, sub + L,
  ..., the sums over D for d gᵦ a butterfly over the row's L lanes, lane
  k < 3 storing d g_k) mirrored in PyTorch against
  ``gated_combine_bwd_plain`` and JAX's ``_bwd_kernel`` in interpret mode,
  at D 16 / 32 / 64 / 128 in fp32 and bf16 and R no multiple of a block's
  rows.
- The forward ``vec`` kernel's walk (``epilogue_fwd_vec``: the same
  threads, rows and lanes; each lane reads its row's gates at
  ``(r / H)·gs + r % H`` and its token's mask) against
  ``gated_combine_fwd_plain`` (bit for bit) and JAX's ``_fwd_kernel``, with
  per-head gates (gs 0), per-row gates and the token-mode slice (gs 3H).
- ``ops.gated_combine`` with per-head (``gate_mode="scalar"``) and per-row
  (``"token"``, the layer's strided slice) gates, with and without a mask,
  forward and gradients to the outputs and the gates, against JAX's
  ``ops.gated_combine`` through the Pallas pair in interpret mode; a gate
  of another form raises.

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
    assert tuple(epilogue.epilogue_plan(*case)) == plan


def test_epilogue_bwd_source_constants():
    """The lanes the C entry point takes (0 = the warp kernel), the vector
    widths (16 bytes) and the block of the ``vec`` kernel."""
    head = (CSRC / "epilogue.cuh").read_text()
    src = (CSRC / "epilogue_bwd.cu").read_text()
    assert re.search(r"constexpr int kEpilogueThreads = (\d+);", head).group(1) == str(THREADS)
    assert "constexpr int kThreads = rt::kEpilogueThreads;" in src
    cases = re.findall(r"case (\d+): return launch_(\w+)<", src)
    assert cases == [("0", "warp")] + [(str(n), "vec") for n in (1, 2, 4, 8, 16, 32)]
    widths = dict(re.findall(r"struct Vec<(\w+)> \{\n\s*static constexpr int N = (\d+);", head))
    assert widths == {"float": "4", "__nv_bfloat16": "8"}
    for dt in (torch.float32, torch.bfloat16):
        for D in (16, 32, 64, 128, 256):
            plan = epilogue.epilogue_plan(D, dt)
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
    plan = epilogue.epilogue_plan(D, dtype)
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
    plan = epilogue.epilogue_plan(D, dtype)
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


# ---------------------------------------------------------------------------
# the forward: its vec kernel's walk, and ops.gated_combine against JAX
# ---------------------------------------------------------------------------

def _gate_forms(R, H, seed):
    """Gate values of the three forms the forward kernel reads, as fp32
    (T, H) tensors with unit stride along H: one a head ((1, H), stride 0
    in the kernel), one a row ((R/H, H), stride H) and the token-mode slice
    of a (R/H, 3H) projection (stride 3H)."""
    rng = np.random.default_rng(seed)
    proj = torch.from_numpy(rng.random((R // H, 3 * H)).astype(np.float32))
    return {"head": torch.from_numpy(rng.random((1, H)).astype(np.float32)),
            "row": torch.from_numpy(rng.random((R // H, H)).astype(np.float32)),
            "slice": proj[:, H:2 * H]}


def _fwd_vec_walk(os_, gs, m):
    """A PyTorch mirror of ``epilogue_fwd_vec``'s walk: ceil(R·L / 256)
    blocks of 256 threads; thread t takes row r = t // L (none past R) and
    lane t % L, reads gate k at flat offset (r // H)·gs_k + r % H of its
    storage and the mask of token r // H once, then its vectors sub, sub +
    L, ... of N = 16 / itemsize elements: (g₁o₁ + g₂o₂ + g₃o₃)·m in fp32.
    Every element of the output is written once."""
    R, D = os_[0].shape
    dtype = os_[0].dtype
    H = gs[0].shape[1]
    plan = epilogue.epilogue_plan(D, dtype)
    assert plan.path == "vec"
    L, N = plan.lanes, 16 // dtype.itemsize
    flat = [g.as_strided((g.untyped_storage().nbytes() // 4,), (1,), 0) for g in gs]
    base = [g.storage_offset() for g in gs]
    strides = [g.stride(0) if g.shape[0] > 1 else 0 for g in gs]
    out = torch.full((R, D), float("nan")).to(dtype)
    written = torch.zeros(R, D, dtype=torch.int64)
    for t in range(-(-R * L // THREADS) * THREADS):
        r, sub = t // L, t % L
        if r >= R:
            continue
        tok, h = r // H, r % H
        a = [flat[k][base[k] + tok * strides[k] + h] for k in range(3)]
        mr = 1.0 if m is None else float(m[tok])
        for c in range(sub * N, D, L * N):
            e = slice(c, c + N)
            acc = a[0] * os_[0][r, e].float() + a[1] * os_[1][r, e].float() \
                + a[2] * os_[2][r, e].float()
            out[r, e] = (acc * mr).to(dtype)
            written[r, e] += 1
    assert (written == 1).all()
    return out


@pytest.mark.parametrize("form", ["head", "row", "slice"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_epilogue_fwd_vec_walk_matches_plain_and_pallas(D, dtype, form):
    """R = 39 rows of H = 3 heads (13 tokens, a third masked): no multiple
    of a block's rows at any L; the walk equals the plain version bit for
    bit, and JAX's ``_fwd_kernel`` on the gates and mask expanded to rows
    within the tolerance."""
    R, H = 39, 3
    os_, _, _, _ = _case(R, D, dtype, 3 * D + (dtype == torch.bfloat16))
    gs = [_gate_forms(R, H, 7 + k)[form] for k in range(3)]
    m = torch.from_numpy(np.random.default_rng(D).random(R // H) > 0.3)
    got = _fwd_vec_walk(os_, gs, m)
    assert torch.equal(got, epilogue.gated_combine_fwd_plain(*os_, *gs, m))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    rows = [jnp.asarray(g.expand(R // H, H).reshape(R, 1).numpy()) for g in gs]
    jm = jnp.asarray(m[:, None].expand(R // H, H).reshape(R, 1).float().numpy())
    want = j_epi._fwd_call(*(jnp.asarray(o.float().numpy()).astype(jdt) for o in os_),
                           *rows, jm, tile=R, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **TOL[dtype])


def _layer_gates(mode, B, N, H, seed):
    """The layer's gates (``core.branches.gate_values``): scalar mode three
    (1, 1, H, 1) views of (H,) tensors, token mode three (B, N, H, 1) slices
    of one (B, N, 3H) projection; numpy leaves from a seed."""
    rng = np.random.default_rng(seed)
    if mode == "scalar":
        return [rng.standard_normal(H).astype(np.float32) for _ in range(3)]
    return [rng.standard_normal((B, N, 3 * H)).astype(np.float32)]


def _gates_from(mode, leaves, B, N, H, lib):
    if lib is torch:
        if mode == "scalar":
            return [torch.sigmoid(g)[None, None, :, None] for g in leaves]
        g = torch.sigmoid(leaves[0]).reshape(B, N, 3, H, 1)
        return [g[:, :, i] for i in range(3)]
    import jax
    if mode == "scalar":
        return [jax.nn.sigmoid(g)[None, None, :, None] for g in leaves]
    g = jax.nn.sigmoid(leaves[0]).reshape(B, N, 3, H, 1)
    return [g[:, :, i] for i in range(3)]


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "nomask"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["scalar", "token"])
def test_gated_combine_matches_jax(mode, dtype, masked):
    """``ops.gated_combine`` (the gates as the layer makes them, no (R,)
    copy) against JAX's ``ops.gated_combine`` in interpret mode: the output
    and the gradients to the three branch outputs and the gate leaves."""
    import jax

    from repro.kernels import ops as j_ops
    from repro_torch.kernels import ops

    B, N, H, D = 2, 6, 3, 16
    rng = np.random.default_rng(11 + (mode == "token") + 2 * masked)
    outs = [rng.standard_normal((B, N, H, D)).astype(np.float32) for _ in range(3)]
    leaves = _layer_gates(mode, B, N, H, 5)
    mask = rng.random((B, N)) > 0.3 if masked else None
    dout = rng.standard_normal((B, N, H, D)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def jfun(os_, gl):
        out = j_ops.gated_combine([o.astype(jdt) for o in os_],
                                  _gates_from(mode, gl, B, N, H, jnp),
                                  None if mask is None else jnp.asarray(mask), interpret=True)
        return jnp.sum(out.astype(jnp.float32) * dout)

    jout = j_ops.gated_combine([jnp.asarray(o).astype(jdt) for o in outs],
                               _gates_from(mode, [jnp.asarray(g) for g in leaves], B, N, H,
                                           jnp),
                               None if mask is None else jnp.asarray(mask), interpret=True)
    jdo, jdg = jax.grad(jfun, argnums=(0, 1))([jnp.asarray(o) for o in outs],
                                              [jnp.asarray(g) for g in leaves])
    tos = [torch.from_numpy(o).to(dtype).requires_grad_() for o in outs]
    tl = [torch.from_numpy(g).requires_grad_() for g in leaves]
    tout = ops.gated_combine(tos, _gates_from(mode, tl, B, N, H, torch),
                             None if mask is None else torch.from_numpy(mask))
    assert tout.dtype == dtype and tout.shape == (B, N, H, D)
    (tout.float() * torch.from_numpy(dout)).sum().backward()
    tol = TOL[dtype]
    np.testing.assert_allclose(tout.float().detach().numpy(), np.asarray(jout, np.float32),
                               **tol)
    for t, j in zip(tos, jdo):
        np.testing.assert_allclose(t.grad.float().numpy(), np.asarray(j, np.float32), **tol)
    for t, j in zip(tl, jdg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **tol)


def test_gated_combine_refuses_other_gate_forms():
    """A gate the kernel cannot read as it is raises: it is never copied."""
    from repro_torch.kernels import ops
    B, N, H, D = 2, 4, 2, 8
    outs = [torch.randn(B, N, H, D) for _ in range(3)]
    for bad in (torch.rand(B, 1, H, 1), torch.rand(1, N, H, 1),
                torch.rand(B, N, 2 * H, 1)[:, :, ::2]):
        with pytest.raises((ValueError, RuntimeError)):
            ops.gated_combine(outs, [bad] * 3, None)
    g = torch.rand(1, H)
    for bad in (torch.rand(B * N * H), torch.rand(1, H).double(), torch.rand(H, 2).t()):
        with pytest.raises(ValueError):
            epilogue.gated_combine_fwd(*(o.reshape(-1, D) for o in outs), bad, g, g, None)
    with pytest.raises(ValueError):
        epilogue.gated_combine_fwd(*(o.reshape(-1, D) for o in outs), g, g, g,
                                   torch.ones(B * N * H, dtype=torch.bool))
