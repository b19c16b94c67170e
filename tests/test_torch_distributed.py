"""The port's distributed attention layer (``repro_torch.distributed``,
``repro_torch.launch.mesh``) against the JAX package.

Pure logic (the ring permutation, the hop-live tables, the LPT planner and
its cache, the axis re-layout, ``logical_to_spec``'s warn-once guard,
``offsets_digest``) is held equal to JAX's directly.  The sharded ops run
in one ``gloo`` group of 4 CPU processes, spawned once for the module
(``torch_dist_worker.main``), with the ``reference`` inner backend; each
case is held to the JAX package's unsharded ``jnp`` result on the same
numpy inputs and weights at fp32 1e-5 (the shapes of
``tests/test_distributed.py``'s 8-device cases), forward and gradients, and
the gradients must be equal in bits on every rank and over two calls.
"""

import dataclasses
import pickle
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dist_worker as W
from repro.configs import get_config as j_get_config
from repro.configs.reduce import smoke_config as j_smoke_config
from repro.core import BSAConfig as JBSAConfig
from repro.core.backend import get_backend as j_get_backend
from repro.core.bsa import bsa_attention as j_bsa, bsa_attention_varlen as j_bsa_varlen
from repro.core.bsa import bsa_init as j_bsa_init
from repro.core.nsa_causal import nsa_causal_attention as j_nsa, nsa_init as j_nsa_init
from repro.distributed import ring as j_ring
from repro.distributed.sharding import logical_to_spec as j_logical_to_spec
from repro.kernels import occupancy as j_occ
from repro.models.api import model_api as j_model_api
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.distributed import ring, sharding
from repro_torch.kernels import occupancy

WORLD = 4
TOL = 1e-5


# ---------------------------------------------------------------------------
# pure logic, held equal to JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_ring_perm_matches_jax(p):
    assert ring.ring_perm(p) == j_ring.ring_perm(p)


def test_ring_hop_live_matches_jax():
    live = occupancy.ring_hop_live(4, 32, causal=True)
    assert live.sum() == 10                          # p(p+1)/2 of p² hops
    for kw in (dict(causal=True), dict(), dict(block_causal=True, ell=8),
               dict(block_causal=True, ell=64)):
        for p, n in ((4, 32), (3, 128), (8, 16)):
            np.testing.assert_array_equal(occupancy.ring_hop_live(p, n, **kw),
                                          j_occ.ring_hop_live(p, n, **kw))
    np.testing.assert_array_equal(occupancy.causal_tile_live(6, 5, 64, 8, block_causal=True,
                                                             ell=8),
                                  j_occ.causal_tile_live(6, 5, 64, 8, block_causal=True,
                                                         ell=8))


def test_partitions_match_jax_and_lpt_beats_round_robin_on_skew():
    sizes = (512, 64, 64, 64, 64, 64, 64, 64, 64, 64)
    offs = tuple(np.cumsum((0,) + sizes).tolist())
    for p in (2, 3, 4):
        assert ring.lpt_partition(sizes, p) == j_ring.lpt_partition(sizes, p)
        assert ring.round_robin_partition(sizes, p) == j_ring.round_robin_partition(sizes, p)
    lpt = ring.plan_segments(offs, 4)
    rr = ring.plan_segments(offs, 4, partition=ring.round_robin_partition)
    assert lpt.cost_balance < rr.cost_balance
    assert all(a != lpt.assign[0] for a in lpt.assign[1:])      # the giant sits alone
    jl = j_ring.plan_segments(offs, 4)
    assert (lpt.assign, lpt.loads, lpt.cost_balance) == (jl.assign, jl.loads,
                                                          jl.cost_balance)


def test_plan_segments_is_cached():
    assert ring.plan_segments((0, 128, 256), 2) is ring.plan_segments((0, 128, 256), 2)


@pytest.mark.parametrize("offs,total,pad_to", [((0, 256, 320, 448, 512), 512, 64),
                                               ((0, 64, 64, 320, 448), 512, 32),
                                               ((0, 24, 56, 64), 64, 8)])
def test_axis_layout_split_merge_match_jax(offs, total, pad_to):
    for p in (2, 3, 4):
        plan = ring.plan_segments(offs, p)
        got = ring.axis_layout(plan, offs, total, pad_to)
        want = j_ring.axis_layout(j_ring.plan_segments(offs, p), offs, total, pad_to)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        idx = got[0]
        arr = np.random.default_rng(p).standard_normal((total, 3)).astype(np.float32)
        split = ring.split_tokens(idx, torch.from_numpy(arr), p)
        np.testing.assert_array_equal(split.numpy(),
                                      np.asarray(j_ring.split_tokens(idx, jnp.asarray(arr), p)))
        merged = ring.merge_tokens(idx, split, total)
        np.testing.assert_array_equal(merged.numpy(),
                                      np.asarray(j_ring.merge_tokens(idx, jnp.asarray(
                                          split.numpy()), total)))


def test_logical_to_spec_matches_jax_and_warns_once():
    class FakeMesh:
        shape = {"data": 16, "model": 16}
    rules = {"heads": ("model",), "batch": ("data",), "d_model": None}
    for shape in ((256, 4096, 64), (256, 4096, 56)):
        got = sharding.logical_to_spec(("batch", "seq", "heads"), shape, FakeMesh, rules)
        assert got == tuple(j_logical_to_spec(("batch", "seq", "heads"), shape, FakeMesh,
                                              rules))

    class Twelve:
        shape = {"model": 12}
    sharding.reset_replication_warnings()
    with pytest.warns(RuntimeWarning, match="'heads'.*50.*model.*12"):
        assert sharding.logical_to_spec(("heads",), (50,), Twelve, rules) == (None,)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert sharding.logical_to_spec(("heads",), (50,), Twelve, rules) == (None,)

    class Four:
        shape = {"model": 4}
    with warnings.catch_warnings():
        warnings.simplefilter("error")               # a used axis: silent
        assert sharding.logical_to_spec(("heads", "d_ff"), (8, 64), Four,
                                        {"heads": ("model",), "d_ff": ("model",)}) == (
            "model", None)
    x = torch.zeros(2, 3)
    assert sharding.constrain(x, "batch", "seq") is x
    with sharding.axis_rules(Four):
        with pytest.raises(ValueError, match="axes for rank-2"):
            sharding.constrain(x, "batch")


def test_offsets_digest_matches_jax():
    for offs in ([0, 256, 448, 512], np.array([0, 64, 64, 128], np.int32)):
        want = j_occ.offsets_digest(np.asarray(offs))
        assert occupancy.offsets_digest(offs) == want
        assert occupancy.offsets_digest(torch.as_tensor(np.asarray(offs))) == want


def test_warn_once_keys_on_op_and_cause():
    from repro_torch.distributed.sharded_backend import _warn_once, reset_warnings
    reset_warnings()
    with pytest.warns(RuntimeWarning, match="indivisible-dim"):
        _warn_once("flash", "indivisible-dim", "seq 100 % 8 != 0")
    with pytest.warns(RuntimeWarning, match="causal-qk-mismatch"):
        _warn_once("flash", "causal-qk-mismatch", "N=1 != L=64")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _warn_once("flash", "indivisible-dim", "seq 204 % 8 != 0")
    reset_warnings()


def test_sharded_backend_registered_and_needs_a_mesh():
    from repro_torch.core import BSAConfig, bsa_attention, get_backend, use_backend
    from repro_torch.core.bsa import bsa_init
    bk = get_backend("sharded")
    assert bk.name == "sharded" and bk.requires_mesh and bk.is_sharded_backend
    cfg = BSAConfig(ball_size=32, local_window=32, cmp_block=8, top_k=2, group_size=8)
    p = bsa_init(cfg, n_heads=4, n_kv_heads=2, head_dim=8, d_model=32,
                 generator=torch.Generator().manual_seed(0))
    q, k, v = torch.randn(2, 128, 4, 8), torch.randn(2, 128, 2, 8), torch.randn(2, 128, 2, 8)
    with use_backend("sharded"), pytest.raises(RuntimeError, match="mesh_context"):
        bsa_attention(p, q, k, v, cfg=cfg)


def test_meshes_need_an_initialised_group():
    from repro_torch.launch.mesh import make_local_mesh, make_mesh
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_local_mesh()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh((2, 2), ("data", "model"))


def test_engines_fail_fast_without_mesh():
    from repro_torch.serving.engine import GeometryEngine, ServingEngine

    class _API:                              # the check runs before anything else
        class mcfg:
            class bsa:
                backend = None
    with pytest.raises(ValueError, match="mesh_context"):
        ServingEngine(_API, None, batch_slots=1, max_len=64, backend="sharded")
    with pytest.raises(ValueError, match="mesh_context"):
        GeometryEngine(_API, None, backend="sharded")


# ---------------------------------------------------------------------------
# the sharded ops on 4 CPU ranks, held to JAX's unsharded results
# ---------------------------------------------------------------------------

def _inputs():
    s, r, c = W.SHAPES, W.RING, W.VARLEN
    jcfg = JBSAConfig(**W.CFG, backend="jnp")
    ks = jax.random.split(jax.random.PRNGKey(0), 6)
    bp = j_bsa_init(ks[0], jcfg, n_heads=s["HQ"], n_kv_heads=s["HKV"], head_dim=s["D"],
                    d_model=s["HQ"] * s["D"])
    npar = j_nsa_init(ks[4], jcfg, n_heads=s["HQ"], n_kv_heads=s["HKV"], head_dim=s["D"],
                      d_model=s["HQ"] * s["D"])
    rng = np.random.default_rng(0)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    B, N = s["B"], s["N"]
    d = {"bparams": jax.tree.map(np.asarray, bp), "nparams": jax.tree.map(np.asarray, npar),
         "q": normal(B, N, s["HQ"], s["D"]), "k": normal(B, N, s["HKV"], s["D"]),
         "v": normal(B, N, s["HKV"], s["D"]),
         "mask": np.arange(N)[None, :] < np.array([N, 320])[:, None]}
    B, N = r["B"], r["N"]
    nb, G = N // r["ELL"], N // r["G"]
    d.update(ring_q=normal(B, N, r["HQ"], r["D"]), ring_k=normal(B, N, r["HKV"], r["D"]),
             ring_v=normal(B, N, r["HKV"], r["D"]), ring_mask=rng.random((B, N)) > 0.2,
             ring_ti=rng.integers(0, nb, size=(B, G, r["HKV"], r["KSTAR"])),
             ring_sv=rng.random((B, G, r["HKV"], r["KSTAR"])) > 0.25,
             ring_w=normal(B, N, r["HQ"], r["D"]))
    T, offs = c["T"], np.asarray(c["OFFSETS"])
    Gv = T // c["G"]
    so = np.searchsorted(offs[1:], np.arange(Gv) * c["G"], "right")
    lo = offs[so] // c["ELL"]
    span = np.maximum(offs[so + 1] // c["ELL"] - lo, 1)
    d.update(vl_q=normal(T, c["HQ"], c["D"]), vl_k=normal(T, c["HKV"], c["D"]),
             vl_v=normal(T, c["HKV"], c["D"]), vl_m=rng.random(T) > 0.1,
             vl_kc=normal(T // c["ELL"], c["HKV"], c["D"]),
             vl_vc=normal(T // c["ELL"], c["HKV"], c["D"]),
             vl_blkv=rng.random(T // c["ELL"]) > 0.1,
             vl_ti=lo[:, None, None] + rng.integers(0, 1000, size=(Gv, c["HKV"], c["KSTAR"]))
             % span[:, None, None],
             vl_sv=rng.random((Gv, c["HKV"], c["KSTAR"])) > 0.25)
    jlm = _jax_lm()
    d["lm_params"] = jax.tree.map(np.asarray, jlm[1])
    prng = np.random.default_rng(0)
    prompts = [prng.integers(0, 512, n, dtype=np.int32) for n in (40, 70, 20)]
    # a fourth request repeats the second's first 64 tokens: prefix reuse
    # and copy-on-write of a shared page on the row-partitioned pools
    prompts.append(np.concatenate([prompts[1][:64], prng.integers(0, 512, 9, np.int32)]))
    d["prompts"] = prompts
    return d


def _jax_lm():
    jcfg = j_smoke_config(j_get_config("tinyllama-1.1b")).scaled(n_layers=1)
    jcfg = jcfg.scaled(bsa=dataclasses.replace(jcfg.bsa, backend="jnp"))
    japi = j_model_api(jcfg)
    return japi, japi.init(jax.random.PRNGKey(0))


def _jax_refs(data) -> dict:
    """The JAX package's unsharded results of every case (jitted), computed
    while the ranks run."""
    refs = {}
    jcfg = JBSAConfig(**W.CFG, backend="jnp")
    q, k, v = (jnp.asarray(data[x]) for x in ("q", "k", "v"))
    mask = jnp.asarray(data["mask"])
    for name, fn, tree in (("bsa", j_bsa, data["bparams"]), ("nsa", j_nsa, data["nparams"])):
        params = jax.tree.map(jnp.asarray, tree)
        for tag, m in (("dense", None), ("ragged", mask)):
            def loss(p, q, k, v, fn=fn, m=m):
                o = fn(p, q, k, v, cfg=jcfg, mask=m)
                return (o ** 2).sum() / W.SHAPES["N"], o
            (_, o), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                                       has_aux=True))(params, q, k, v)
            refs[f"{name}_{tag}"] = {"out": np.asarray(o), "dq": grads[1], "dk": grads[2],
                                     "dv": grads[3], **{f"p/{n}": a for n, a in
                                                        _flat_jax(grads[0]).items()}}
    bparams = jax.tree.map(jnp.asarray, data["bparams"])
    refs["bsa_varlen"] = {"out": jax.jit(lambda q, k, v: j_bsa_varlen(
        bparams, q, k, v, cfg=jcfg, offsets=jnp.asarray(W.PACKED_OFFSETS, jnp.int32)))(
        q[0], k[0], v[0])}
    refs["passthrough"] = {"out": jax.jit(lambda q, k, v: j_bsa(
        bparams, q, k, v, cfg=jcfg, mask=mask))(q, k, v)}
    jb = j_get_backend("jnp")
    refs["fallback"] = {"out": jb.ball(q[:, :192], k[:, :192], v[:, :192], None,
                                       ball_size=64)}

    r = W.RING
    rq, rk, rv = (jnp.asarray(data[f"ring_{x}"]) for x in ("q", "k", "v"))
    rmask, w = jnp.asarray(data["ring_mask"]), jnp.asarray(data["ring_w"])
    ti, sv = jnp.asarray(data["ring_ti"], jnp.int32), jnp.asarray(data["ring_sv"])
    ti_skewed = ti % (r["N"] // r["ELL"] // WORLD)
    ring_fns = {
        "ring_flash_True": lambda q, k, v: jb.flash(q, k, v, key_valid=rmask, causal=True),
        "ring_flash_False": lambda q, k, v: jb.flash(q, k, v, key_valid=rmask),
        "ring_selection": lambda q, k, v: jb.selection(q, k, v, ti, sv, rmask,
                                                       block_size=r["ELL"],
                                                       group_size=r["G"]),
        "ring_selection_skewed": lambda q, k, v: jb.selection(
            q, k, v, ti_skewed, sv, rmask, block_size=r["ELL"], group_size=r["G"]),
    }
    for key, f in ring_fns.items():
        (_, o), g = jax.jit(jax.value_and_grad(
            lambda q, k, v, f=f: ((f(q, k, v) * w).sum(), f(q, k, v)),
            argnums=(0, 1, 2), has_aux=True))(rq, rk, rv)
        refs[key] = {"out": o, "dq": g[0], "dk": g[1], "dv": g[2]}

    c = W.VARLEN
    offsets = jnp.asarray(c["OFFSETS"], jnp.int32)
    vq, vk, vv, vm, kc, vc, blkv, vsv = (jnp.asarray(data[f"vl_{x}"]) for x in
                                         ("q", "k", "v", "m", "kc", "vc", "blkv", "sv"))
    vti = jnp.asarray(data["vl_ti"], jnp.int32)
    varlen = {
        "ball": lambda q: jb.ball_varlen(q, vk, vv, offsets, vm, ball_size=c["BALL"]),
        "flash": lambda q: jb.flash_varlen(q, kc, vc, offsets, offsets // c["ELL"],
                                           key_valid=blkv),
        "window": lambda q: jb.local_window_varlen(q, vk, vv, offsets, window=c["WINDOW"],
                                                   mask=vm),
        "sel": lambda q: jb.selection_varlen(q, vk, vv, vti, vsv, offsets, vm,
                                             block_size=c["ELL"], group_size=c["G"]),
    }
    for op, f in varlen.items():
        refs[f"varlen_{op}"] = {"out": f(vq)}
    refs["varlen_ball"]["dq"] = jax.grad(lambda q: (varlen["ball"](q) ** 2).sum())(vq)

    japi, jp = _jax_lm()
    refs["serve"] = JServingEngine(japi, jp, batch_slots=W.SERVE["slots"],
                                   max_len=W.SERVE["max_len"], paged=True,
                                   backend="jnp").serve(data["prompts"],
                                                        max_new_tokens=W.SERVE["new_tokens"])
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the 4 ranks' results, a dict per rank; the JAX references)."""
    tmp = tmp_path_factory.mktemp("ranks")
    data = _inputs()
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(data, f)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=W.main, args=(r, WORLD, str(tmp / "group"),
                                              str(tmp / "in.pkl"), str(tmp)))
             for r in range(WORLD)]
    for pr in procs:
        pr.start()
    try:
        refs = _jax_refs(data)
        for pr in procs:
            pr.join(timeout=300)
    finally:
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join()
    results = []
    for r, pr in enumerate(procs):
        path = tmp / f"rank{r}.pkl"
        res = pickle.loads(path.read_bytes()) if path.exists() else {}
        assert pr.exitcode == 0 and "error" not in res, (
            f"rank {r} exited {pr.exitcode}: {res.get('error', 'no result')}")
        results.append(res)
    return results, refs


def _close(got, want, what, tol=TOL):
    err = float(np.max(np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))))
    assert err < tol, f"{what}: max abs error {err} ≥ {tol}"


def _flat_jax(tree):
    return W._flat(jax.tree.map(np.asarray, tree))


def _hold(got, want, what, tol=TOL):
    for key, arr in want.items():
        _close(got[key], arr, f"{what} {key}", tol)


def _same_on_every_rank(res, case, keys=None):
    for r in range(1, WORLD):
        for key, arr in res[0][case].items():
            if keys is None or key in keys:
                np.testing.assert_array_equal(res[r][case][key], arr,
                                              err_msg=f"{case} {key}: rank {r} vs rank 0")


@pytest.mark.parametrize("case", ["bsa_dense", "bsa_ragged", "nsa_dense", "nsa_ragged"])
def test_sharded_attention_matches_jax_with_grads(ranks, case):
    res, refs = ranks
    assert res[0][case]["falls_back"] == 0
    _hold(res[0][case], refs[case], case)
    _same_on_every_rank(res, case)


@pytest.mark.parametrize("case", ["bsa_dense", "nsa_dense"])
def test_sharded_gradients_repeat_bit_for_bit(ranks, case):
    res, _ = ranks
    for r in range(WORLD):
        for key, arr in res[r][case].items():
            np.testing.assert_array_equal(res[r][case + "_again"][key], arr,
                                          err_msg=f"{case} {key} on rank {r}")


def test_sharded_packed_bsa_matches_jax(ranks):
    res, refs = ranks
    assert res[0]["bsa_varlen"]["falls_back"] == 0
    _hold(res[0]["bsa_varlen"], refs["bsa_varlen"], "bsa_attention_varlen")


def test_axis_of_one_rank_passes_through(ranks):
    res, refs = ranks
    got = res[0]["passthrough"]
    assert got["mesh_shape"] == {"data": 1, "model": WORLD}
    np.testing.assert_array_equal(got["out"], got["reference"])
    _hold(got, refs["passthrough"], "p = 1 pass-through")


def test_indivisible_shape_warns_once_and_keeps_the_numbers(ranks):
    res, refs = ranks
    assert res[0]["fallback"]["counts"] == [1, 0]
    _hold(res[0]["fallback"], refs["fallback"], "fallback ball", tol=1e-6)


@pytest.mark.parametrize("case", ["ring_flash_True", "ring_flash_False", "ring_selection",
                                  "ring_selection_skewed"])
def test_ring_ops_match_jax_with_grads(ranks, case):
    res, refs = ranks
    if case.startswith("ring_flash"):
        causal = case.endswith("True")
        assert res[0][case]["live"] == (WORLD * (WORLD + 1) // 2 if causal else WORLD * WORLD)
    _hold(res[0][case], refs[case], case)
    _same_on_every_rank(res, case, ("dq", "dk", "dv"))


@pytest.mark.parametrize("op", ["ball", "flash", "window", "sel"])
def test_segment_sharded_varlen_matches_jax(ranks, op):
    res, refs = ranks
    assert res[0]["varlen_falls_back"] == 0
    _hold(res[0][f"varlen_{op}"], refs[f"varlen_{op}"], f"{op}_varlen")


def test_sharded_paged_serving_matches_jax_engine(ranks):
    res, refs = ranks
    for r in range(WORLD):
        got = res[r]["serve"]
        assert ((got["num_blocks"] + 1) * got["page"]) % WORLD == 0
        assert got["pool_rows"] * WORLD == (got["num_blocks"] + 1) * got["page"]
        for key in ("unsharded", "sharded_ring1", "sharded_ring0"):
            for i, want in enumerate(refs["serve"]):
                np.testing.assert_array_equal(got[key][i], want, err_msg=f"{key} request {i}")


def test_collectives_move_every_dtype(ranks):
    res, _ = ranks
    for r in range(WORLD):
        for dt, (gathered, rotated, _) in res[r]["comm_dtypes"].items():
            want = [(np.arange(6).reshape(2, 3) + 10 * s) for s in range(WORLD)]
            if dt == "torch.bool":
                want = [w.astype(bool) for w in want]
            for g, w in zip(gathered, want):
                np.testing.assert_array_equal(g, np.asarray(w, np.float32), err_msg=dt)
            left = np.zeros((2, 3)) if r == 0 else want[r - 1]   # rank 0 gets zeros
            np.testing.assert_array_equal(rotated, np.asarray(left, np.float32), err_msg=dt)


def test_local_mesh_must_span_the_group(ranks):
    res, _ = ranks
    assert "group has 4 rank(s)" in res[0]["mesh_error"]


def test_quickstart_section_7_on_two_ranks(tmp_path):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=W.quickstart, args=(r, str(tmp_path / "group"), str(tmp_path)))
             for r in range(2)]
    for pr in procs:
        pr.start()
    for pr in procs:
        pr.join(timeout=300)
        if pr.is_alive():
            pr.kill()
            pr.join()
    for r, pr in enumerate(procs):
        assert pr.exitcode == 0, f"rank {r} exited {pr.exitcode}"
        assert "sharded over 2 ranks == single-device: OK" in (
            tmp_path / f"quickstart{r}.txt").read_text()
