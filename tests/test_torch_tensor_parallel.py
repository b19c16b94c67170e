"""Megatron compute over the ``model`` axis in ``runtime.Trainer(mesh=...)``
(``distributed/tensor_parallel.py``) against the JAX package and one rank.

Two ``gloo`` groups of CPU ranks, spawned together for the module
(``torch_tp_worker.main``), train the smoke configs for two steps:

* (1, 2): shapenet-bsa padded and packed, tinyllama with a loss mask (its
  one kv head cut 2-way: k and v all-gathered, the GQA group's selection
  scores summed over ``model``) and qwen2-moe (32 of the 64 padded
  experts a rank), tinyllama again with remat (the recompute re-enters
  the step's axis rules), and ``vocab_parallel_nll`` on cut logits;
* (1, 2) from the port's seed-0 weights, held to one rank: mamba2 and
  jamba (SSM and hybrid: in_proj's outputs gathered after the column
  product, the scan whole, out_proj a row product), shapenet-bsa with
  group compression on φ = "mlp" and token gates, qwen2-moe with 3
  experts (cut inside each expert), and ``lm_apply``'s gathered logits;
* (2, 2): tinyllama and qwen2-moe, shapenet-bsa with ``rules=``, and
  tinyllama saved there and resumed on (4,); (1, 4): tinyllama (a query
  head a rank against the all-gathered kv head) and shapenet-bsa with 2
  heads (the replication fallback).

Each step is held to JAX's single-device ``make_train_step`` at ``TOL``
and to the single-rank port at ``EXACT`` (loss, gradient norm,
parameters), parameters and moments equal in bits on every rank; each
rank's products use only its parts of the cut weights, and it holds only
those parts between steps.
"""

import contextlib
import pickle

import numpy as np
import pytest
import torch.multiprocessing as mp

import test_torch_dist_train as D
import torch_dist_train_worker as W
import torch_tp_worker as TP
from repro.configs import get_config as j_get_config
from repro.configs.reduce import smoke_config as j_smoke_config
from repro.models.api import model_api as j_model_api
from repro_torch.runtime import Trainer, TrainerConfig

TOL, EXACT = D.TOL, D.EXACT
WORLDS = (2, 4)
RUNS = {"1x2_padded": ("padded", 2), "1x2_packed": ("packed", 2), "1x2_dense": ("dense", 2),
        "1x2_moe": ("moe", 2), "2x2_dense": ("dense", 4), "2x2_moe": ("moe", 4),
        "2x2_rules": ("padded", 4), "1x4_dense": ("dense", 4), "1x2_remat": ("dense", 2)}
# a leaf whose gradient is 0 in exact arithmetic: φ_k's output bias under
# φ = "mlp" shifts every pooled key alike, which softmax ignores; AdamW
# normalises its rounding noise into steps of up to lr, so it is held by
# its bits across ranks only (as chip_smoke.py's ZERO_GRADS)
ZERO_GRADS = ("attn.bsa.phi_k.fc2.b",)
SPIED = [r for r in RUNS if r not in ("2x2_rules", "1x2_remat")] + [
    "1x4_fallback", "1x2_ssm", "1x2_hybrid", "1x2_mlp_phi", "1x2_moe_inner"]
# the weights each spied run must have multiplied as their parts
MUST_SPLIT = {"padded": ("attn.wq.w", "attn.wo.w", "ffn.up.w", "ffn.down.w"),
              "packed": ("attn.wq.w", "attn.wo.w", "ffn.up.w", "ffn.down.w"),
              "dense": ("attn.wq.w", "attn.wo.w", "ffn.up.w", "ffn.down.w", "lm_head.w"),
              "moe": ("attn.wq.w", "attn.wo.w", "moe.w_gate", "moe.w_down", "lm_head.w"),
              "ssm": ("mamba.in_proj.w", "mamba.out_proj.w", "lm_head.w"),
              "hybrid": ("mamba.in_proj.w", "mamba.out_proj.w", "attn.wq.w", "attn.wo.w",
                         "moe.w_gate", "ffn.up.w", "lm_head.w"),
              "mlp_phi": ("attn.wq.w", "attn.wo.w", "ffn.up.w", "ffn.down.w"),
              "moe_inner": ("attn.wq.w", "attn.wo.w", "moe.w_gate", "moe.w_up",
                            "moe.w_down", "lm_head.w")}


def _inputs() -> dict:
    data = D._inputs()
    rng = np.random.default_rng(1)
    data["dense_resume"] = D._batches("dense", rng)[W.STEPS:]
    import jax
    jcfg = D._smoke("shapenet-bsa").scaled(**TP.FALLBACK)
    data["fallback_params"] = jax.tree.map(np.asarray, j_model_api(jcfg).init(
        jax.random.PRNGKey(7)))
    data.update(nll_logits=(rng.standard_normal((2, 5, 32)) * 3).astype(np.float32),
                nll_labels=rng.integers(0, 32, (2, 5)),
                nll_mask=rng.random((2, 5)) > 0.3)
    return data


def _one_rank(api, params, batches) -> dict:
    tr = Trainer(api, TrainerConfig(**W.TRAIN), device="cpu")
    model = api.init(0, device="cpu") if params is None else W.jax_model(api, params)
    model, _ = tr.fit(iter(batches), steps=len(batches), model=model)
    return {"loss": [m["loss"] for m in tr.metrics_history],
            "grad_norm": [m["grad_norm"] for m in tr.metrics_history],
            "params": {n: W._np(p) for n, p in model.named_parameters()}}


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """(results by world size: a list of the ranks' dicts; the references;
    the inputs; the scratch directory)."""
    tmp = tmp_path_factory.mktemp("tp_ranks")
    in_path = tmp / "in.pkl"
    ctx = mp.get_context("spawn")
    procs = [(world, r, ctx.Process(target=TP.main, args=(
        r, world, str(tmp / f"group{world}"), str(in_path), str(tmp))))
        for world in WORLDS for r in range(world)]
    for *_, pr in procs:                        # they start up while the inputs are made
        pr.start()
    try:
        data = _inputs()
        (tmp / "in.part").write_bytes(pickle.dumps(data))
        (tmp / "in.part").rename(in_path)
        refs = {case: {"jax": D._jax_steps(case, data), "port": D._single_rank(case, data)}
                for case in W.ARCHS}
        refs["fallback"] = _one_rank(W.smoke_api("shapenet-bsa", **TP.FALLBACK),
                                     data["fallback_params"], data["padded_batches"])
        for case in TP.SEED_CASES:
            refs[case] = _one_rank(TP.seed_api(case), None, data[
                "padded_batches" if case == "mlp_phi" else "dense_batches"])
        for *_, pr in procs:
            pr.join(timeout=300)
    finally:
        for *_, pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join()
    results = {world: [] for world in WORLDS}
    for world, r, pr in procs:
        path = tmp / f"rank{r}_of{world}.pkl"
        res = pickle.loads(path.read_bytes()) if path.exists() else {}
        assert pr.exitcode == 0 and "error" not in res, (
            f"rank {r} of {world} exited {pr.exitcode}: {res.get('error', 'no result')}")
        results[world].append(res)
    return results, refs, data, tmp


def _bits_equal(ranks, run):
    for r in range(1, len(ranks)):
        for key in ("params", "m", "v"):
            for name, arr in ranks[0][run][key].items():
                np.testing.assert_array_equal(ranks[r][run][key][name], arr,
                                              err_msg=f"{key} {name} on rank {r}")


@pytest.mark.parametrize("run", list(RUNS))
def test_tensor_parallel_step_matches_jax_and_one_rank(tp, run):
    results, refs, _, _ = tp
    case, world = RUNS[run]
    ranks = results[world]
    got, port, jref = ranks[0][run], refs[case]["port"], refs[case]["jax"]
    np.testing.assert_allclose(got["loss"], jref["loss"], **TOL)
    np.testing.assert_allclose(got["loss"], port["loss"], rtol=EXACT, atol=EXACT)
    np.testing.assert_allclose(got["grad_norm"], port["grad_norm"], rtol=EXACT, atol=EXACT)
    want = D.params_to_jax_np(got["params"])
    for name, arr in D._flat(jref["params"]).items():
        np.testing.assert_allclose(want[name], arr, err_msg=name, **TOL)
    assert D._max_err(got["params"], port["params"]) < EXACT
    _bits_equal(ranks, run)


def _spied(tp, run):
    results, _, _, _ = tp
    world = 4 if run.startswith(("2x2", "1x4")) else 2
    return results[world], int(run.split("_")[0].split("x")[1])


@pytest.mark.parametrize("run", SPIED)
def test_rank_multiplies_only_its_parts(tp, run):
    """Every dense and expert product of a step took this rank's part of a
    weight cut over ``model`` (the shape it holds), never the whole."""
    ranks, model = _spied(tp, run)
    case = {"1x4_fallback": "padded"}.get(run) or RUNS.get(run, (run[4:],))[0]
    for res in ranks:
        got = res[run]
        split = {n for n, dims in got["tp_dims"].items() if dims}
        step_shapes = got["held"][0][1]
        for name, shapes in got["seen"].items():
            if name in split:
                assert shapes == [step_shapes[name]], (name, shapes)
                whole = got["whole"][name][0]
                assert shapes[0][got["tp_dims"][name][0]] * model == \
                    whole[got["tp_dims"][name][0]], name
        for suffix in MUST_SPLIT[case]:
            names = [n for n in split if n.endswith(suffix)]
            if run == "1x4_fallback" and suffix.startswith("attn."):
                # the heads do not divide: the layer runs whole on gathered weights
                assert names and not any(n in got["seen"] for n in names), suffix
                continue
            assert names and all(n in got["seen"] for n in names), (suffix, names)


@pytest.mark.parametrize("run", SPIED)
def test_rank_holds_only_its_parts_between_steps(tp, run):
    ranks, model = _spied(tp, run)
    for res in ranks:
        got = res[run]
        cut = sum(int(np.prod(s)) * b for n, (s, b) in got["whole"].items() if got["tp_dims"][n])
        rest = sum(int(np.prod(s)) * b for n, (s, b) in got["whole"].items()
                   if not got["tp_dims"][n])
        assert cut > rest / 4                     # the cut weights are most of the model
        for held, _ in got["held"]:
            assert held == rest + cut // model, (held, rest, cut)


def test_replication_fallback_matches_one_rank_and_warns(tp):
    results, refs, _, _ = tp
    got = results[4][0]["1x4_fallback"]
    np.testing.assert_allclose(got["loss"], refs["fallback"]["loss"], rtol=EXACT, atol=EXACT)
    np.testing.assert_allclose(got["grad_norm"], refs["fallback"]["grad_norm"], rtol=EXACT,
                               atol=EXACT)
    assert D._max_err(got["params"], refs["fallback"]["params"]) < EXACT
    assert any("'heads'" in w and "replicating" in w for w in got["warnings"]), got["warnings"]
    _bits_equal(results[4], "1x4_fallback")


@pytest.mark.parametrize("case", list(TP.SEED_CASES))
def test_split_ssm_hybrid_and_mlp_phi_match_one_rank(tp, case):
    """mamba2 (in_proj gathered after its column product, out_proj a row
    product), jamba (mamba, attention and MoE layers) and shapenet-bsa with
    group compression on φ = "mlp" and token gates (φ's cut fc1 / fc2
    gathered for the heads, the gate rows of this rank's heads) and
    qwen2-moe with 3 experts (each expert's ffn dim cut: the combine of
    partial sums) against one rank."""
    results, refs, _, _ = tp
    got, want = results[2][0][f"1x2_{case}"], refs[case]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=EXACT, atol=EXACT)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=EXACT, atol=EXACT)
    errs = {n: float(np.abs(got["params"][n] - w).max()) for n, w in want["params"].items()
            if not n.endswith(ZERO_GRADS)}
    worst = max(errs, key=errs.get)
    assert errs[worst] < EXACT, (worst, errs[worst])
    _bits_equal(results[2], f"1x2_{case}")


def test_lm_apply_gathers_the_vocabulary_slices(tp):
    for res in tp[0][2]:
        np.testing.assert_allclose(res["forward"]["split"], res["forward"]["whole"],
                                   rtol=EXACT, atol=EXACT)


def test_vocab_parallel_nll_on_cut_logits(tp):
    results, _, data, _ = tp
    logits, labels, mask = data["nll_logits"], data["nll_labels"], data["nll_mask"]
    lse = np.log(np.exp(logits.astype(np.float64)).sum(-1))
    want = lse - np.take_along_axis(logits, labels[..., None], -1)[..., 0]
    loss = (want * mask).sum() / mask.sum()
    grads = []
    for res in results[2]:
        got = res["nll"]
        np.testing.assert_allclose(got["nll"], want, rtol=EXACT, atol=EXACT)
        np.testing.assert_allclose(got["whole"], want, rtol=EXACT, atol=EXACT)
        np.testing.assert_allclose(got["loss"], loss, rtol=EXACT, atol=EXACT)
        grads.append(got["grad"])
    # d loss / d logits: softmax − one-hot over the masked positions, each
    # rank's slice only on its own columns
    p = np.exp(logits - lse[..., None])
    p[np.arange(2)[:, None], np.arange(5)[None], labels] -= 1
    want_g = p * mask[..., None] / mask.sum()
    np.testing.assert_allclose(grads[0] + grads[1], want_g, rtol=1e-5, atol=1e-6)
    assert not grads[0][..., 16:].any() and not grads[1][..., :16].any()


def test_resume_on_another_mesh_after_tensor_parallel_steps(tp):
    results, _, data, tmp = tp
    got = results[4][0]["resume"]
    assert got["step0"] == W.STEPS - 1
    api = W.smoke_api("tinyllama-1.1b")
    tr = Trainer(api, TrainerConfig(**W.TRAIN, ckpt_dir=str(tmp / "ckpt")), device="cpu")
    model, opt = tr.init_state()
    model, opt, step0 = tr.maybe_restore(model, opt)
    with contextlib.redirect_stdout(None):
        model, _ = tr.fit(iter(data["dense_resume"]), steps=1, model=model, opt_state=opt,
                          start_step=step0)
    np.testing.assert_allclose(got["loss"], [m["loss"] for m in tr.metrics_history],
                               rtol=EXACT, atol=EXACT)
    assert D._max_err(got["params"], {n: W._np(p) for n, p in model.named_parameters()}) \
        < EXACT
    for res in results[4][1:]:
        for name, arr in got["params"].items():
            np.testing.assert_array_equal(res["resume"]["params"][name], arr)


def test_fallback_config_is_the_jax_smoke_config():
    """The fallback run's config: JAX's smoke shapenet-bsa with 2 heads,
    whose wq (32 outputs) divides a 4-way axis and whose heads do not."""
    jcfg = j_smoke_config(j_get_config("shapenet-bsa")).scaled(**TP.FALLBACK)
    assert jcfg.n_heads * jcfg.resolved_head_dim % 4 == 0 and jcfg.n_heads % 4
    assert W.smoke_api("shapenet-bsa", **TP.FALLBACK).mcfg.n_heads == 2
