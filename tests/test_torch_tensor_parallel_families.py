"""Megatron compute over the ``model`` axis for the VLM, encoder-decoder,
SSM and hybrid families in ``runtime.Trainer(mesh=...)`` against the JAX
package and one rank.

Two ``gloo`` groups of CPU ranks, spawned together for the module
(``torch_tp_families_worker.main``), train the smoke configs for two
steps while the parent makes the references:

* (1, 2): llava-next (the projector's fc1 a column and fc2 a row product
  with fc1's whole bias narrowed to the rank's columns, 2 of 4 query
  heads a rank on the gathered kv head, the vocabulary-parallel text
  embedding and loss on the text positions) and seamless-m4t (with a frame
  mask and a loss mask: ``frontend_proj`` a column product gathered into
  the residual stream, the encoder's non-causal BSA, the decoder's causal
  BSA and its cross-attention on the rank's heads, ``tok_embed`` and
  ``lm_head`` vocabulary-parallel), both held to JAX's single-device
  ``make_train_step`` at ``TOL`` and to the one-rank port at ``EXACT``;
  mamba2 and jamba from the port's seed-0 weights, the scan on the rank's
  4 of 8 heads, held to one rank;
* (1, 4): seamless with a vocabulary of 510 (whole ``tok_embed`` and
  ``lm_head``, JAX's fallback and its warning; the layers split) and
  llava (one query head a rank), against JAX and one rank.

Every run holds parameters and moments equal in bits on every rank; each
rank's products take only its parts of the cut weights, its scans only
its heads, and it holds only those parts between steps.  Two unit checks
on 2 ranks: a column-cut ``Dense`` with a whole bias, and the gated norm's
sum of squares summed over ``model`` in both directions; and a step in
which one rank rounds the gradient of a weight every rank holds whole
otherwise (as a GPU reduction did on the card), after which the ranks
still hold the same bits.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

import test_torch_dist_train as D
import torch_dist_train_worker as W
import torch_tp_families_worker as F
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models.api import model_api as j_model_api
from repro.optim import adamw as j_adamw
from repro_torch.runtime import Trainer, TrainerConfig

TOL, EXACT = D.TOL, D.EXACT
WORLDS = (2, 4)
FAMILY = {"1x2_vlm": "vlm", "1x2_encdec": "encdec", "1x2_ssm": "ssm", "1x2_hybrid": "hybrid",
          "1x4_vlm": "vlm", "1x4_encdec_vocab": "encdec_vocab"}
JAX_RUNS = [r for r, (*_, from_jax) in F.RUNS.items() if from_jax]
SEED_RUNS = [r for r, (*_, from_jax) in F.RUNS.items() if not from_jax]
# the weights each run must have multiplied as their parts
MUST_SPLIT = {"vlm": ("projector.fc1.w", "projector.fc2.w", "attn.wq.w", "attn.wk.w",
                      "attn.wo.w", "ffn.up.w", "ffn.down.w", "lm_head.w"),
              "encdec": ("frontend_proj.w", ".attn.wq.w", ".attn.wo.w", "self_attn.wq.w",
                         "self_attn.wo.w", "cross_attn.wq.w", "cross_attn.wk.w",
                         "cross_attn.wv.w", "cross_attn.wo.w", "ffn.up.w", "ffn.down.w",
                         "lm_head.w"),
              "ssm": ("mamba.in_proj.w", "mamba.out_proj.w", "lm_head.w"),
              "hybrid": ("mamba.in_proj.w", "mamba.out_proj.w", "attn.wq.w", "attn.wo.w",
                         "moe.w_gate", "ffn.up.w", "lm_head.w")}
MUST_SPLIT["encdec_vocab"] = MUST_SPLIT["encdec"][:-1]
SEAMLESS_N, VLM_N = 128, 96                    # frames; image + text tokens
# a gradient against one rank's: within GRAD_REL of its largest value,
# floored at GRAD_FLOOR of the step's largest (φ_k.pos's is 0 in exact
# arithmetic); the scan's A_log and dt_bias at the family tests' fp32
# tolerance: one rank's own fp32 gradients of them lie up to 1.6e-4 and
# 2.4e-5 of their largest from a float64 evaluation of the same smoke
# step (``tools/mamba_fp64_grads.py``: sums over positions with heavy
# cancellation), so two fp32 orders of the sums differ by as much
GRAD_REL, GRAD_FLOOR = 1e-4, 1e-4
ILL_CONDITIONED = {("mamba.A_log", "mamba.dt_bias"): 1e-3}


def _jcfg(run):
    arch, scaled, *_ = F.RUNS[run]
    return D._smoke(arch).scaled(**scaled)


def _inputs() -> dict:
    rng = np.random.default_rng(5)
    data = {}
    for key, run in (("vlm", "1x2_vlm"), ("encdec", "1x2_encdec"),
                     ("encdec_vocab", F.VOCAB_RUN)):
        jcfg = _jcfg(run)
        data[f"{key}_params"] = jax.tree.map(np.asarray, j_model_api(jcfg).init(
            jax.random.PRNGKey(len(data))))
        batches = []
        for _ in range(W.STEPS):
            if key == "vlm":
                si = jcfg.vision_tokens
                toks = rng.integers(0, jcfg.vocab_size, (2, VLM_N - si), dtype=np.int32)
                batches.append({"tokens": toks, "labels": toks, "patch_embeds": rng.standard_normal(
                    (2, si, jcfg.d_frontend), dtype=np.float32)})
                continue
            sd = max(SEAMLESS_N // jcfg.dec_ratio, 16)
            toks = rng.integers(0, jcfg.vocab_size, (2, sd), dtype=np.int32)
            batches.append({"frames": rng.standard_normal((2, SEAMLESS_N, jcfg.d_frontend),
                                                          dtype=np.float32),
                            "dec_tokens": toks, "labels": toks,
                            "frame_mask": np.arange(SEAMLESS_N)[None] < np.array([[128], [80]]),
                            "loss_mask": rng.random((2, sd)) > 0.3})
        data[f"{key}_batches"] = batches
    data["lm_batches"] = D._batches("dense", rng)[:W.STEPS]
    data.update(bias_x=rng.standard_normal((3, 5, 8), dtype=np.float32),
                bias_gy=rng.standard_normal((3, 5, 6), dtype=np.float32),
                bias_b=rng.standard_normal(6, dtype=np.float32))
    data.update(norm_y=rng.standard_normal((2, 4, 128), dtype=np.float32),
                norm_z=rng.standard_normal((2, 4, 128), dtype=np.float32),
                norm_g=(1 + 0.1 * rng.standard_normal(128)).astype(np.float32),
                norm_gy=rng.standard_normal((2, 4, 128), dtype=np.float32))
    return data


def _jax_steps(jcfg, params, batches) -> dict:
    kw = {k: v for k, v in W.TRAIN.items() if k != "log_every"}
    step = jax.jit(j_make_train_step(j_model_api(jcfg), **kw))
    params = jax.tree.map(jnp.asarray, params)
    state = j_adamw.adamw_init(params)
    losses = []
    for b in batches:
        params, state, out = step(params, state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(out["loss"]))
    return {"loss": losses, "params": jax.tree.map(np.asarray, params)}


def _one_rank(run, data) -> dict:
    """The run on one rank: losses, gradient norms, each step's (clipped)
    gradients and the parameters after the steps."""
    *_, key, from_jax = F.RUNS[run]
    api = F.api_of(run)
    tr = Trainer(api, TrainerConfig(**W.TRAIN), device="cpu")
    model = W.jax_model(api, data[f"{key}_params"]) if from_jax else api.init(0, device="cpu")
    grads, step = [], tr._step

    def keep(model, opt_state, batch):
        res = step(model, opt_state, batch)
        grads.append({n: W._np(p.grad) for n, p in model.named_parameters()
                      if p.grad is not None})
        return res
    tr._step = keep
    model, _ = tr.fit(iter(data[f"{key}_batches"]), steps=W.STEPS, model=model)
    return {"loss": [m["loss"] for m in tr.metrics_history],
            "grad_norm": [m["grad_norm"] for m in tr.metrics_history], "grads": grads,
            "params": {n: W._np(p) for n, p in model.named_parameters()}}


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """(results by world size: a list of the ranks' dicts; the references
    by run)."""
    tmp = tmp_path_factory.mktemp("tp_family_ranks")
    in_path = tmp / "in.pkl"
    ctx = mp.get_context("spawn")
    procs = [(world, r, ctx.Process(target=F.main, args=(
        r, world, str(tmp / f"group{world}"), str(in_path), str(tmp))))
        for world in WORLDS for r in range(world)]
    for *_, pr in procs:                        # they start up while the inputs are made
        pr.start()
    try:
        data = _inputs()
        (tmp / "in.part").write_bytes(pickle.dumps(data))
        (tmp / "in.part").rename(in_path)
        refs = {run: {"port": _one_rank(run, data)} for run in F.RUNS if run.startswith("1x2")}
        refs["1x4_vlm"] = refs["1x2_vlm"]
        refs[F.VOCAB_RUN] = {"port": _one_rank(F.VOCAB_RUN, data)}
        for run in ("1x2_vlm", "1x2_encdec", F.VOCAB_RUN):
            key = F.RUNS[run][3]
            refs[run]["jax"] = _jax_steps(_jcfg(run), data[f"{key}_params"],
                                          data[f"{key}_batches"])
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
    return results, refs


def _ranks(tp, run):
    return tp[0][F.RUNS[run][2]]


def _bits_equal(ranks, run):
    for r in range(1, len(ranks)):
        for key in ("params", "m", "v"):
            for name, arr in ranks[0][run][key].items():
                np.testing.assert_array_equal(ranks[r][run][key][name], arr,
                                              err_msg=f"{key} {name} on rank {r}")


@pytest.mark.parametrize("run", JAX_RUNS)
def test_split_family_step_matches_jax_and_one_rank(tp, run):
    ranks = _ranks(tp, run)
    got, port, jref = ranks[0][run], tp[1][run]["port"], tp[1][run]["jax"]
    np.testing.assert_allclose(got["loss"], jref["loss"], **TOL)
    np.testing.assert_allclose(got["loss"], port["loss"], rtol=EXACT, atol=EXACT)
    np.testing.assert_allclose(got["grad_norm"], port["grad_norm"], rtol=EXACT, atol=EXACT)
    want = D.params_to_jax_np(got["params"])
    for name, arr in D._flat(jref["params"]).items():
        np.testing.assert_allclose(want[name], arr, err_msg=name, **TOL)
    assert D._max_err(got["params"], port["params"]) < EXACT
    _bits_equal(ranks, run)


@pytest.mark.parametrize("run", SEED_RUNS)
def test_split_scan_matches_one_rank(tp, run):
    """mamba2 and jamba with each rank's scan on its own heads (the gated
    norm's statistic summed over ``model``) against one rank: the losses
    and gradient norms at ``EXACT``, every gradient of each step within
    ``GRAD_REL`` (``ILL_CONDITIONED``'s at theirs).  The parameters after
    the steps are held by their bits across ranks: AdamW normalises each
    entry's gradient, so an entry whose gradient is rounding noise
    (jamba's embedding rows at 1e-5 of the table's largest gradient,
    summed in another order on 2 ranks) steps by up to lr on either
    side."""
    ranks = _ranks(tp, run)
    got, want = ranks[0][run], tp[1][run]["port"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=EXACT, atol=EXACT)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=EXACT, atol=EXACT)
    assert len(got["grads"]) == len(want["grads"]) == W.STEPS
    for step, (g, w) in enumerate(zip(got["grads"], want["grads"])):
        assert sorted(g) == sorted(w)
        floor = GRAD_FLOOR * max(float(np.abs(a).max()) for a in w.values())
        for n, a in w.items():
            tol = next((t for names, t in ILL_CONDITIONED.items() if n.endswith(names)),
                       GRAD_REL)
            rel = float(np.abs(g[n] - a).max()) / max(float(np.abs(a).max()), floor)
            assert rel < tol, (step, n, rel)
    _bits_equal(ranks, run)


@pytest.mark.parametrize("run", list(F.RUNS))
def test_rank_multiplies_only_its_parts(tp, run):
    """Every dense product of a step took this rank's part of a weight cut
    over ``model`` (the shape it holds), never the whole; every mamba scan
    ran on this rank's heads only: the convolution on its x channels and
    all of B and C, the gated norm on its heads' width."""
    ranks, model = _ranks(tp, run), F.RUNS[run][2]
    mcfg = F.api_of(run).mcfg
    for res in ranks:
        got = res[run]
        split = {n for n, dims in got["tp_dims"].items() if dims}
        step_shapes = got["held"][0][1]
        for name, shapes in got["seen"].items():
            if name in split:
                assert shapes == [step_shapes[name]], (name, shapes)
                dim = got["tp_dims"][name][0]
                assert shapes[0][dim] * model == got["whole"][name][0][dim], name
        for suffix in MUST_SPLIT[FAMILY[run]]:
            names = [n for n in split if n.endswith(suffix)]
            assert names and all(n in got["seen"] for n in names), (suffix, names)
        if FAMILY[run] in ("ssm", "hybrid"):
            n = mcfg.ssm_expand * mcfg.d_model // model
            assert got["scans"] == [(n + 2 * mcfg.ssm_state, n)], got["scans"]
        else:
            assert got["scans"] == []


@pytest.mark.parametrize("run", list(F.RUNS))
def test_rank_holds_only_its_parts_between_steps(tp, run):
    ranks, model = _ranks(tp, run), F.RUNS[run][2]
    for res in ranks:
        got = res[run]
        cut = sum(int(np.prod(s)) * b for n, (s, b) in got["whole"].items() if got["tp_dims"][n])
        rest = sum(int(np.prod(s)) * b for n, (s, b) in got["whole"].items()
                   if not got["tp_dims"][n])
        assert cut > rest / 4                     # the cut weights are most of the model
        for held, _ in got["held"]:
            assert held == rest + cut // model, (held, rest, cut)


def test_vocabulary_that_does_not_divide_stays_whole_and_warns(tp):
    """seamless's vocabulary of 510 on a 4-way ``model`` axis: tok_embed
    and lm_head whole on every rank, with JAX's one-shot warning, while
    the layers split (the step itself is held to JAX and one rank above)."""
    for res in _ranks(tp, F.VOCAB_RUN):
        got = res[F.VOCAB_RUN]
        assert got["tp_dims"]["tok_embed.table"] == [] and got["tp_dims"]["lm_head.w"] == []
        assert got["tp_dims"]["enc_layers.0.attn.wq.w"] == [0]
        assert any("'vocab'" in w and "replicating" in w for w in got["warnings"]), \
            got["warnings"]
    assert not any("replicating" in w for r in F.RUNS if r != F.VOCAB_RUN
                   for w in _ranks(tp, r)[0][r]["warnings"])


def test_column_dense_with_a_whole_bias_matches_the_whole_layer(tp):
    """fc1 / frontend_proj's case: the weight cut on its output dim, the
    bias whole (``param_shardings`` cuts no vector): each rank adds its
    columns of the bias, and the bias's gradient is the whole one on
    every rank."""
    for rank, res in enumerate(tp[0][2]):
        got = res["bias"]
        whole, n = got["whole"], got["n"]
        cols = slice(rank * n, (rank + 1) * n)
        np.testing.assert_allclose(got["y"], whole["y"][..., cols], rtol=EXACT, atol=EXACT)
        np.testing.assert_allclose(got["w"], whole["w"][cols], rtol=EXACT, atol=EXACT)
        np.testing.assert_allclose(got["b"], whole["b"], rtol=EXACT, atol=EXACT)
        np.testing.assert_allclose(got["x"], whole["x"], rtol=EXACT, atol=EXACT)


def test_gated_norm_statistic_is_summed_both_ways(tp):
    """The gated norm on a rank's heads with its sum of squares summed over
    ``model``: output and gradients as the whole norm's; passing the sum's
    gradient as it is (``reduce_from_model``) loses the other ranks' share
    of every input gradient."""
    for rank, res in enumerate(tp[0][2]):
        got = res["statistic"]
        whole, n = got["whole"], got["n"]
        cols = slice(rank * n, (rank + 1) * n)
        for key in ("out", "y", "z", "g"):
            np.testing.assert_allclose(got["split"][key], whole[key][..., cols], rtol=EXACT,
                                       atol=EXACT, err_msg=key)
        np.testing.assert_allclose(got["identity"]["out"], whole["out"][..., cols],
                                   rtol=EXACT, atol=EXACT)
        assert np.abs(got["identity"]["y"] - whole["y"][..., cols]).max() > 1e-3


def test_ranks_keep_equal_weights_when_a_whole_weight_gradient_differs(tp):
    """Each rank of ``model`` computes the gradient of a weight it holds
    whole on its own; where one rank's comes out otherwise (here rank 1
    shifts ``final_norm.g``'s by 1e-3 of its largest value), ``Trainer``
    takes model rank 0's before the clip and the update, so no weight
    parts between the ranks."""
    for res in tp[0][2]:
        assert res["agree"]["differ"] == []
