"""The paper's other workloads in the port against the JAX package.

* ``full_attention`` and ``erwin_attention`` (levels 0–2, a key mask with a
  partial pooled token, GQA rep 2) on the port's ``kernels`` backend (the
  plain versions on the CPU), forward and gradients, vs JAX's ``interpret``
  backend (the Pallas kernels in interpret mode) and its ``jnp`` backend;
* ``layers.nn.mlp`` and the MLP form of ``phi_apply`` (φ = "mlp") with a
  mask, on random non-symmetric weights, with a check that the other flatten
  order would be caught;
* one ``make_train_step`` of each point-cloud arch (the five of Table 3,
  and Table 2's two Elasticity configs) at the smoke size vs JAX: the loss,
  every gradient by name, the gradient norm, and the update as JAX's AdamW
  formula gives it on the port's clipped gradients;
* ``ElasticityDataset``, Erwin's error on a sequence that does not cover
  the coarse balls, the mechanisms the packed layout refuses, and the
  training CLI on Elasticity.

Same weights on both sides (``params_from_jax``), inputs from numpy.
Tolerance 1e-3 (fp32), as the JAX suite's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.reduce import SMOKE_BSA as J_SMOKE_BSA
from repro.configs.reduce import smoke_config as j_smoke_config
from repro.core import branches as j_branches
from repro.core import erwin_attention as j_erwin_attention
from repro.core import full_attention as j_full_attention
from repro.core.config import BSAConfig as JBSAConfig
from repro.data import elasticity as j_elasticity
from repro.layers import nn as j_nn
from repro.models import attention_layer as j_attn
from repro.models import pointcloud as j_pc
from repro.models.api import model_api as j_model_api
from repro.optim import adamw as j_adamw
from repro.optim import clip as j_clip
from repro_torch.configs import get_config
from repro_torch.configs.reduce import SMOKE_BSA, smoke_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core import branches as t_branches
from repro_torch.core.backend import use_backend
from repro_torch.core.bsa import Phi
from repro_torch.core.config import BSAConfig
from repro_torch.core.erwin import erwin_attention
from repro_torch.core.full_attention import full_attention
from repro_torch.data import elasticity as t_elasticity
from repro_torch.launch import train_shapenet
from repro_torch.launch.steps import make_train_step
from repro_torch.layers.nn import MLP, mlp
from repro_torch.models import attention_layer as t_attn
from repro_torch.models.api import model_api
from repro_torch.optim import adamw_init

TOL = dict(atol=1e-3, rtol=1e-3)
B, N, HQ, HKV, D, BALL = 2, 128, 4, 2, 16, 32


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
        np.testing.assert_allclose(g[name], w[name], err_msg=name, **(tol or TOL))


def _perturbed(tree, seed):
    """``tree`` with every leaf moved by N(0, 0.3): biases away from 0."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + rng.normal(0, 0.3, a.shape)
                        .astype(np.float32), tree)


# ---------------------------------------------------------------------------
# the two baselines' attention
# ---------------------------------------------------------------------------

def _qkv(seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in
                   ((B, N, HQ, D), (B, N, HKV, D), (B, N, HKV, D), (B, N, HQ, D)))
    mask = np.ones((B, N), bool)
    mask[1, 99:] = False          # pooled by 2 and 4: one partial pooled token
    return q, k, v, do, mask


def _parity(j_fn, t_fn, seed):
    """The port's ``t_fn`` on the kernels backend against ``j_fn`` on JAX's
    interpret (Pallas) and jnp backends: output and (dq, dk, dv)."""
    q, k, v, do, mask = _qkv(seed)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    with use_backend("kernels"):
        out = t_fn(*leaves, mask=torch.from_numpy(mask))
    out.backward(torch.from_numpy(do))
    for backend in ("interpret", "jnp"):
        want, vjp = jax.vjp(lambda q, k, v: j_fn(q, k, v, mask=jnp.asarray(mask),
                                                 backend=backend), q, k, v)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                                   err_msg=backend, **TOL)
        for t, w in zip(leaves, vjp(jnp.asarray(do))):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), err_msg=backend,
                                       **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_full_attention_matches_jax(causal):
    _parity(lambda *a, **kw: j_full_attention(*a, causal=causal, **kw),
            lambda *a, **kw: full_attention(*a, causal=causal, **kw), seed=1)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_erwin_attention_matches_jax(level):
    _parity(lambda *a, **kw: j_erwin_attention(*a, ball_size=BALL, level=level, **kw),
            lambda *a, **kw: erwin_attention(*a, ball_size=BALL, level=level, **kw),
            seed=2 + level)


def test_erwin_attention_needs_whole_coarse_balls():
    q = torch.zeros(1, 96, 2, 8)
    with pytest.raises(ValueError, match=r"N=96 .* 2·32 = 64 \(level 1\)"):
        erwin_attention(q, q, q, ball_size=32, level=1)
    assert erwin_attention(q, q, q, ball_size=32, level=0).shape == q.shape


# ---------------------------------------------------------------------------
# φ = "mlp"
# ---------------------------------------------------------------------------

def test_mlp_matches_jax():
    tree = _perturbed(j_nn.mlp_init(jax.random.PRNGKey(0), 24, 40, 12), 0)
    module = params_from_jax(tree, MLP(24, 40, 12, generator=torch.Generator()))
    x = np.random.default_rng(1).standard_normal((3, 5, 24)).astype(np.float32)
    dy = np.random.default_rng(2).standard_normal((3, 5, 12)).astype(np.float32)
    want, vjp = jax.vjp(j_nn.mlp, jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = mlp(module, xt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    out.backward(torch.from_numpy(dy))
    gp, gx = vjp(jnp.asarray(dy))
    _assert_trees_close(params_to_jax(module, grads=True), gp)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)


def test_phi_mlp_matches_jax():
    ell, hd = 4, 8
    jcfg = JBSAConfig(ball_size=16, cmp_block=ell, slc_block=ell, phi="mlp")
    tcfg = BSAConfig(ball_size=16, cmp_block=ell, slc_block=ell, phi="mlp")
    tree = _perturbed(j_branches.phi_init(jax.random.PRNGKey(3), jcfg, hd), 3)
    phi = params_from_jax(tree, Phi(tcfg, hd, generator=torch.Generator(),
                                    dtype=torch.float32, device=None))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 32, 3, hd)).astype(np.float32)
    dy = rng.standard_normal((2, 32 // ell, 3, hd)).astype(np.float32)
    mask = np.ones((2, 32), bool)
    mask[0, 5:7] = False                   # a block with holes
    mask[1, 24:] = False                   # two dead blocks
    want, vjp = jax.vjp(lambda p, x: j_branches.phi_apply(p, x, jnp.asarray(mask), jcfg),
                        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = t_branches.phi_apply(phi, xt, torch.from_numpy(mask), tcfg)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    out.backward(torch.from_numpy(dy))
    gp, gx = vjp(jnp.asarray(dy))
    _assert_trees_close(params_to_jax(phi, grads=True), gp)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    # the block flattens token-outer: the dim-outer order would be caught
    with torch.no_grad():
        xb = torch.from_numpy(x).reshape(2, 8, ell, 3, hd) + phi.pos[None, None, :, None]
        xb = torch.where(torch.from_numpy(mask).reshape(2, 8, ell, 1, 1), xb, 0.0)
        other = mlp(phi, xb.permute(0, 1, 3, 4, 2).reshape(2, 8, 3, ell * hd))
    assert np.abs(other.numpy() - np.asarray(want)).max() > 0.1


# ---------------------------------------------------------------------------
# one train step of each point-cloud arch
# ---------------------------------------------------------------------------

POINT_ARCHS = ["shapenet-bsa", "shapenet-bsa-no-group", "shapenet-bsa-group-cmp",
               "shapenet-full", "shapenet-erwin", "elasticity-bsa", "elasticity-full"]
SHARED = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "in_dim",
          "out_dim", "attention", "param_dtype", "compute_dtype")


def _smoke_configs(arch):
    """(JAX, port) smoke configs of ``arch``: ``smoke_config`` swaps in
    ``SMOKE_BSA``, so group-cmp gets its group compression and φ back; Erwin
    gets 4 layers, so its level 2 runs."""
    jcfg, tcfg = j_smoke_config(j_get_config(arch)), smoke_config(get_config(arch))
    if arch == "shapenet-bsa-group-cmp":
        jcfg = dataclasses.replace(jcfg, bsa=dataclasses.replace(
            J_SMOKE_BSA, group_compression=True, phi="mlp"))
        tcfg = tcfg.scaled(bsa=dataclasses.replace(SMOKE_BSA, group_compression=True,
                                                   phi="mlp"))
    if arch == "shapenet-erwin":
        jcfg, tcfg = dataclasses.replace(jcfg, n_layers=4), tcfg.scaled(n_layers=4)
    jcfg = dataclasses.replace(jcfg, bsa=dataclasses.replace(jcfg.bsa, backend="jnp"))
    return jcfg, tcfg


@pytest.mark.parametrize("arch", POINT_ARCHS)
def test_point_arch_train_step_matches_jax(arch):
    jcfg, tcfg = _smoke_configs(arch)
    assert {f: getattr(tcfg, f) for f in SHARED} == {f: getattr(jcfg, f) for f in SHARED}
    jb, tb = dataclasses.asdict(jcfg.bsa), dataclasses.asdict(tcfg.bsa)
    assert {k: tb[k] for k in tb if k != "backend"} == {k: jb[k] for k in tb
                                                         if k != "backend"}
    japi, tapi = j_model_api(jcfg), model_api(tcfg)
    jp = j_pc.pc_init(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jp), tapi.init(0, device="cpu"))
    rng = np.random.default_rng(5)
    n = 256
    batch = {"feats": rng.standard_normal((2, n, tcfg.in_dim)).astype(np.float32),
             "target": rng.standard_normal((2, n, 1)).astype(np.float32),
             "mask": np.ones((2, n), bool)}
    batch["mask"][1, 201:] = False
    batch["feats"][~batch["mask"]] = 0.0
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(japi.loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})

    before = params_to_jax(model)
    state = adamw_init(dict(model.named_parameters()))
    step = make_train_step(tapi, base_lr=1e-3, weight_decay=0.01, total_steps=10,
                           warmup_steps=0)
    model, state, out = step(model, state, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
    np.testing.assert_allclose(float(out["loss"]), float(jloss), **TOL)
    _, jnorm = j_clip.clip_by_global_norm(jgrads, 1.0)
    np.testing.assert_allclose(float(out["grad_norm"]), float(jnorm), **TOL)
    clipped = params_to_jax(model, grads=True)       # .grad holds the clipped gradient
    scale = min(1.0, 1.0 / float(jnorm))
    _assert_trees_close(clipped, jax.tree.map(lambda g: np.asarray(g) * scale, jgrads))
    zeros = jax.tree.map(np.zeros_like, before)
    want, _ = j_adamw.adamw_update(before, clipped, {"m": zeros, "v": zeros,
                                                     "step": jnp.asarray(0, jnp.int32)},
                                   lr=out["lr"], weight_decay=0.01)
    assert out["lr"] > 0
    _assert_trees_close(params_to_jax(model), want, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# Elasticity, the packed layout's refusals, the CLI
# ---------------------------------------------------------------------------

def test_elasticity_items_match_jax():
    t_ds, j_ds = t_elasticity.ElasticityDataset("train"), j_elasticity.ElasticityDataset(
        "train")
    for i in (0, 7):
        got, want = t_ds[i], j_ds[i]
        assert sorted(got) == sorted(want) and got["feats"].shape == (1024, 6)
        assert int(got["mask"].sum()) == t_elasticity.N_POINTS
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
    assert len(t_elasticity.ElasticityDataset("test")) == len(
        j_elasticity.ElasticityDataset("test")) == 200


@pytest.mark.parametrize("pad_to", [None, 384])
def test_elasticity_batches_match_jax(pad_to):
    kw = dict(ball_size=64, n_points_range=(150, 300))
    t_ds, j_ds = (t_elasticity.ElasticityDataset("test", **kw),
                  j_elasticity.ElasticityDataset("test", **kw))
    assert t_ds.max_padded_len == j_ds.max_padded_len == 320
    got = [b for _, b in zip(range(2), t_ds.batches(3, seed=5, pad_to=pad_to))]
    want = [b for _, b in zip(range(2), j_ds.batches(3, seed=5, pad_to=pad_to))]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key])


@pytest.mark.parametrize("attention", ["full", "erwin"])
def test_baselines_refuse_packed_offsets_and_decode(attention):
    """The baselines refuse packed offsets; their dense and paged decode
    caches (K, V and a length; K, V pools with a trash block) equal JAX's
    ``attention_cache_init`` / ``attention_paged_cache_init``."""
    cfg = smoke_config(get_config(f"shapenet-{attention}"))
    layer = t_attn.AttentionLayer(cfg, generator=torch.Generator())
    assert not hasattr(layer, "bsa")
    x = torch.zeros(1, 64, cfg.d_model)
    with pytest.raises(NotImplementedError, match=f"attention='{attention}'"):
        t_attn.attention_layer_apply(layer, x, mcfg=cfg, mask=torch.ones(1, 64, dtype=bool),
                                     offsets=np.array([0, 32, 64], np.int32))
    jcfg = j_smoke_config(j_get_config(f"shapenet-{attention}"))
    for got, want in ((t_attn.attention_cache_init(cfg, 2, 64, torch.float32),
                       j_attn.attention_cache_init(jcfg, 2, 64, jnp.float32)),
                      (t_attn.attention_paged_cache_init(cfg, 4, 16, torch.float32),
                       j_attn.attention_paged_cache_init(jcfg, 4, 16, jnp.float32))):
        assert sorted(got) == sorted(want)
        for key in want:
            assert tuple(got[key].shape) == want[key].shape, key
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
            assert (got[key].dtype == torch.float32) == (want[key].dtype == jnp.float32)


def test_train_cli_runs_elasticity_on_cpu(capsys, monkeypatch):
    evaluate, seen = train_shapenet.evaluate, []

    def one_plate(api, model, ds, **kw):
        seen.append(type(ds).__name__)
        return evaluate(api, model, ds, **kw, n_batches=1, batch_size=1)

    monkeypatch.setattr(train_shapenet, "evaluate", one_plate)
    mse = train_shapenet.main(["--arch", "elasticity-full", "--device", "cpu",
                               "--layers", "1", "--steps", "2", "--batch", "2"])
    out = capsys.readouterr().out
    assert "step    1" in out and "[elasticity-full] test MSE" in out
    assert np.isfinite(mse) and seen == ["ElasticityDataset"]
