"""The port's training path against the JAX package's.

* ``bsa_attention`` gradients (parameters, q, k, v) under the ``kernels``
  backend (plain backward versions on the CPU) and the ``reference``
  backend vs JAX ``bsa_attention(backend="jnp")``;
* one ``make_train_step`` step of a 2-layer narrow ``shapenet-bsa`` vs JAX
  ``make_train_step``: the loss, every gradient by name, and over two steps
  (warm-up lr 0, then lr > 0) the update of every parameter, held to JAX's
  AdamW formula on the port's own gradients and to the JAX step's update;
* the optimizer pieces, the dataset, the reverse parameter bridge, the
  training CLI, and serving still under no-grad.

Same weights on both sides (``params_from_jax``), inputs from numpy.
Whole-model tolerance 1e-3, as the JAX suite's.
"""

import dataclasses
import inspect
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.core import bsa as j_bsa
from repro.core import balltree as j_bt
from repro.core.config import BSAConfig as JBSAConfig
from repro.data import shapenet as j_data
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import pointcloud as j_pc
from repro.models.api import model_api as j_model_api
from repro.optim import adamw as j_adamw
from repro.optim import clip as j_clip
from repro.optim import schedule as j_schedule
from repro_torch.configs import ModelConfig
from repro_torch.convert import named_to_jax, params_from_jax, params_to_jax
from repro_torch.core import balltree as t_bt
from repro_torch.core import bsa as t_bsa
from repro_torch.core.backend import use_backend
from repro_torch.core.config import BSAConfig
from repro_torch.data import shapenet as t_data
from repro_torch.launch import train_shapenet
from repro_torch.launch.steps import make_train_step
from repro_torch.models.api import model_api
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm, cosine_schedule
from repro_torch.serving.engine import GeometryEngine

TOL = dict(atol=1e-3, rtol=1e-3)
BSA = dict(ball_size=16, cmp_block=4, slc_block=4, top_k=2, group_size=4)
MODEL = dict(name="tiny-bsa", family="pointcloud", n_layers=2, d_model=64,
             n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, in_dim=7, out_dim=1,
             attention="bsa", param_dtype="float32", compute_dtype="float32")


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


# ---------------------------------------------------------------------------
# bsa_attention gradients
# ---------------------------------------------------------------------------

B, N, HQ, HKV, D, DM = 3, 64, 4, 2, 16, 32


def _mask():
    m = np.ones((B, N), bool)
    m[1, 41:] = False
    m[2] = False
    return m


@pytest.mark.parametrize("backend", ["kernels", "reference"])
@pytest.mark.parametrize("variant", ["paper", "token_gates"])
def test_bsa_attention_grads_match_jax(variant, backend):
    kw = dict(gate_mode="token") if variant == "token_gates" else {}
    jcfg = JBSAConfig(**BSA, **kw, backend="jnp")
    tcfg = BSAConfig(**BSA, **kw)
    jp = j_bsa.bsa_init(jax.random.PRNGKey(0), jcfg, n_heads=HQ, n_kv_heads=HKV,
                        head_dim=D, d_model=DM)
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda a: np.asarray(a) + rng.normal(0, 0.5, a.shape)
                        .astype(np.float32), jp)          # gates away from ½
    tp = t_bsa.bsa_init(tcfg, n_heads=HQ, n_kv_heads=HKV, head_dim=D, d_model=DM,
                        generator=torch.Generator().manual_seed(0))
    params_from_jax(tree, tp)
    q, k, v, x, do = (rng.standard_normal(s).astype(np.float32) for s in
                      ((B, N, HQ, D), (B, N, HKV, D), (B, N, HKV, D), (B, N, DM),
                       (B, N, HQ, D)))
    mask = _mask()

    def j_fn(p, q, k, v, x):
        return j_bsa.bsa_attention(p, q, k, v, cfg=jcfg, mask=jnp.asarray(mask), x=x,
                                   return_aux=True)

    _, vjp, jaux = jax.vjp(j_fn, jax.tree.map(jnp.asarray, tree),
                           *(jnp.asarray(a) for a in (q, k, v, x)), has_aux=True)
    want = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, x)]
    with use_backend(backend):
        out, taux = t_bsa.bsa_attention(tp, *leaves[:3], cfg=tcfg,
                                        mask=torch.from_numpy(mask), x=leaves[3],
                                        return_aux=True)
    # top-k is discontinuous: both sides must pick the same block sets first
    # (sample 0 is fully valid; elsewhere ties of masked scores order freely)
    np.testing.assert_array_equal(np.sort(taux["indices"][0].numpy(), -1),
                                  np.sort(np.asarray(jaux["indices"][0]), -1))
    out.backward(torch.from_numpy(do))
    _assert_trees_close(params_to_jax(tp, grads=True), want[0])
    for t, w in zip(leaves, want[1:]):       # x reaches the loss only through token gates
        g = t.grad if t.grad is not None else torch.zeros_like(t)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


# ---------------------------------------------------------------------------
# the slice as a whole: make_train_step
# ---------------------------------------------------------------------------

def _models(seed=0):
    jcfg = JModelConfig(**MODEL, vocab_size=0, remat=False,
                        bsa=JBSAConfig(**BSA, backend="jnp"))
    tcfg = ModelConfig(**MODEL, bsa=BSAConfig(**BSA))
    jp = j_pc.pc_init(jax.random.PRNGKey(seed), jcfg)
    model = model_api(tcfg).init(seed, device="cpu")
    params_from_jax(jax.tree.map(np.asarray, jp), model)
    return jcfg, jp, tcfg, model


def _train_batch(seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, N, 7)).astype(np.float32)
    target = rng.standard_normal((B, N, 1)).astype(np.float32)
    mask = _mask()
    mask[2, :20] = True                             # every slot holds a cloud
    feats[~mask] = 0.0
    return {"feats": feats, "target": target, "mask": mask}


def test_train_step_matches_jax():
    jcfg, jp, tcfg, model = _models()
    japi, tapi = j_model_api(jcfg), model_api(tcfg)
    batch = _train_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    (jloss, _), jgrads = jax.jit(jax.value_and_grad(japi.loss, has_aux=True))(jp, jbatch)
    loss, _ = tapi.loss(model, tbatch)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    _assert_trees_close(params_to_jax(model, grads=True), jgrads)

    kw = dict(base_lr=1e-3, weight_decay=0.01, total_steps=10, warmup_steps=1)
    jstep, tstep = jax.jit(j_make_train_step(japi, **kw)), make_train_step(tapi, **kw)
    jstate = j_adamw.adamw_init(jp)
    tstate = adamw_init(dict(model.named_parameters()))
    j0, t0 = _flat(jax.tree.map(np.asarray, jp)), _flat(params_to_jax(model))
    lrs = []
    for _ in range(2):
        jp, jstate, jout = jstep(jp, jstate, jbatch)
        t_before = (params_to_jax(model), {"m": named_to_jax(tstate["m"]),
                                           "v": named_to_jax(tstate["v"]),
                                           "step": jnp.asarray(tstate["step"], jnp.int32)})
        model, tstate, tout = tstep(model, tstate, tbatch)
        np.testing.assert_allclose(float(tout["loss"]), float(jout["loss"]), **TOL)
        np.testing.assert_allclose(float(tout["grad_norm"]), float(jout["grad_norm"]),
                                   **TOL)
        np.testing.assert_allclose(tout["lr"], float(jout["lr"]), rtol=1e-6)
        lrs.append(tout["lr"])
    assert lrs[0] == 0.0 < lrs[1] and tstate["step"] == 2
    # the second step's update is JAX's AdamW formula applied to the port's own
    # parameters, clipped gradients (left in .grad) and state before the step
    want, _ = j_adamw.adamw_update(t_before[0], params_to_jax(model, grads=True),
                                   t_before[1], lr=lrs[1], weight_decay=0.01)
    _assert_trees_close(params_to_jax(model), want, atol=1e-6, rtol=1e-6)
    # and it moves each parameter as the JAX step does: lr = 1e-3 here, while
    # gradients within rounding of Adam's ε (1e-8) may flip m̂/(√v̂ + ε) by a
    # few 1e-5 of a step
    jf, tf = _flat(jax.tree.map(np.asarray, jp)), _flat(params_to_jax(model))
    grads = _flat(params_to_jax(model, grads=True))
    assert sorted(jf) == sorted(tf)
    for name in jf:
        moved = tf[name] - t0[name]
        if grads[name].any():                      # φ_q only decays: no gradient
            assert np.abs(moved).max() > 5e-4, name
        np.testing.assert_allclose(moved, jf[name] - j0[name], atol=1e-4, rtol=0,
                                   err_msg=name)


def test_train_step_kernels_backend_matches_reference():
    _, _, tcfg, model = _models(seed=1)
    api = model_api(tcfg)
    batch = {k: torch.from_numpy(v) for k, v in _train_batch(1).items()}
    grads = {}
    for backend in ("kernels", "reference"):
        model.zero_grad(set_to_none=True)
        with use_backend(backend):
            loss, _ = api.loss(model, batch)
            loss.backward()
        grads[backend] = params_to_jax(model, grads=True)
    _assert_trees_close(grads["kernels"], grads["reference"], atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# optimizer pieces
# ---------------------------------------------------------------------------

SHAPES = {"a": (5, 3), "b": (7,), "c": (2, 3, 4)}


def _tree(rng, scale=1.0, positive=False):
    t = {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}
    return {k: np.abs(v) for k, v in t.items()} if positive else t


@pytest.mark.parametrize("step", [0, 3])
def test_adamw_update_matches_jax(step):
    rng = np.random.default_rng(step)
    p, g, m, v = _tree(rng), _tree(rng), _tree(rng, 0.1), _tree(rng, 0.1, positive=True)
    jp, jstate = j_adamw.adamw_update(
        p, g, {"m": m, "v": v, "step": jnp.asarray(step, jnp.int32)}, lr=3e-3,
        weight_decay=0.01)
    tp = {k: torch.from_numpy(a.copy()) for k, a in p.items()}
    tstate = {"m": {k: torch.from_numpy(a.copy()) for k, a in m.items()},
              "v": {k: torch.from_numpy(a.copy()) for k, a in v.items()}, "step": step}
    tstate = adamw_update(tp, {k: torch.from_numpy(a) for k, a in g.items()}, tstate,
                          lr=3e-3, weight_decay=0.01)
    assert tstate["step"] == int(jstate["step"]) == step + 1
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(tstate["m"][k].numpy(), np.asarray(jstate["m"][k]),
                                   atol=1e-7, rtol=1e-6)
        np.testing.assert_allclose(tstate["v"][k].numpy(), np.asarray(jstate["v"][k]),
                                   atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_by_global_norm_matches_jax(scale):
    g = _tree(np.random.default_rng(7), scale)
    jg, jnorm = j_clip.clip_by_global_norm(g, 1.0)
    tg = [torch.from_numpy(g[k].copy()) for k in SHAPES]
    _, tnorm = clip_by_global_norm(tg, 1.0)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    for k, t in zip(SHAPES, tg):
        np.testing.assert_allclose(t.numpy(), np.asarray(jg[k]), atol=1e-7, rtol=1e-6)
    zeros = [torch.zeros(3)]
    _, norm = clip_by_global_norm(zeros, 1.0)                  # the 1e-12 floor
    assert float(norm) == 0.0 and torch.isfinite(zeros[0]).all()


def test_cosine_schedule_matches_jax():
    kw = dict(base_lr=1e-3, total_steps=100, warmup_steps=10)
    for step in (0, 1, 9, 10, 11, 55, 99, 100, 150):   # JAX fp32, here fp64
        np.testing.assert_allclose(cosine_schedule(step, **kw),
                                   float(j_schedule.cosine_schedule(step, **kw)),
                                   rtol=1e-6, atol=1e-9)
    assert cosine_schedule(5, base_lr=1.0, total_steps=10, min_lr_ratio=0.1) == \
        pytest.approx(float(j_schedule.cosine_schedule(5, base_lr=1.0, total_steps=10,
                                                       min_lr_ratio=0.1)))


# ---------------------------------------------------------------------------
# data, parameter bridge, CLI, serving
# ---------------------------------------------------------------------------

def test_dataset_items_match_jax():
    t_ds, j_ds = t_data.ShapeNetCarDataset("train"), j_data.ShapeNetCarDataset("train")
    for i in (0, 3):
        got, want = t_ds[i], j_ds[i]
        assert sorted(got) == sorted(want) and got["feats"].shape == (3840, 7)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
    assert len(t_data.ShapeNetCarDataset("test")) == len(j_data.ShapeNetCarDataset("test"))


@pytest.mark.parametrize("pad_to", [None, 448])
def test_dataset_batches_match_jax(pad_to):
    kw = dict(ball_size=64, n_points_range=(250, 400))
    t_ds, j_ds = t_data.ShapeNetCarDataset("train", **kw), j_data.ShapeNetCarDataset(
        "train", **kw)
    assert t_ds.max_padded_len == j_ds.max_padded_len
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)   # JAX: prefer varlen
        want = list(zip(range(2), j_ds.batches(3, seed=5, pad_to=pad_to)))
    got = list(zip(range(2), t_ds.batches(3, seed=5, pad_to=pad_to)))
    for (_, g), (_, w) in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key])
    items = [t_ds[i] for i in range(3)]
    for key, arr in t_bt.pack_items(items, 512).items():
        np.testing.assert_array_equal(arr, j_bt.pack_items(items, 512)[key])


def test_params_to_jax_inverts_params_from_jax():
    _, jp, _, model = _models(seed=2)
    tree = jax.tree.map(np.asarray, jp)
    _assert_trees_close(params_to_jax(model), tree, atol=0, rtol=0)
    zero = params_to_jax(model, grads=True)                    # no backward yet
    assert all((a == 0).all() for a in _flat(zero).values())
    # the baselines (no ``bsa`` key under ``attn``; Erwin's levels change no
    # parameter) and group compression (φ = "mlp": ``pos``, ``fc1``, ``fc2``)
    group_cmp = dict(BSA, group_compression=True, phi="mlp")
    for attention, bsa in (("full", BSA), ("erwin", BSA), ("bsa", group_cmp)):
        jcfg = JModelConfig(**dict(MODEL, attention=attention), vocab_size=0, remat=False,
                            bsa=JBSAConfig(**bsa, backend="jnp"))
        tcfg = ModelConfig(**dict(MODEL, attention=attention), bsa=BSAConfig(**bsa))
        tree = jax.tree.map(np.asarray, j_pc.pc_init(jax.random.PRNGKey(3), jcfg))
        model = params_from_jax(tree, model_api(tcfg).init(3, device="cpu"))
        _assert_trees_close(params_to_jax(model), tree, atol=0, rtol=0)
        attn = _flat(tree["layers"]["attn"])
        if attention == "bsa":
            assert {f"bsa.phi_{w}.{p}" for w in "qkv" for p in ("pos", "fc1.w", "fc1.b",
                                                                 "fc2.w", "fc2.b")} <= set(attn)
        else:
            assert sorted(attn) == ["wk.w", "wo.w", "wq.w", "wv.w"]


def test_train_cli_runs_on_cpu(capsys, monkeypatch):
    # the CLI evaluates 8 test batches of 8 cars, as examples/train_shapenet.py
    # does; one car here keeps the test short
    evaluate, calls = train_shapenet.evaluate, []

    def one_car(*args, **kw):
        calls.append(kw)
        return evaluate(*args, **kw, n_batches=1, batch_size=1)

    monkeypatch.setattr(train_shapenet, "evaluate", one_car)
    mse = train_shapenet.main(["--device", "cpu", "--layers", "1", "--steps", "2",
                               "--batch", "1"])
    out = capsys.readouterr().out
    assert "step    0" in out and "step    1" in out and "test MSE" in out
    assert np.isfinite(mse) and calls == [{"device": torch.device("cpu"), "pad_to": None}]
    defaults = inspect.signature(evaluate).parameters
    assert defaults["n_batches"].default == defaults["batch_size"].default == 8


def test_serving_runs_under_no_grad():
    _, _, tcfg, model = _models(seed=3)
    api = model_api(tcfg)
    seen = []

    def spy(m, batch):
        out = api.forward(m, batch)
        seen.append((torch.is_grad_enabled(), out.requires_grad))
        return out

    eng = GeometryEngine(dataclasses.replace(api, forward=spy), model, batch_slots=2,
                         layout="padded")
    rng = np.random.default_rng(0)
    clouds = [(rng.standard_normal((n, 3)).astype(np.float32),
               rng.standard_normal((n, 7)).astype(np.float32)) for n in (30, 50)]
    assert torch.is_grad_enabled()
    outs = eng.predict(clouds)
    assert seen == [(False, False)] and [o.shape for o in outs] == [(30, 1), (50, 1)]
    batch = {"feats": torch.zeros(1, 16, 7), "mask": torch.ones(1, 16, dtype=torch.bool)}
    assert not api.forward(model, batch).requires_grad
