"""The port's LM training path against the JAX package, on the CPU.

* the local-window backward's plain version against ``jax.vjp`` through the
  Pallas local kernel in interpret mode (the forward test's cases), and
  against autograd through the forward's plain version;
* the LM loss (``masked_mean_nll``) and the token pipeline (``lm_batches``);
* a 2-layer smoke tinyllama ``make_train_step`` against JAX
  ``make_train_step`` (backend ``jnp``) on converted weights over two steps:
  loss, gradient norm, every gradient and every updated parameter;
* port-only: remat on and off give the same gradients (and remat runs each
  layer's forward twice), AdamW on bf16 parameters against the JAX function,
  and the training CLI.

The same numpy inputs from a seed go to both packages.  Tolerances: the
backward plain version fp32 1e-3 and bf16 4e-2 against the Pallas kernel,
1e-5 against autograd; the loss 1e-6; the train step 1e-3, as the JAX
suite's; bf16 AdamW within one bf16 ulp.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.reduce import smoke_config as j_smoke_config
from repro.data import lm as j_lm
from repro.kernels import local as j_local
from repro.launch.steps import make_train_step as j_make_train_step
from repro.layers import losses as j_losses
from repro.models.api import model_api as j_model_api
from repro.optim import adamw as j_adamw
from repro_torch.configs import get_config
from repro_torch.configs.reduce import smoke_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core.backend import use_backend
from repro_torch.data import lm_batches
from repro_torch.kernels import local as t_local
from repro_torch.kernels.common import row_delta
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_step
from repro_torch.layers.losses import masked_mean_nll
from repro_torch.models import transformer as t_tf
from repro_torch.models.api import model_api
from repro_torch.optim import adamw_init, adamw_update

KERNEL_TOL = {"float32": dict(atol=1e-3, rtol=1e-3),
              "bfloat16": dict(atol=4e-2, rtol=4e-2)}
TOL = dict(atol=1e-3, rtol=1e-3)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


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
# the local-window backward's plain version
# ---------------------------------------------------------------------------

B, HKV, N, W, D = 2, 2, 128, 32, 16


def _local_case(rep, masked, segmented, seed):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((B * HKV, rep, N, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B * HKV, N, D)).astype(np.float32) for _ in range(2))
    valid = np.ones((B, N), bool)
    if masked:
        valid[0, 50:70] = False                    # a ragged hole
        valid[1, 64:96] = False                    # a fully dead block
    bias = np.where(valid, 0.0, -1e30).astype(np.float32)
    seg = np.array([[0, 0, 1, 1], [0, 1, 1, 2]], np.int32) if segmented else None
    return q, k, v, do, bias, seg


def _port_bwd(q, k, v, do, bias, seg, dtype):
    tq, tk, tv, tdo = (_t(a, dtype) for a in (q, k, v, do))
    tseg = None if seg is None else _t(seg, torch.int32)
    kw = dict(window=W, n_heads=HKV)
    o, lse = t_local.local_window_fwd(tq, tk, tv, _t(bias), tseg, **kw)
    return t_local.local_window_bwd(tq, tk, tv, _t(bias), tseg, tdo, lse,
                                    row_delta(tdo, o), **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rep,masked,segmented", [(1, False, False), (4, False, False),
                                                  (1, True, True), (4, True, False),
                                                  (4, False, True), (4, True, True)])
def test_local_window_bwd_plain_matches_pallas(dtype, rep, masked, segmented):
    q, k, v, do, bias, seg = _local_case(rep, masked, segmented,
                                         rep + 2 * masked + 4 * segmented)
    jdt = getattr(jnp, dtype)
    jseg = None if seg is None else jnp.asarray(seg)

    def attend(q, k, v):
        return j_local.local_window_kernel_call(q, k, v, jnp.asarray(bias), window=W,
                                                n_heads=HKV, interpret=True, blk_seg=jseg)

    _, vjp = jax.vjp(attend, *(jnp.asarray(a, jdt) for a in (q, k, v)))
    want = vjp(jnp.asarray(do, jdt))
    got = _port_bwd(q, k, v, do, bias, seg, getattr(torch, dtype))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == getattr(torch, dtype) and g.shape == w.shape
        np.testing.assert_allclose(_np(g), _np(w), err_msg=name, **KERNEL_TOL[dtype])
    if masked:                                     # masked keys: exactly zero gradient
        dead = np.repeat(bias > -1, HKV, 0) == 0
        assert not _np(got[1])[dead].any() and not _np(got[2])[dead].any()


@pytest.mark.parametrize("masked,segmented", [(False, False), (True, True)])
def test_local_window_bwd_plain_matches_autograd(masked, segmented):
    q, k, v, do, bias, seg = _local_case(4, masked, segmented, 11)
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    tseg = None if seg is None else _t(seg, torch.int32)
    o, _ = t_local.local_window_fwd_plain(*leaves, _t(bias), tseg, window=W, n_heads=HKV)
    want = torch.autograd.grad(o, leaves, _t(do))
    got = _port_bwd(q, k, v, do, bias, seg, torch.float32)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    # and LocalWindowFn's backward on CPU tensors is this plain version
    fn_leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    out = t_local.LocalWindowFn.apply(*fn_leaves, _t(bias), tseg, W, HKV)
    for g, w in zip(torch.autograd.grad(out, fn_leaves, _t(do)), got):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# loss and data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_mask", [False, True])
def test_masked_mean_nll_matches_jax(with_mask):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 24, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (2, 24)).astype(np.int32)
    mask = rng.random((2, 24)) < 0.6 if with_mask else None
    want = j_losses.masked_mean_nll(jnp.asarray(logits), jnp.asarray(labels),
                                    None if mask is None else jnp.asarray(mask))
    got = masked_mean_nll(_t(logits), _t(labels, torch.int32),
                          None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), float(want), atol=1e-6, rtol=1e-6)
    if with_mask:                                  # the denominator floored at 1
        none = torch.zeros(2, 24, dtype=torch.bool)
        assert float(masked_mean_nll(_t(logits), _t(labels, torch.int32), none)) == 0.0


def test_lm_batches_match_jax():
    kw = dict(vocab_size=512, batch_size=3, seq_len=40, seed=5, start_step=2)
    for (_, got), (_, want) in zip(zip(range(2), lm_batches(**kw)),
                                   zip(range(2), j_lm.lm_batches(**kw))):
        assert sorted(got) == sorted(want) and got["_state"] == want["_state"]
        for key in ("tokens", "labels"):
            assert got[key].dtype == np.int32 and got[key].shape == (3, 40)
            np.testing.assert_array_equal(got[key], want[key])


# ---------------------------------------------------------------------------
# the slice as a whole: make_train_step on the smoke tinyllama
# ---------------------------------------------------------------------------

def _smoke_lms(**overrides):
    jcfg = j_smoke_config(j_get_config("tinyllama-1.1b"))
    jcfg = jcfg.scaled(bsa=dataclasses.replace(jcfg.bsa, backend="jnp"), **overrides)
    jp = j_model_api(jcfg).init(jax.random.PRNGKey(0))
    tcfg = smoke_config(get_config("tinyllama-1.1b")).scaled(**overrides)
    model = params_from_jax(jax.tree.map(np.asarray, jp),
                            model_api(tcfg).init(1, device="cpu"))
    return jcfg, jp, tcfg, model


def _lm_batches(n, seq=64):
    return [b for _, b in zip(range(n), lm_batches(vocab_size=512, batch_size=2,
                                                   seq_len=seq, seed=0))]


def test_lm_train_step_matches_jax():
    jcfg, jp, tcfg, model = _smoke_lms()
    assert not tcfg.remat and not jcfg.remat
    japi, tapi = j_model_api(jcfg), model_api(tcfg)
    batches = _lm_batches(2)
    kw = dict(base_lr=1e-3, weight_decay=0.01, total_steps=10, warmup_steps=1)
    jstep, tstep = jax.jit(j_make_train_step(japi, **kw)), make_train_step(tapi, **kw)
    jgrad = jax.jit(jax.value_and_grad(japi.loss, has_aux=True))
    jstate = j_adamw.adamw_init(jp)
    tstate = adamw_init(dict(model.named_parameters()))
    for i, batch in enumerate(batches):
        jbatch = {k: jnp.asarray(batch[k]) for k in ("tokens", "labels")}
        tbatch = {k: torch.from_numpy(batch[k]) for k in ("tokens", "labels")}
        (_, jm), jgrads = jgrad(jp, jbatch)
        jp, jstate, jout = jstep(jp, jstate, jbatch)
        with use_backend("kernels"):               # the kernels' plain backward versions
            model, tstate, tout = tstep(model, tstate, tbatch)
        assert sorted(k for k in tout if k != "lr") == sorted(
            k for k in jout if k != "lr") == ["aux_loss", "grad_norm", "loss"]
        np.testing.assert_allclose(float(tout["loss"]), float(jout["loss"]), **TOL)
        np.testing.assert_allclose(float(tout["grad_norm"]), float(jout["grad_norm"]),
                                   **TOL)
        assert float(tout["aux_loss"]) == float(jm["aux_loss"]) == 0.0
        np.testing.assert_allclose(tout["lr"], float(jout["lr"]), rtol=1e-6)
        # .grad holds the clipped gradient: clip JAX's the same way
        scale = min(1.0, 1.0 / max(float(jout["grad_norm"]), 1e-12))
        _assert_trees_close(params_to_jax(model, grads=True),
                            jax.tree.map(lambda g: g * scale, jgrads))
        _assert_trees_close(params_to_jax(model), jp)
        assert tout["lr"] == (0.0 if i == 0 else pytest.approx(1e-3))
    # φ_q feeds only the top-k indices: no gradient in either package
    phi_q = [n for n, _ in model.named_parameters() if "phi_q" in n]
    assert phi_q and all(model.get_parameter(n).grad is None for n in phi_q)


def test_remat_gives_the_same_gradients(monkeypatch):
    grads, calls = {}, []
    layer = t_tf.lm_layer

    def counted(*args, **kw):
        calls.append(torch.is_grad_enabled())
        return layer(*args, **kw)

    monkeypatch.setattr(t_tf, "lm_layer", counted)
    batch = {k: torch.from_numpy(v) for k, v in _lm_batches(1)[0].items() if k != "_state"}
    for remat in (False, True):
        cfg = smoke_config(get_config("tinyllama-1.1b")).scaled(remat=remat)
        api = model_api(cfg)
        model = api.init(0, device="cpu")
        calls.clear()
        with use_backend("kernels"):
            loss, _ = api.loss(model, batch)
            loss.backward()
        # remat runs each layer's forward again in the backward
        assert len(calls) == cfg.n_layers * (2 if remat else 1)
        grads[remat] = {n: p.grad.clone() for n, p in model.named_parameters()
                        if p.grad is not None}
        with torch.no_grad():                      # no autograd: no checkpoint
            calls.clear()
            api.loss(model, batch)
            assert len(calls) == cfg.n_layers
    assert sorted(grads[True]) == sorted(grads[False])
    for name, g in grads[False].items():
        torch.testing.assert_close(grads[True][name], g, atol=1e-6, rtol=1e-6)
    assert get_config("tinyllama-1.1b").remat and not get_config("shapenet-bsa").remat


def test_remat_recompute_keeps_the_forward_backend():
    """Autograd runs a CUDA backward on a thread of its own, where the
    caller's ``use_backend`` is not active; the recompute must still run the
    forward's backend (else its saved tensors differ and checkpoint raises).
    The backward runs on another thread here to show it on the CPU."""
    cfg = smoke_config(get_config("tinyllama-1.1b")).scaled(remat=True)
    api = model_api(cfg)
    model = api.init(0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _lm_batches(1)[0].items() if k != "_state"}
    with use_backend("kernels"):                   # "auto" on the CPU is the reference
        loss, _ = api.loss(model, batch)
    errors = []

    def backward():
        try:
            loss.backward()
        except Exception as e:                     # noqa: BLE001 (re-raised below)
            errors.append(e)

    worker = threading.Thread(target=backward)
    worker.start()
    worker.join()
    assert not errors, errors
    want = {}
    model_ref = api.init(0, device="cpu")
    with use_backend("kernels"):
        loss_ref, _ = api.loss(model_ref, batch)
        loss_ref.backward()
    for (name, p), (_, q) in zip(model.named_parameters(), model_ref.named_parameters()):
        if q.grad is not None:
            torch.testing.assert_close(p.grad, q.grad, atol=0, rtol=0, msg=name)


def _ulps_apart(got: torch.Tensor, want) -> int:
    """Largest distance in bf16 ulps (same-sign values)."""
    g = got.view(torch.int16).numpy().astype(np.int32)
    w = torch.from_numpy(np.asarray(want, np.float32)).to(torch.bfloat16)
    assert (torch.sign(got) == torch.sign(w)).all()
    return int(np.abs(g - w.view(torch.int16).numpy().astype(np.int32)).max())


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_bf16_matches_jax(state_dtype):
    rng = np.random.default_rng(4)
    shapes = {"a": (5, 3), "b": (64,), "c": (2, 3, 4)}
    p, g = ({k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
            for _ in range(2))
    jdt, tdt = getattr(jnp, state_dtype), getattr(torch, state_dtype)
    jp = {k: jnp.asarray(a, jnp.bfloat16) for k, a in p.items()}
    tp = {k: torch.from_numpy(a).to(torch.bfloat16) for k, a in p.items()}
    jstate = j_adamw.adamw_init(jp, state_dtype=jdt)
    tstate = adamw_init(tp, state_dtype=tdt)
    for step in range(3):
        grads = {k: (a * (step + 1)).astype(np.float32) for k, a in g.items()}
        jp, jstate = j_adamw.adamw_update(
            jp, {k: jnp.asarray(a, jnp.bfloat16) for k, a in grads.items()}, jstate,
            lr=3e-2, weight_decay=0.01)
        tstate = adamw_update(tp, {k: torch.from_numpy(a).to(torch.bfloat16)
                                   for k, a in grads.items()}, tstate, lr=3e-2,
                              weight_decay=0.01)
        for k in shapes:
            assert tp[k].dtype == torch.bfloat16 and tstate["m"][k].dtype == tdt
            assert _ulps_apart(tp[k], jp[k]) <= 1, k
            for mom in ("m", "v"):
                got, want = tstate[mom][k], jstate[mom][k]
                if tdt == torch.bfloat16:
                    assert _ulps_apart(got, want) <= 1, (k, mom)
                else:
                    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                               atol=1e-9)
    assert tstate["step"] == int(jstate["step"]) == 3


def test_train_cli_runs_on_cpu(capsys):
    loss = train.main(["--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
                       "--seq", "64"])
    out = capsys.readouterr().out
    assert "step    0" in out and "step    1" in out and "done: 2 steps" in out
    assert np.isfinite(loss)
