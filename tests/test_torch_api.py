"""The port's public API and entry points against the JAX package, on the CPU.

* ``repro_torch.core`` exports a counterpart of every name that
  ``repro.core`` imports, by the mapping in its docstring;
* ``ball_order``, ``ball_ids`` and ``ragged_ball_order`` equal JAX's
  exactly on seeded clouds;
* the backend precedence: config < ``use_backend`` <
  ``$REPRO_TORCH_ATTENTION_BACKEND`` (JAX's variable ignored, an unknown
  name raising, the override holding in the remat recompute on another
  thread);
* the three dense configs (stablelm-1.6b, phi4-mini-3.8b, granite-20b)
  equal JAX's on every shared field; at their smoke size ``lm_apply``
  matches JAX on converted weights, and two ``make_train_step`` steps of
  stablelm's (rep 1) match JAX;
* every assigned config (and its smoke size) equals JAX's field for
  field, an unknown name raises, and the quickstart runs.

Same weights on both sides (``params_from_jax``), inputs from numpy.
Tolerances: ``lm_apply`` fp32 1e-4; the train step 1e-3, as
``tests/test_torch_lm_train.py``'s.
"""

import ast
import dataclasses
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core as t_core
from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.configs.reduce import smoke_config as j_smoke_config
from repro.core import balltree as j_bt
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import transformer as j_tf
from repro.models.api import model_api as j_model_api
from repro.optim import adamw as j_adamw
from repro_torch.configs import get_config, list_archs, list_configs
from repro_torch.configs.reduce import smoke_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core import backend as t_backend
from repro_torch.core import balltree as t_bt
from repro_torch.core.config import BSAConfig
from repro_torch.data import lm_batches
from repro_torch.launch import quickstart
from repro_torch.launch.steps import make_train_step
from repro_torch.models.api import model_api
from repro_torch.optim import adamw_init

ROOT = Path(__file__).resolve().parents[1]
NEW_LMS = ("stablelm-1.6b", "phi4-mini-3.8b", "granite-20b")
TOL = dict(atol=1e-3, rtol=1e-3)
APPLY_TOL = dict(atol=1e-4, rtol=1e-4)
# repro.core's names that the port names otherwise (None: no counterpart)
RENAMED = {"JnpBackend": "ReferenceBackend", "PallasBackend": "KernelBackend",
           "Backend": None}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


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
# the public API
# ---------------------------------------------------------------------------

def _jax_core_names() -> list[str]:
    tree = ast.parse((ROOT / "src" / "repro" / "core" / "__init__.py").read_text())
    return [a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
            for a in node.names]


def test_core_exports_a_counterpart_of_every_jax_name():
    names = _jax_core_names()
    assert len(names) > 25 and "bsa_attention" in names
    doc = t_core.__doc__
    for name in names:
        mapped = RENAMED.get(name, name)
        if name in RENAMED:                        # the docstring states the mapping
            line = next(ln for ln in doc.splitlines() if f"``{name}``" in ln)
            assert "→" in line and (mapped is None and "none" in line
                                    or mapped is not None and mapped in line), line
        if mapped is not None:
            assert hasattr(t_core, mapped), f"repro_torch.core lacks {mapped} ({name})"
    assert [n for n in names if RENAMED.get(n, n) is None] == ["Backend"]
    assert "queue 1 item 3" in doc                 # the sharded backend, not faked
    from repro_torch.core import (BSAConfig, bsa_attention, bsa_attention_varlen,  # noqa
                                  erwin_attention, full_attention, nsa_causal_attention,
                                  pack_varlen, ragged_ball_order, resolve_backend,
                                  use_backend)
    assert t_core.ReferenceBackend is t_backend.ReferenceBackend


@pytest.mark.parametrize("n", [900, 1500, 2048])
def test_ball_order_and_ids_equal_jax(n):
    rng = np.random.default_rng(n)
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    feats = rng.standard_normal((n, 5)).astype(np.float32)
    for got, want in zip(t_bt.ball_order(pts, feats, 256), j_bt.ball_order(pts, feats, 256)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t_bt.ball_ids(n, 64), j_bt.ball_ids(n, 64))


@pytest.mark.parametrize("geometric,pad_to", [(True, None), (False, None), (False, 2304)])
def test_ragged_ball_order_equals_jax(geometric, pad_to):
    rng = np.random.default_rng(7)
    clouds = [rng.standard_normal((n, 3)).astype(np.float32) for n in (900, 1500, 2048)]
    feats = [rng.standard_normal((n, 4)).astype(np.float32) for n in (900, 1500, 2048)]
    kw = dict(pad_to=pad_to, geometric=geometric)
    got = t_bt.ragged_ball_order(clouds, feats, 256, **kw)
    want = j_bt.ragged_ball_order(clouds, feats, 256, **kw)
    for g, w in zip(got[:3], want[:3]):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got[3], want[3]):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# backend resolution
# ---------------------------------------------------------------------------

def test_backend_precedence(monkeypatch):
    monkeypatch.delenv(t_backend.ENV_VAR, raising=False)
    ref, kern = t_backend.get_backend("reference"), t_backend.get_backend("kernels")
    cfg = BSAConfig(backend="reference", backend_overrides={"slc": "kernels"})
    assert t_backend.resolve_branch_backends(cfg) == {"ball": ref, "cmp": ref, "slc": kern}
    assert t_backend.resolve_backend_name(None) == "auto"
    assert t_backend.resolve_backend("reference") is ref
    assert t_backend.resolve_backend(kern) is kern          # an object passes through
    with t_backend.use_backend("kernels"):                  # beats the config
        assert t_backend.resolve_branch_backends(cfg) == dict.fromkeys(("ball", "cmp",
                                                                       "slc"), kern)
        assert t_backend.resolve_backend("reference") is kern
        monkeypatch.setenv(t_backend.ENV_VAR, "reference")  # beats use_backend
        assert t_backend.resolve_branch_backends(cfg) == dict.fromkeys(("ball", "cmp",
                                                                       "slc"), ref)
        assert t_backend.resolve_backend_name("kernels") == "reference"
        assert t_backend.resolve_backend("kernels") is ref
        assert t_backend.resolve_backend(kern) is kern      # still passes through
    monkeypatch.setenv(t_backend.ENV_VAR, "kernels")
    assert t_backend.resolve_branch_backends(BSAConfig(backend="reference"))["ball"] is kern


def test_backend_env_var_is_the_ports_own(monkeypatch):
    monkeypatch.delenv(t_backend.ENV_VAR, raising=False)
    assert t_backend.ENV_VAR == "REPRO_TORCH_ATTENTION_BACKEND"
    monkeypatch.setenv("REPRO_ATTENTION_BACKEND", "jnp")    # JAX's: not read here
    ref = t_backend.get_backend("reference")
    assert t_backend.resolve_branch_backends(BSAConfig(backend="reference"))["slc"] is ref
    monkeypatch.setenv(t_backend.ENV_VAR, "jnp")            # a JAX name: unknown here
    with pytest.raises(KeyError, match="registered: .*kernels.*reference"):
        t_backend.resolve_branch_backends(BSAConfig())
    with pytest.raises(KeyError, match="jnp"):
        t_backend.resolve_backend()
    with pytest.raises(KeyError, match="nope"):
        t_backend.use_backend("nope").__enter__()


def test_backend_env_var_holds_in_the_remat_recompute(monkeypatch):
    """The recompute of a checkpointed period runs on the thread that runs
    the backward (autograd's own, for a CUDA backward; a worker thread
    here): the environment's backend must hold there as in the forward."""
    calls = []
    for cls in (t_backend.KernelBackend, t_backend.ReferenceBackend):
        fn = cls.local_window

        def spy(self, *a, _fn=fn, **kw):
            calls.append((self.name, threading.current_thread().name))
            return _fn(self, *a, **kw)
        monkeypatch.setattr(cls, "local_window", spy)
    monkeypatch.setenv(t_backend.ENV_VAR, "kernels")         # "auto" on CPU: reference
    cfg = smoke_config(get_config("stablelm-1.6b")).scaled(remat=True)
    api = model_api(cfg)
    model = api.init(0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in next(lm_batches(
        vocab_size=cfg.vocab_size, batch_size=2, seq_len=64, seed=0)).items() if k != "_state"}
    loss, _ = api.loss(model, batch)
    errors = []

    def backward():
        try:
            loss.backward()
        except Exception as e:                     # noqa: BLE001 (asserted below)
            errors.append(e)

    worker = threading.Thread(target=backward, name="backward-worker")
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive() and not errors, errors
    main = threading.current_thread().name
    assert calls.count(("kernels", main)) == cfg.n_layers
    assert calls.count(("kernels", "backward-worker")) == cfg.n_layers   # the recompute
    assert not [c for c in calls if c[0] == "reference"]


# ---------------------------------------------------------------------------
# the three dense configs
# ---------------------------------------------------------------------------

def test_configs_registered_and_the_rest_raise():
    """Every assigned architecture is registered (all ten families' configs
    are ported); an unknown name still raises."""
    assert set(list_archs()) <= set(list_configs())
    assert list_archs() == j_list_archs()
    for arch in list_archs():
        assert get_config(arch).name == arch
    with pytest.raises(KeyError, match="unknown config"):
        get_config("no-such-model")


def _fields(cfg) -> dict:
    """The config's fields; of its BSA config those the port has (the
    deprecated ``use_kernels`` flag is not carried over)."""
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    out["bsa"] = {k: v for k, v in dataclasses.asdict(cfg.bsa).items() if k != "use_kernels"}
    return out


@pytest.mark.parametrize("arch", list_archs() + ["shapenet-bsa", "shapenet-full",
                                                 "shapenet-erwin", "elasticity-bsa"])
def test_config_equals_jax_field_for_field(arch):
    """The port's ``ModelConfig`` has JAX's fields, and each config (and its
    smoke size) equals JAX's ``get_config`` field for field: the
    counterpart of ``tests/test_archs_smoke.py::test_full_configs_have_exact_dims``."""
    got, want = get_config(arch), j_get_config(arch)
    assert sorted(_fields(got)) == sorted(_fields(want))
    assert _fields(got) == _fields(want)
    assert _fields(smoke_config(got)) == _fields(j_smoke_config(want))
    assert model_api(got).mcfg is got


@pytest.mark.parametrize("arch", NEW_LMS)
def test_dense_config_equals_jax(arch):
    got, want = get_config(arch), j_get_config(arch)
    shared = {f.name for f in dataclasses.fields(got)} & {f.name for f in
                                                         dataclasses.fields(want)}
    assert len(shared) >= 19
    for name in sorted(shared - {"bsa"}):
        assert getattr(got, name) == getattr(want, name), name
    bsa = {f.name for f in dataclasses.fields(got.bsa)} & {f.name for f in
                                                           dataclasses.fields(want.bsa)}
    for name in sorted(bsa):
        assert getattr(got.bsa, name) == getattr(want.bsa, name), f"bsa.{name}"
    assert got.family == "dense" and not got.tie_embeddings


def _smoke_pair(arch, **overrides):
    jcfg = j_smoke_config(j_get_config(arch))
    jcfg = jcfg.scaled(bsa=dataclasses.replace(jcfg.bsa, backend="jnp"), **overrides)
    jp = j_model_api(jcfg).init(jax.random.PRNGKey(0))
    tcfg = smoke_config(get_config(arch)).scaled(**overrides)
    assert (tcfg.n_layers, tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads, tcfg.head_dim,
            tcfg.vocab_size) == (jcfg.n_layers, jcfg.d_model, jcfg.n_heads,
                                 jcfg.n_kv_heads, jcfg.head_dim, jcfg.vocab_size)
    model = params_from_jax(jax.tree.map(np.asarray, jp),
                            model_api(tcfg).init(1, device="cpu"))
    return jcfg, jp, tcfg, model


@pytest.mark.parametrize("arch,rep", [("stablelm-1.6b", 1), ("phi4-mini-3.8b", 4),
                                      ("granite-20b", 4)])
def test_smoke_lm_apply_matches_jax(arch, rep):
    jcfg, jp, tcfg, model = _smoke_pair(arch)
    assert tcfg.n_heads // tcfg.n_kv_heads == rep
    toks = np.random.default_rng(11).integers(0, tcfg.vocab_size, (2, 64)).astype(np.int32)
    want, _ = j_tf.lm_apply(jp, jnp.asarray(toks), mcfg=jcfg)
    with t_backend.use_backend("kernels"):         # the kernels' plain versions
        got = model_api(tcfg).forward(model, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 64, tcfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **APPLY_TOL)


def test_stablelm_train_step_matches_jax():
    jcfg, jp, tcfg, model = _smoke_pair("stablelm-1.6b")
    assert tcfg.n_heads == tcfg.n_kv_heads                 # rep 1
    japi, tapi = j_model_api(jcfg), model_api(tcfg)
    kw = dict(base_lr=1e-3, weight_decay=0.01, total_steps=10, warmup_steps=1)
    jstep, tstep = jax.jit(j_make_train_step(japi, **kw)), make_train_step(tapi, **kw)
    jstate, tstate = j_adamw.adamw_init(jp), adamw_init(dict(model.named_parameters()))
    data = lm_batches(vocab_size=tcfg.vocab_size, batch_size=2, seq_len=64, seed=0)
    for _, batch in zip(range(2), data):
        jp, jstate, jout = jstep(jp, jstate, {k: jnp.asarray(batch[k])
                                              for k in ("tokens", "labels")})
        with t_backend.use_backend("kernels"):
            model, tstate, tout = tstep(model, tstate, {k: torch.from_numpy(batch[k])
                                                        for k in ("tokens", "labels")})
        np.testing.assert_allclose(float(tout["loss"]), float(jout["loss"]), **TOL)
        np.testing.assert_allclose(float(tout["grad_norm"]), float(jout["grad_norm"]),
                                   **TOL)
        _assert_trees_close(params_to_jax(model), jp)
    assert tstate["step"] == int(jstate["step"]) == 2


# ---------------------------------------------------------------------------
# the quickstart
# ---------------------------------------------------------------------------

def test_quickstart_runs_on_cpu(capsys):
    out = quickstart.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "batched == per-sample (padded cloud): OK" in text
    assert "backend swap reference ↔ kernels" in text
    assert "packed-varlen == bucket-padded, per cloud: OK" in text
    assert out["out"].shape == (1, 2048, 4, 16) and out["packed"].shape == (4608, 4, 16)
    assert all(bool(torch.isfinite(t).all()) for t in out.values())


def test_quickstart_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        quickstart.main([])
