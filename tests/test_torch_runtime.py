"""The port's training runtime: checkpoints, the watchdog and the Trainer,
on the CPU (the JAX suite's ``tests/test_substrate.py`` checkpoint,
watchdog and trainer tests, and more).

* ``CheckpointManager``: round trip and keep-last-2 pruning, the async
  writer (a save owns a copy: parameters updated in place after it do not
  reach the file), bf16 tensors bit for bit, a shape mismatch raising;
* ``Watchdog``: a straggler, and the hang callback;
* ``Trainer`` on the smoke tinyllama: the loss decreases and a resume goes
  on counting optimizer steps; 2 steps then 2 resumed equal 4 straight
  bit for bit; SIGTERM during ``fit`` saves that step and stops; 2 steps
  on weights converted from JAX match JAX's ``Trainer`` (losses and
  parameters, 1e-3 as ``tests/test_torch_train.py``); on a tiny
  ``shapenet-bsa`` both packages' ``Trainer`` write the same checkpoint
  names and log step labels and resume at the same step (the loop index,
  as JAX numbers it);
* the ``launch.train`` and ``launch.train_shapenet --var-points --ckpt``
  CLIs on the CPU.
"""

import dataclasses
import json
import os
import signal
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.reduce import smoke_config as j_smoke_config
from repro.data import lm as j_lm
from repro.models.api import model_api as j_model_api
from repro.core.config import BSAConfig as JBSAConfig
from repro.optim import adamw as j_adamw
from repro.runtime import Trainer as JTrainer
from repro.runtime import TrainerConfig as JTrainerConfig
from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.configs import get_config
from repro_torch.configs.reduce import smoke_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core.backend import use_backend
from repro_torch.core.config import BSAConfig
from repro_torch.data import lm_batches
from repro_torch.launch import train, train_shapenet
from repro_torch.models.api import model_api
from repro_torch.runtime import Trainer, TrainerConfig, Watchdog

TOL = dict(atol=1e-3, rtol=1e-3)
SEQ = 64


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((2, 3), generator=g),
                       "layers.0.b": torch.randn((4,), generator=g)},
            "opt": {"m": {"w": torch.zeros((2, 3))}, "step": 7}}


def _template():
    return {"params": {"w": torch.empty((2, 3)), "layers.0.b": torch.empty((4,))},
            "opt": {"m": {"w": torch.empty((2, 3))}, "step": 0}}


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_prune(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_last=2, async_save=False)
    state = _state()
    for s in (10, 20, 30):
        mgr.save(s, state, extra={"tag": s})
    assert latest_step(tmp_path) == 30 and mgr.save_count == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000020", "step_00000030"]
    meta = json.loads((tmp_path / "step_00000030" / "manifest.json").read_text())
    assert meta["leaves"]["params/w"] == {"shape": [2, 3], "dtype": "float32"}
    template = _template()
    got, meta = mgr.restore(template)
    assert meta["step"] == 30 and meta["extra"] == {"tag": 30}
    assert got["params"]["w"] is template["params"]["w"]      # filled in place
    torch.testing.assert_close(got["params"]["w"], state["params"]["w"], atol=0, rtol=0)
    torch.testing.assert_close(got["params"]["layers.0.b"], state["params"]["layers.0.b"],
                               atol=0, rtol=0)
    assert got["opt"]["step"] == 7 and isinstance(got["opt"]["step"], int)
    got, meta = mgr.restore(_template(), step=20)
    assert meta["step"] == 20
    assert latest_step(tmp_path / "nothing") is None
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(_template())


def test_checkpoint_async_save_owns_a_copy(tmp_path):
    """The port updates parameters in place: an async save must hold the
    values at the time of the save, not what a later step writes."""
    mgr = CheckpointManager(tmp_path, keep_last=3, async_save=True)
    state = _state(1)
    want = {k: v.clone() for k, v in state["params"].items()}
    mgr.save(1, state)
    with torch.no_grad():                          # the next step, while it writes
        for t in state["params"].values():
            t.add_(1.0)
    mgr.wait()
    assert latest_step(tmp_path) == 1
    got, _ = mgr.restore(_template())
    for k, v in want.items():
        torch.testing.assert_close(got["params"][k], v, atol=0, rtol=0)


def test_checkpoint_bf16_bits_round_trip(tmp_path):
    bits = torch.randint(-2 ** 15, 2 ** 15, (64,), dtype=torch.int32).to(torch.int16)
    bits[:3] = torch.tensor([0x7F80, -0x80, 0x0001], dtype=torch.int16)   # inf, -0, tiny
    w = bits.view(torch.bfloat16)
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(3, {"w": w, "n": 5})
    meta = json.loads((tmp_path / "step_00000003" / "manifest.json").read_text())
    assert meta["leaves"]["w"]["dtype"] == "bfloat16"
    target = {"w": torch.zeros(64, dtype=torch.bfloat16), "n": 0}
    got, _ = mgr.restore(target)
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), bits) and got["n"] == 5


def test_checkpoint_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(5, _state())
    bad = _template()
    bad["params"]["w"] = torch.empty((3, 2))
    with pytest.raises(ValueError, match="params/w"):
        mgr.restore(bad)
    missing = _template()
    missing["params"]["extra"] = torch.empty(1)
    with pytest.raises(KeyError, match="params/extra"):
        mgr.restore(missing)


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------

def test_watchdog_straggler_detection():
    events = []
    wd = Watchdog(straggler_factor=2.0, on_straggler=lambda s, d, e: events.append((s, d)))
    for i in range(10):
        wd.step(i, 0.1)
    assert wd.step(10, 0.5)                        # 5× slower than the EWMA
    assert len(events) == 1 and events[0][0] == 10
    wd.step(11, 0.1)                               # the baseline not poisoned
    assert len(events) == 1 and wd.straggler_events[0][0] == 10


def test_watchdog_hang_callback():
    fired = threading.Event()
    wd = Watchdog(hang_timeout=0.2, on_hang=fired.set).start()
    try:
        assert fired.wait(timeout=10)              # no beat for 0.2 s
    finally:
        wd.stop()
    assert not wd._thread.is_alive()
    fired.clear()
    wd.hang_timeout = 60.0
    wd.start()                                     # restartable (one thread a fit)
    try:
        assert wd._thread.is_alive()
        wd.step(0, 0.01)
        assert not fired.is_set()
    finally:
        wd.stop()
    assert not wd._thread.is_alive()


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

def _api(remat=False):
    return model_api(smoke_config(get_config("tinyllama-1.1b")).scaled(remat=remat))


def _data(start=0):
    return lm_batches(vocab_size=512, batch_size=2, seq_len=SEQ, seed=0, start_step=start)


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def test_trainer_loss_decreases_and_resumes(tmp_path):
    api = _api()
    cfg = TrainerConfig(base_lr=3e-3, total_steps=40, warmup_steps=2, ckpt_dir=str(tmp_path),
                        ckpt_every=10, log_every=100)
    tr = Trainer(api, cfg, device="cpu")
    model, opt = tr.fit(_data(), steps=21)
    losses = [m["loss"] for m in tr.metrics_history]
    assert [m["step"] for m in tr.metrics_history] == [0, 20]
    assert losses[-1] < losses[0], f"loss did not decrease: {losses}"
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000010", "step_00000020"]          # step 0 is never saved
    assert opt["step"] == 21 and tr.wall_time > 0
    meta = json.loads((tmp_path / "step_00000020" / "manifest.json").read_text())
    assert meta["extra"] == {"data_state": {"seed": 0, "step": 20}}

    tr2 = Trainer(api, cfg, device="cpu")          # resume: starts at step index 20
    model2, opt2 = tr2.fit(_data(21), steps=12)
    assert opt2["step"] == 33 and latest_step(tmp_path) == 31
    assert [m["step"] for m in tr2.metrics_history] == [31]
    # keep-last 3: 10 pruned after 31
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000020", "step_00000030", "step_00000031"]


def test_trainer_resume_is_bit_exact(tmp_path):
    api = _api(remat=True)
    kw = dict(base_lr=3e-3, total_steps=10, warmup_steps=1, ckpt_every=2)
    straight, _ = Trainer(api, TrainerConfig(**kw), device="cpu").fit(_data(), steps=4)
    cfg = TrainerConfig(**kw, ckpt_dir=str(tmp_path))
    _, opt = Trainer(api, cfg, device="cpu").fit(_data(), steps=2)
    assert opt["step"] == 2 and latest_step(tmp_path) == 1
    tr = Trainer(api, cfg, device="cpu")
    model, opt = tr.fit(_data(2), steps=2)
    assert opt["step"] == 4 and latest_step(tmp_path) == 2
    want = _params(straight)
    for n, p in model.named_parameters():
        assert torch.equal(p, want[n]), n


def test_trainer_restore_gives_the_data_state(tmp_path):
    api = _api()
    cfg = TrainerConfig(base_lr=3e-3, total_steps=10, warmup_steps=1, ckpt_dir=str(tmp_path),
                        ckpt_every=2)
    fresh = Trainer(api, cfg, device="cpu")
    model, opt = fresh.init_state()
    assert fresh.maybe_restore(model, opt)[2] == 0 and fresh.data_state is None
    fresh.fit(_data(), steps=3)
    tr = Trainer(api, cfg, device="cpu")
    model, opt = tr.init_state()
    model, opt, step0 = tr.maybe_restore(model, opt)
    assert step0 == 2 and opt["step"] == 3
    assert tr.data_state == {"seed": 0, "step": 2}     # the last batch step 2 trained on


def test_trainer_saves_and_stops_on_sigterm(tmp_path):
    api = _api()
    cfg = TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=100, log_every=1)
    tr = Trainer(api, cfg, device="cpu")
    before = signal.getsignal(signal.SIGTERM)
    on_main = threading.current_thread() is threading.main_thread()

    def batches():
        for i, b in enumerate(_data()):
            if i == 2:                             # SIGTERM while step 2 is drawn
                if on_main:
                    os.kill(os.getpid(), signal.SIGTERM)
                else:                              # no handler off the main thread
                    tr._preempted = True
            yield b

    try:
        model, opt = tr.fit(batches(), steps=10)
    finally:
        installed = signal.getsignal(signal.SIGTERM)
        signal.signal(signal.SIGTERM, before)
    assert installed == before                     # fit put the old handler back
    assert opt["step"] == 3 and latest_step(tmp_path) == 2
    assert [m["step"] for m in tr.metrics_history] == [0, 1, 2]
    template = {"params": {n: torch.empty_like(p) for n, p in model.named_parameters()}}
    got, meta = CheckpointManager(tmp_path).restore(template)
    assert meta["step"] == 2
    for n, p in model.named_parameters():
        assert torch.equal(got["params"][n], p), n


def test_trainer_matches_jax_trainer():
    jcfg = j_smoke_config(j_get_config("tinyllama-1.1b"))
    jcfg = jcfg.scaled(bsa=dataclasses.replace(jcfg.bsa, backend="jnp"))
    japi = j_model_api(jcfg)
    jp = japi.init(jax.random.PRNGKey(0))
    tapi = _api()
    model = params_from_jax(jax.tree.map(np.asarray, jp), tapi.init(1, device="cpu"))
    kw = dict(base_lr=1e-3, weight_decay=0.01, total_steps=10, warmup_steps=1,
              log_every=1)
    jtr = JTrainer(japi, JTrainerConfig(**kw))
    jp, jopt = jtr.fit(j_lm.lm_batches(vocab_size=512, batch_size=2, seq_len=SEQ, seed=0),
                       steps=2, params=jp, opt_state=j_adamw.adamw_init(jp))
    ttr = Trainer(tapi, TrainerConfig(**kw), device="cpu")
    with use_backend("kernels"):                   # the kernels' plain versions
        model, topt = ttr.fit(_data(), steps=2, model=model)
    assert len(ttr.metrics_history) == len(jtr.metrics_history) == 2
    for got, want in zip(ttr.metrics_history, jtr.metrics_history):
        np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], **TOL)
        assert got["lr"] == pytest.approx(want["lr"], rel=1e-6)
    assert topt["step"] == int(jopt["step"]) == 2
    got, want = params_to_jax(model), jax.tree.map(np.asarray, jp)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        np.testing.assert_allclose(flat_g[path], leaf, err_msg=jax.tree_util.keystr(path),
                                   **TOL)


def _cloud_batches(in_dim, out_dim, start=0, B=2, N=32):
    """Point-cloud batches of numpy arrays, batch i from seed i."""
    i = start
    while True:
        rng = np.random.default_rng(i)
        yield {"feats": rng.standard_normal((B, N, in_dim), dtype=np.float32),
               "target": rng.standard_normal((B, N, out_dim), dtype=np.float32),
               "mask": np.ones((B, N), bool)}
        i += 1


def test_trainer_numbers_steps_as_the_jax_trainer(tmp_path):
    """The tiny ``shapenet-bsa`` of the suites, 5 steps then 3 resumed with
    ``ckpt_every`` 3 and ``log_every`` 2, through both packages' ``Trainer``:
    the same checkpoint directories, the same logged step labels, the same
    resumed ``step0`` (the last checkpoint's step index)."""
    tiny = dict(n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64)
    bsa = dict(ball_size=16, cmp_block=4, slc_block=4, top_k=2, group_size=4)
    japi = j_model_api(j_get_config("shapenet-bsa").scaled(
        **tiny, bsa=JBSAConfig(**bsa, backend="jnp")))
    tapi = model_api(get_config("shapenet-bsa").scaled(**tiny, bsa=BSAConfig(**bsa)))
    kw = dict(base_lr=1e-3, total_steps=10, warmup_steps=1, ckpt_every=3, log_every=2)
    dims = (tapi.mcfg.in_dim, tapi.mcfg.out_dim)
    runs = {}
    for name, make in (("jax", lambda d: JTrainer(japi, JTrainerConfig(**kw, ckpt_dir=d))),
                       ("torch", lambda d: Trainer(tapi, TrainerConfig(**kw, ckpt_dir=d),
                                                   device="cpu"))):
        d = tmp_path / name
        first = make(str(d))
        first.fit(_cloud_batches(*dims), steps=5)
        saved = sorted(p.name for p in d.iterdir())
        again = make(str(d))
        step0 = again.maybe_restore(*again.init_state())[2]
        again.fit(_cloud_batches(*dims, start=5), steps=3)
        runs[name] = (saved, [m["step"] for m in first.metrics_history], step0,
                      [m["step"] for m in again.metrics_history],
                      sorted(p.name for p in d.iterdir()))
    assert runs["torch"] == runs["jax"]
    assert runs["torch"] == (["step_00000003", "step_00000004"], [0, 2, 4], 4, [4, 6],
                             ["step_00000003", "step_00000004", "step_00000006"])


def test_trainer_defaults_to_the_card():
    tr = Trainer(_api(), TrainerConfig())
    assert tr.device == torch.device("cuda")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tr.init_state()


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def test_train_cli_checkpoints_and_resumes(tmp_path, capsys):
    argv = ["--smoke", "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "64",
            "--backend", "kernels", "--ckpt", str(tmp_path)]
    loss = train.main(argv)
    out = capsys.readouterr().out
    assert "step    0" in out and "step    1" in out and "done: 2 steps" in out
    assert np.isfinite(loss) and latest_step(tmp_path) == 1
    loss = train.main(argv)                        # resumes at step 1, data at batch 2
    out = capsys.readouterr().out
    assert "step    1" in out and "step    2" in out and "step    0" not in out
    assert np.isfinite(loss) and latest_step(tmp_path) == 2
    meta = json.loads((tmp_path / "step_00000002" / "manifest.json").read_text())
    assert meta["extra"]["data_state"] == {"seed": 0, "step": 3}


def test_train_shapenet_cli_var_points(tmp_path, capsys, monkeypatch):
    evaluate, calls = train_shapenet.evaluate, []

    def one_car(*args, **kw):
        calls.append(kw)
        return evaluate(*args, **{**kw, "n_batches": 1, "batch_size": 1})

    monkeypatch.setattr(train_shapenet, "evaluate", one_car)
    fed = []
    fit = Trainer.fit

    def spy(self, batches, **kw):
        def tap():
            for b in batches:
                fed.append(b["mask"].shape)
                yield b
        return fit(self, tap(), **kw)

    monkeypatch.setattr(Trainer, "fit", spy)
    mse = train_shapenet.main(["--device", "cpu", "--layers", "1", "--steps", "2",
                               "--batch", "2", "--var-points", "900", "1500",
                               "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert "step    0" in out and "step    1" in out and "test MSE" in out
    assert np.isfinite(mse) and latest_step(tmp_path) == 1
    assert fed == [(2, 1536), (2, 1536)]           # padded to max_padded_len
    assert calls == [{"device": torch.device("cpu"), "pad_to": 1536}]
