"""The training loop: the train step with periodic async checkpoints, a
save on SIGTERM, a straggler watchdog, and resume.

Counterpart of ``repro/runtime/trainer.py``.  One ``Trainer`` drives the
point-cloud models and the LMs (everything goes through
``models.api.model_api``).  The JAX trainer jits a pure step; here
``make_train_step`` updates the model and the optimizer state in place.
Weights are drawn from ``TrainerConfig.seed`` on the trainer's device
(``cuda`` unless the caller asks for the CPU).  A checkpoint holds
``{"params": the model's named parameters, "opt": the AdamW state}``.
Steps are numbered as the JAX trainer numbers them: a log line, an entry
of ``metrics_history`` and a checkpoint name the loop index of the step
(0 for the first), a checkpoint is saved where that index is a multiple
of ``ckpt_every``, on SIGTERM and at the last step, never at the first
step of a ``fit``, and a resumed ``fit`` starts at the checkpoint's index.
So the step a resume starts with repeats that index, as in JAX; the
schedule reads the optimizer's own count (``opt_state["step"]``), which
goes on from the checkpoint's.  A batch's ``_state`` (the LM pipeline's
(seed, step)) goes into the checkpoint's ``extra`` as ``data_state``.
There is no mesh and no sharding rules (ROADMAP queue 1 item 3).
"""

from __future__ import annotations

import dataclasses
import signal
import time

import torch

from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import adamw_init
from repro_torch.runtime.watchdog import Watchdog

__all__ = ["TrainerConfig", "Trainer", "to_device"]


@dataclasses.dataclass
class TrainerConfig:
    base_lr: float = 1e-3
    weight_decay: float = 0.01
    total_steps: int = 100_000
    warmup_steps: int = 1000
    max_grad_norm: float = 1.0
    ckpt_dir: str | None = None
    ckpt_every: int = 500
    keep_last: int = 3
    log_every: int = 50
    seed: int = 0


def to_device(batch: dict, device) -> dict:
    """numpy (or tensor) batch → tensors on ``device``; keys starting with
    ``_``, such as the LM pipeline's ``_state``, stay behind."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()
            if not k.startswith("_")}


class Trainer:
    def __init__(self, api, cfg: TrainerConfig, *, device="cuda"):
        self.api = api
        self.cfg = cfg
        self.device = torch.device(device)
        self.watchdog = Watchdog()
        self.ckpt = (CheckpointManager(cfg.ckpt_dir, keep_last=cfg.keep_last)
                     if cfg.ckpt_dir else None)
        self._preempted = False
        self.metrics_history: list[dict] = []
        self.wall_time = 0.0
        self.data_state = None
        self._step = make_train_step(
            api, base_lr=cfg.base_lr, weight_decay=cfg.weight_decay,
            total_steps=cfg.total_steps, warmup_steps=cfg.warmup_steps,
            max_grad_norm=cfg.max_grad_norm)

    # ------------------------------------------------------------------

    def init_state(self):
        """(model, opt_state): weights from ``cfg.seed`` on the trainer's
        device, zero AdamW moments in the config's ``opt_state_dtype``."""
        model = self.api.init(self.cfg.seed, device=self.device)
        return model, self._opt_init(model)

    def _opt_init(self, model) -> dict:
        return adamw_init(dict(model.named_parameters()),
                          state_dtype=getattr(torch, self.api.mcfg.opt_state_dtype))

    def maybe_restore(self, model, opt_state):
        """Resume from the newest checkpoint if there is one: the model's
        parameters and the moments are filled in place, and ``data_state``
        becomes the checkpoint's (the ``_state`` of the last batch it
        trained on; None without one), for the caller to restart its data
        from.  Returns (model, opt_state, the checkpoint's step index: the
        ``step0`` a resumed ``fit`` starts at)."""
        self.data_state = None
        if self.ckpt is None or latest_step(self.cfg.ckpt_dir) is None:
            return model, opt_state, 0
        state, meta = self.ckpt.restore({"params": dict(model.named_parameters()),
                                         "opt": opt_state})
        self.data_state = meta["extra"].get("data_state")
        return model, state["opt"], meta["step"]

    def _install_sigterm(self):
        """SIGTERM sets a flag: the step it lands in saves (blocking) and the
        loop stops, past a fit's first step (as in JAX).  Returns the
        previous handler, or None off the main thread, where a handler
        cannot be installed."""
        def handler(signum, frame):
            self._preempted = True
        try:
            return signal.signal(signal.SIGTERM, handler)
        except ValueError:                              # not the main thread
            return None

    # ------------------------------------------------------------------

    def fit(self, batches, *, steps: int, model=None, opt_state=None,
            start_step: int | None = None):
        """Run ``steps`` optimizer steps over ``batches`` (an iterator of
        dicts of numpy arrays or tensors).  Without ``model``, it starts
        from ``init_state`` and the newest checkpoint.  Returns (model,
        opt_state)."""
        if model is None:
            model, opt_state = self.init_state()
            model, opt_state, restored = self.maybe_restore(model, opt_state)
        else:
            restored = 0
            if opt_state is None:
                opt_state = self._opt_init(model)
        step0 = restored if start_step is None else start_step
        self._preempted = False
        previous = self._install_sigterm()
        self.watchdog.start()
        it = iter(batches)
        t_train0 = time.time()
        try:
            for step in range(step0, step0 + steps):
                batch = next(it)
                state = batch.get("_state")
                batch = to_device(batch, self.device)
                t0 = time.time()
                model, opt_state, metrics = self._step(model, opt_state, batch)
                loss = float(metrics["loss"])           # waits for the step
                dt = time.time() - t0
                self.watchdog.step(step, dt)

                last = step == step0 + steps - 1
                if step % self.cfg.log_every == 0 or last:
                    m = {k: float(v) for k, v in metrics.items()}
                    m.update(loss=loss, step=step, step_time_s=dt)
                    self.metrics_history.append(m)
                    print(f"step {step:4d}  loss {loss:.5f}  grad_norm "
                          f"{m.get('grad_norm', 0.0):.4f}  lr {m['lr']:.2e}  "
                          f"{dt * 1e3:.0f} ms", flush=True)
                if self.ckpt and step > step0 and (step % self.cfg.ckpt_every == 0
                                                   or self._preempted or last):
                    self.ckpt.save(step, {"params": dict(model.named_parameters()),
                                          "opt": opt_state},
                                   extra={"data_state": state} if state else None,
                                   block=self._preempted)
                    if self._preempted:
                        print(f"preempted: state saved at step {step}", flush=True)
                        break
        finally:
            self.watchdog.stop()
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)
            if self.ckpt:
                self.ckpt.wait()
            self.wall_time = time.time() - t_train0
        return model, opt_state
