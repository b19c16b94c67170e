"""The training loop: the train step with periodic async checkpoints, a
save on SIGTERM, a straggler watchdog, resume, and training across the
ranks of a mesh.

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

With ``mesh`` (a ``launch.mesh.Mesh`` over the ranks of an initialised
process group; every rank runs the same ``Trainer`` on the same
batches), the layouts of ``distributed/params.py`` are realised so, as
PyTorch has no GSPMD to turn them into a partitioned program:

* Data parallelism.  Each rank takes its slice of the global batch along
  dim 0, by ``batch_shardings`` over ``pod`` / ``data``.  A packed
  point-cloud batch (an ``offsets`` key) has no batch dim: its samples are
  split whole (``ring.plan_segments`` on the host offsets) and re-packed,
  never its rows.  The step is ``make_train_step``, run under
  ``sharding.axis_rules`` (the ``rules`` given, then ``batch`` on the axes
  the batch is split over); there it sums the gradients, the loss and the
  metrics over the data ranks in rank order (``sharding.batch_total``), so
  every rank holds the same bits.
* Megatron's compute over ``model`` (``distributed/tensor_parallel.py``),
  in every family.  Each weight that ``param_shardings`` cuts over
  ``model`` is held as this rank's part of it, during the step and between
  the steps of a ``fit``, and the rank computes only with that part: wq /
  wk / wv, gate / up, fc1, ``frontend_proj`` and ``lm_head`` are column
  products and wo, down, fc2 row products, so that it runs its own
  attention heads (``models.attention_layer.HeadSplit``: self-attention,
  and the encoder-decoder's cross-attention on its heads of the memory's
  K / V) and FFN columns; the embeddings are looked up on its vocabulary
  rows and the loss reduces the max, the sum of exponentials and the gold
  logit over ``model`` without gathering the logits; an MoE layer runs
  its own experts; a mamba layer all-gathers its in_proj outputs after
  the column product, runs the scan on its own heads (the gated norm's
  sum of squares summed over ``model``) and its out_proj as a row
  product.  The gradients, the data-axis sums and the AdamW moments then
  act on the parts.  Where a cut does not fall on whole heads (query
  heads, mamba's heads) or a vocabulary does not divide, that layer or
  table runs whole on every rank (JAX's replication fallback).
* Exact losses.  Under those rules the loss functions divide by counts
  taken over the whole batch (``batch_total`` again: the masked points,
  the unmasked tokens, the MoE router's load statistics), so the ranks'
  losses add up to the single-rank loss, and their gradients to its
  gradient.
* Layouts as ownership.  Each rank holds only its part of each AdamW
  moment, by ``opt_shardings`` (ZeRO-1 over the data axes, and the
  Megatron dims over ``model``), and updates the matching part of the
  parameter; the parts are then all-gathered over the data axes in rank
  order.  The global-norm clip reads the norm of the whole gradient: the
  squares of the parts cut over ``model`` are summed over it in rank
  order.  With ``mcfg.fsdp`` the parameters between the steps of a
  ``fit`` are kept as their parts by ``param_shardings`` and gathered
  over the data axes at the start of a step.  ``fit`` returns the whole
  parameters.
* Checkpoints.  A save gathers the full state on the main thread before
  the async write, and rank 0 writes it; a restore cuts this rank's parts
  of the full tensors under the current mesh, which may differ from the
  one that saved (JAX's elastic restore).
* SIGTERM.  The flag is agreed over the ranks every step (a max), so
  every rank saves the same step or none does.

``rules`` (logical axis → mesh axes) is accepted for the signature of
JAX's ``Trainer`` only, and changes no number, as in JAX: it is merged
into the step's ``axis_rules``, where JAX's rules steer only GSPMD's
layout of the activations (``constrain``, which returns its input here);
which weights are cut comes from ``param_shardings``, whatever the rules
say, and ``batch`` is always the axes the trainer splits the batch over.
Without a mesh everything is as on one card.
"""

from __future__ import annotations

import dataclasses
import signal
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.distributed import comm, ring, tensor_parallel
from repro_torch.distributed.params import (Spec, axis_coordinate, batch_shardings,
                                            full_tensor, local_part, opt_shardings,
                                            param_shardings)
from repro_torch.distributed.sharding import axis_rules
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import adamw_init, adamw_update, global_norm
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
    ``_``, such as the LM pipeline's ``_state``, stay behind, and a packed
    batch's ``offsets`` stay on the host (the varlen plans read them
    there)."""
    return {k: torch.as_tensor(v).to("cpu" if k == "offsets" else device)
            for k, v in batch.items() if not k.startswith("_")}


class Trainer:
    def __init__(self, api, cfg: TrainerConfig, *, mesh=None, rules=None, device="cuda"):
        self.api = api
        self.cfg = cfg
        self.mesh = mesh
        self.rules = dict(rules or {})
        self.device = torch.device(device)
        self.watchdog = Watchdog()
        self.ckpt = (CheckpointManager(cfg.ckpt_dir, keep_last=cfg.keep_last)
                     if cfg.ckpt_dir else None)
        self._preempted = False
        self.metrics_history: list[dict] = []
        self.wall_time = 0.0
        self.data_state = None
        self.p_sh = self.o_sh = None
        self._shapes: dict = {}
        self._held = None          # None: whole parameters; "model": tp parts; "fsdp"
        self._train_step = make_train_step(
            api, base_lr=cfg.base_lr, weight_decay=cfg.weight_decay,
            total_steps=cfg.total_steps, warmup_steps=cfg.warmup_steps,
            max_grad_norm=cfg.max_grad_norm,
            update=None if mesh is None else self._update_parts,
            grad_norm=None if mesh is None else self._grad_norm)
        self._step = self._train_step if mesh is None else self._mesh_step

    @property
    def is_writer(self) -> bool:
        """Whether this rank writes checkpoints and log lines (rank 0)."""
        return self.mesh is None or self.mesh.rank == 0

    # ------------------------------------------------------------------

    def init_state(self):
        """(model, opt_state): weights from ``cfg.seed`` on the trainer's
        device, zero AdamW moments in the config's ``opt_state_dtype`` (over
        a mesh: this rank's parts of them)."""
        model = self.api.init(self.cfg.seed, device=self.device)
        return model, self._opt_init(model)

    def _layouts(self, model) -> None:
        """The specs over the mesh: ``p_sh`` / ``o_sh`` (``param_shardings``
        / ``opt_shardings``) of the whole tensors, ``tp_sh`` the cut over
        ``model`` that the compute takes, and
        ``_rel_p`` / ``_rel_o`` the rest of ``p_sh`` / ``o_sh`` on a
        ``tp_sh`` part (of shape ``_part_shapes``)."""
        if self.mesh is None or self.p_sh is not None:
            return
        params = dict(model.named_parameters())       # whole here
        self._shapes = {n: tuple(p.shape) for n, p in params.items()}
        self.p_sh = param_shardings(params, self.mesh, zero1=self.api.mcfg.fsdp)
        self.o_sh = opt_shardings({"m": params, "v": params, "step": 0}, self.mesh)
        tp = param_shardings(params, self.mesh)
        self.tp_sh, self._rel_p, self._rel_o, self._part_shapes = {}, {}, {}, {}
        for n, shape in self._shapes.items():
            dim = tensor_parallel.model_dim(tp[n])
            self.tp_sh[n] = Spec(tuple(tensor_parallel.MODEL if i == dim else None
                                       for i in range(len(shape))))
            part = list(shape)
            if dim is not None:
                part[dim] //= self.mesh.shape[tensor_parallel.MODEL]
            self._part_shapes[n] = tuple(part)
            self._rel_p[n] = _without(self.p_sh[n], dim)
            self._rel_o[n] = _without(self.o_sh["m"][n], dim)

    def _opt_init(self, model) -> dict:
        dtype = getattr(torch, self.api.mcfg.opt_state_dtype)
        params = dict(model.named_parameters())
        if self.mesh is None:
            return adamw_init(params, state_dtype=dtype)
        self._layouts(model)
        return {k: {n: torch.zeros_like(local_part(p, self.o_sh[k][n], self.mesh),
                                        dtype=dtype) for n, p in params.items()}
                for k in ("m", "v")} | {"step": 0}

    def moment_bytes(self, opt_state) -> int:
        """Bytes of the AdamW moments this rank holds."""
        return sum(t.numel() * t.element_size() for k in ("m", "v")
                   for t in opt_state[k].values())

    def maybe_restore(self, model, opt_state):
        """Resume from the newest checkpoint if there is one: the model's
        parameters and the moments (over a mesh: this rank's parts of the
        saved full tensors) are filled in place, and ``data_state``
        becomes the checkpoint's (the ``_state`` of the last batch it
        trained on; None without one), for the caller to restart its data
        from.  Returns (model, opt_state, the checkpoint's step index: the
        ``step0`` a resumed ``fit`` starts at)."""
        self.data_state = None
        if self.ckpt is None or latest_step(self.cfg.ckpt_dir) is None:
            return model, opt_state, 0
        take = None
        if self.mesh is not None:
            self._layouts(model)

            def take(key, full):
                group, *rest = key.split("/", 2)
                if group == "opt":
                    return local_part(full, self.o_sh[rest[0]][rest[1]], self.mesh)
                return full
        state, meta = self.ckpt.restore({"params": dict(model.named_parameters()),
                                         "opt": opt_state}, take=take)
        self.data_state = meta["extra"].get("data_state")
        return model, state["opt"], meta["step"]

    def full_state(self, model, opt_state) -> dict:
        """``{"params", "opt"}`` whole: over a mesh the parts are gathered
        (a collective: every rank calls it) and every rank gets them."""
        if self.mesh is None:
            return {"params": dict(model.named_parameters()), "opt": opt_state}
        params = {n: self._full_param(n, p) for n, p in model.named_parameters()}
        opt = {k: {n: full_tensor(t.contiguous(), self.o_sh[k][n], self._shapes[n], self.mesh)
                   for n, t in opt_state[k].items()} for k in ("m", "v")}
        opt["step"] = opt_state["step"]
        return {"params": params, "opt": opt}

    def _full_param(self, name, p):
        """The whole of a parameter held as its part (a collective)."""
        if self._held == "fsdp":
            p = full_tensor(p.data.contiguous(), self._rel_p[name], self._part_shapes[name],
                            self.mesh)
        if self._held is not None and tensor_parallel.model_dim(self.tp_sh[name]) is not None:
            p = full_tensor(p.data.contiguous(), self.tp_sh[name], self._shapes[name],
                            self.mesh)
        return p

    def hold(self, model, held) -> None:
        """Keep ``model``'s parameters as ``held`` says: None whole, "model"
        this rank's parts over ``model`` (``tp_sh``; each cut one marked by
        ``tensor_parallel.cut``), "fsdp" its parts by ``param_shardings``
        (a collective where parts are gathered: every rank calls it).  A
        gradient of the shape left behind is dropped."""
        if held == self._held:
            return
        for n, p in model.named_parameters():
            p.grad = None
            dim = tensor_parallel.model_dim(self.tp_sh[n])
            if self._held == "fsdp":            # → this rank's tp part
                p.data = full_tensor(p.data.contiguous(), self._rel_p[n],
                                     self._part_shapes[n], self.mesh)
            elif self._held is None and dim is not None:
                p.data = local_part(p.data, self.tp_sh[n], self.mesh).clone()
            if held is None:
                if dim is not None:
                    p.data = full_tensor(p.data.contiguous(), self.tp_sh[n],
                                         self._shapes[n], self.mesh)
                tensor_parallel.uncut(p)
                continue
            if dim is not None:
                tensor_parallel.cut(p, dim)
            if held == "fsdp":
                p.data = local_part(p.data, self._rel_p[n], self.mesh).clone()
        self._held = held

    def param_bytes(self, model) -> int:
        """Bytes of the parameters this rank holds now."""
        return sum(p.numel() * p.element_size() for p in model.parameters())

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

    def _agree(self, flag: bool) -> bool:
        """``flag`` or-ed over every rank of the mesh (a max over each axis
        in turn; also a barrier)."""
        if self.mesh is None:
            return flag
        t = torch.tensor([int(flag)], dtype=torch.int32, device=self.device)
        for a in self.mesh.axis_names:
            t = comm.all_reduce_max(t, self.mesh.axis_group(a))
        return bool(t.item())

    # ------------------------------------------------------------------
    # the step over a mesh

    def _data_axes(self, batch: dict) -> tuple:
        """The mesh axes the batch's dim 0 is cut over (``batch_shardings``),
        () where it is not."""
        if "offsets" in batch:                  # packed: samples over the DP axes
            return tuple(a for a in ("pod", "data") if self.mesh.shape.get(a, 1) > 1)
        specs = batch_shardings(batch, self.mesh)
        cuts = {s[0] for s in specs.values() if len(s)}
        if len(cuts) != 1:
            raise ValueError(f"the batch's leaves are cut differently along dim 0: {specs}")
        entry = cuts.pop()
        axes = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
        return tuple(a for a in axes if self.mesh.shape[a] > 1)

    def local_batch(self, batch: dict) -> tuple[dict, tuple]:
        """(this rank's part of the global ``batch`` on the trainer's
        device, the mesh axes it is cut over)."""
        batch = {k: v for k, v in batch.items() if not k.startswith("_")}
        batch = {k: v if k == "offsets" else torch.as_tensor(v) for k, v in batch.items()}
        axes = self._data_axes(batch)
        if not axes:
            return to_device(batch, self.device), axes
        c, n = axis_coordinate(self.mesh, axes)
        if "offsets" not in batch:
            return to_device({k: v[v.shape[0] // n * c:v.shape[0] // n * (c + 1)]
                              for k, v in batch.items()}, self.device), axes
        offsets = tuple(int(o) for o in np.asarray(batch["offsets"]))
        T = next(v.shape[1] for k, v in batch.items() if k != "offsets")
        plan = ring.plan_segments(offsets, n)
        idx, local_offsets, _, _ = ring.axis_layout(plan, offsets, T,
                                                    self.api.mcfg.bsa.ball_size)
        rows = torch.from_numpy(idx.reshape(n, -1)[c].astype(np.int64))
        out = {"offsets": torch.from_numpy(local_offsets[c].copy())}   # stays on the host
        for k, v in batch.items():
            if k != "offsets":                     # row T: a zero (False) padding row
                v = torch.cat([v, v.new_zeros((v.shape[0], 1, *v.shape[2:]))], 1)
                out[k] = v[:, rows].to(self.device)
        return out, axes

    def _mesh_step(self, model, opt_state, batch_axes):
        """``make_train_step`` on this rank's part of the batch, under rules
        that put ``batch`` on the axes it is cut over (the gradients, the
        loss's counts and the metrics summed over them), with the update of
        :meth:`_update_parts`."""
        batch, axes = batch_axes
        self.hold(model, "model")                 # the parts the compute takes
        with axis_rules(self.mesh, {**self.rules, "batch": axes or None}):
            out = self._train_step(model, opt_state, batch)
        return out

    def _grad_norm(self, grads: dict) -> torch.Tensor:
        """The norm of the whole (data-reduced) gradient: the squares of the
        parts cut over ``model`` summed over it in rank order.  First the
        gradients of the weights held whole on ``model`` become model rank
        0's (:meth:`_agree_whole`), so every rank clips and updates by the
        same numbers."""
        self._agree_whole(grads)
        split = {n for n in grads if tensor_parallel.model_dim(self.tp_sh[n]) is not None}
        if not split:
            return global_norm(list(grads.values()))
        rest = [g for n, g in grads.items() if n not in split]
        sq = comm.all_reduce_sum(global_norm([grads[n] for n in split]) ** 2,
                                 self.mesh.axis_group(tensor_parallel.MODEL))
        if rest:
            sq = sq + global_norm(rest) ** 2
        return torch.sqrt(sq)

    def _agree_whole(self, grads: dict) -> None:
        """Set (in place) the gradients of the weights that every rank of
        ``model`` holds whole to model rank 0's, one gather a dtype.  Each
        rank computes them on its own from the same numbers, but not always
        to the same bits on the card: shapenet's ``head.b`` (a sum over
        every point) came out apart between ranks in some runs on 4 ranks
        sharing one H100, and its weight with it."""
        if self.mesh.shape.get(tensor_parallel.MODEL, 1) <= 1:
            return
        ax = self.mesh.axis_group(tensor_parallel.MODEL)
        whole = [n for n in grads if tensor_parallel.model_dim(self.tp_sh[n]) is None]
        for dtype in dict.fromkeys(grads[n].dtype for n in whole):
            names = [n for n in whole if grads[n].dtype == dtype]
            flat = comm.all_gather(torch.cat([grads[n].reshape(-1) for n in names]), ax)[0]
            for n, part in zip(names, flat.split([grads[n].numel() for n in names])):
                grads[n].copy_(part.view(grads[n].shape))

    def _update_parts(self, params, grads, opt_state, lr):
        """AdamW on this rank's parts (``opt_shardings``) of the parameters
        and of the reduced, clipped gradients, both held as their ``model``
        parts; the parts are then gathered over the data axes in rank order
        (with ``mcfg.fsdp``, cut again by ``param_shardings``)."""
        mesh, rel_o, rel_p = self.mesh, self._rel_o, self._rel_p
        parts = {n: local_part(p.data, rel_o[n], mesh) for n, p in params.items()}
        opt_state = adamw_update(parts, {n: local_part(g, rel_o[n], mesh)
                                         for n, g in grads.items()},
                                 opt_state, lr=lr, weight_decay=self.cfg.weight_decay)
        fsdp = self.api.mcfg.fsdp
        for n, p in params.items():
            if fsdp and rel_p[n] == rel_o[n] and rel_p[n].owner == rel_o[n].owner:
                p.data = parts[n].clone()
                continue
            full = full_tensor(parts[n].contiguous(), rel_o[n], p.shape, mesh)
            if fsdp:
                p.data = local_part(full, rel_p[n], mesh).clone()
            else:
                p.data.copy_(full)
        if fsdp:
            self._held = "fsdp"
        return opt_state

    # ------------------------------------------------------------------

    def fit(self, batches, *, steps: int, model=None, opt_state=None,
            start_step: int | None = None):
        """Run ``steps`` optimizer steps over ``batches`` (an iterator of
        dicts of numpy arrays or tensors; over a mesh every rank gets the
        same global batches).  Without ``model``, it starts from
        ``init_state`` and the newest checkpoint.  Returns (model,
        opt_state)."""
        if model is None:
            model, opt_state = self.init_state()
            model, opt_state, restored = self.maybe_restore(model, opt_state)
        else:
            restored = 0
            if opt_state is None:
                opt_state = self._opt_init(model)
        self._layouts(model)
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
                batch = (to_device(batch, self.device) if self.mesh is None
                         else self.local_batch(batch))
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
                    if self.is_writer:
                        print(f"step {step:4d}  loss {loss:.5f}  grad_norm "
                              f"{m.get('grad_norm', 0.0):.4f}  lr {m['lr']:.2e}  "
                              f"{dt * 1e3:.0f} ms", flush=True)
                preempted = self._agree(self._preempted)
                if self.ckpt and step > step0 and (step % self.cfg.ckpt_every == 0
                                                   or preempted or last):
                    full = self.full_state(model, opt_state)
                    if self.is_writer:
                        self.ckpt.save(step, full,
                                       extra={"data_state": state} if state else None,
                                       block=preempted)
                    if preempted:
                        if self.is_writer:
                            print(f"preempted: state saved at step {step}", flush=True)
                        break
        finally:
            self.watchdog.stop()
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)
            if self.ckpt:
                self.ckpt.wait()
            self.wall_time = time.time() - t_train0
        if self.mesh is not None:
            self.hold(model, None)                # whole parameters to the caller
        self._agree(False)                        # every rank past the last write
        return model, opt_state


def _without(spec: Spec, dim) -> Spec:
    """``spec`` less its cut of ``dim`` (over ``model``): the same layout on
    a tensor that holds only this rank's ``model`` part of that dim."""
    if dim is None:
        return spec
    return Spec(tuple(None if i == dim else e for i, e in enumerate(spec)), spec.owner)
