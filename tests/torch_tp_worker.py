"""The ranks of ``tests/test_torch_tensor_parallel.py`` (not a test module).

:func:`main` runs in each spawned CPU process: it joins a ``gloo`` group
of 2 or 4 ranks, trains with ``runtime.Trainer(mesh=...)`` on the inputs
the test module wrote, records what the tensor-parallel step computed
with (the weights of every dense and expert product, the bytes a rank
holds) and writes this rank's results to ``out_dir/rank<r>_of<world>.pkl``.
It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import time
import traceback
import warnings

import torch
import torch.distributed as dist
import torch.nn.functional as F

import torch_dist_train_worker as W

CASES = {"padded": "shapenet-bsa", "packed": "shapenet-bsa", "dense": "tinyllama-1.1b",
         "moe": "qwen2-moe-a2.7b"}
# shapenet-bsa with 2 heads of 16 on a 4-way axis: wq's 32 outputs divide,
# its heads do not (the replication fallback)
FALLBACK = dict(n_heads=2, n_kv_heads=2)
RULES = {"heads": None, "seq": ("data",)}
# held to the single-rank port only, from its seed-0 weights: arch,
# scaled fields and BSA overrides (group compression with φ = "mlp", whose
# fc1 / fc2 are cut over model but shared by the heads, and token gates,
# model), token gates, whose rows follow the heads, and 3 experts, which do
# not divide a 2-way axis: each expert's ffn dim is cut instead
SEED_CASES = {"ssm": ("mamba2-1.3b", {}, {}), "hybrid": ("jamba-1.5-large-398b", {}, {}),
              "mlp_phi": ("shapenet-bsa", {}, dict(group_compression=True, phi="mlp",
                                                   gate_mode="token")),
              "moe_inner": ("qwen2-moe-a2.7b", dict(n_experts=3, pad_experts_to=3), {})}


def seed_api(case):
    import dataclasses
    arch, scaled, bsa = SEED_CASES[case]
    api = W.smoke_api(arch, **scaled)
    if not bsa:
        return api
    from repro_torch.models.api import model_api
    return model_api(api.mcfg.scaled(bsa=dataclasses.replace(api.mcfg.bsa, **bsa)))


@contextlib.contextmanager
def record_products(model, seen: dict):
    """{parameter name: the shape it had in each F.linear / torch.bmm of
    the block} (the weights a rank's forward multiplies with)."""
    names = {id(p): n for n, p in model.named_parameters()}
    linear, bmm = F.linear, torch.bmm

    def note(w):
        if id(w) in names:
            seen.setdefault(names[id(w)], set()).add(tuple(w.shape))

    def rec_linear(x, w, *a, **kw):
        note(w)
        return linear(x, w, *a, **kw)

    def rec_bmm(a, b, *rest, **kw):
        note(b)
        return bmm(a, b, *rest, **kw)
    F.linear, torch.bmm = rec_linear, rec_bmm
    try:
        yield seen
    finally:
        F.linear, torch.bmm = linear, bmm


def _trainer(api, mesh, **kw):
    from repro_torch.runtime import Trainer, TrainerConfig
    return Trainer(api, TrainerConfig(**W.TRAIN, **kw.pop("cfg", {})), mesh=mesh,
                   device="cpu", **kw)


def _fit_case(api, params, batches, mesh, *, spy=False, keep_grads=False, **kw) -> dict:
    """Two steps on ``mesh`` from the JAX parameters ``params`` (None: the
    port's seed-0 weights); with ``spy``, the first step's products and the
    parameter bytes this rank held after each step; with ``keep_grads``,
    each step's (clipped) gradients, whole."""
    from repro_torch.distributed import tensor_parallel
    from repro_torch.distributed.params import full_tensor
    tr = _trainer(api, mesh, **kw)
    model = api.init(0, device="cpu") if params is None else W.jax_model(api, params)
    whole = {n: (tuple(p.shape), p.element_size()) for n, p in model.named_parameters()}
    seen, held, grads = {}, [], []
    step = tr._step

    def spied(model, opt_state, batch):
        ctx = record_products(model, seen) if spy and not held else contextlib.nullcontext()
        with ctx:
            res = step(model, opt_state, batch)
        held.append((tr.param_bytes(model), {n: tuple(p.shape)
                                             for n, p in model.named_parameters()}))
        if keep_grads:
            grads.append({n: W._np(p.grad if tensor_parallel.cut_dim(p) is None else full_tensor(
                p.grad.contiguous(), tr.tp_sh[n], tr._shapes[n], mesh))
                for n, p in model.named_parameters() if p.grad is not None})
        return res
    if spy or keep_grads:
        tr._step = spied
    model, opt = tr.fit(iter(batches), steps=W.STEPS, model=model)
    full = tr.full_state(model, opt)
    out = {"loss": [m["loss"] for m in tr.metrics_history],
           "grad_norm": [m["grad_norm"] for m in tr.metrics_history],
           "params": {n: W._np(p) for n, p in model.named_parameters()},
           "m": {n: W._np(t) for n, t in full["opt"]["m"].items()},
           "v": {n: W._np(t) for n, t in full["opt"]["v"].items()}}
    if spy:
        out.update(seen={n: sorted(s) for n, s in seen.items()}, held=held, whole=whole,
                   tp_dims={n: [i for i, e in enumerate(s) if e == "model"]
                            for n, s in tr.tp_sh.items()})
    if keep_grads:
        out["grads"] = grads
    return out


def _nll_case(mesh, data, out):
    """``vocab_parallel_nll`` on this rank's vocabulary slice of the logits
    against the whole logits."""
    from repro_torch.distributed.sharding import axis_rules
    from repro_torch.layers.losses import masked_mean_nll, vocab_parallel_nll
    ax = mesh.axis_group("model")
    logits = torch.from_numpy(data["nll_logits"]).requires_grad_()
    labels = torch.from_numpy(data["nll_labels"])
    mask = torch.from_numpy(data["nll_mask"])
    n = logits.shape[-1] // ax.size
    part = logits[..., ax.index * n:(ax.index + 1) * n]
    with axis_rules(mesh):
        nll = vocab_parallel_nll(part, labels, part=(ax, ax.index * n))
        loss = masked_mean_nll(part, labels, mask, part=(ax, ax.index * n))
    loss.backward()
    out["nll"] = {"nll": W._np(nll), "loss": float(loss), "grad": W._np(logits.grad),
                  "whole": W._np(vocab_parallel_nll(logits.detach(), labels))}


def _forward_case(mesh, data, out):
    """``lm_apply`` on this rank's parts (the vocabulary slices gathered)
    against the whole model's logits."""
    from repro_torch.distributed.sharding import axis_rules
    from repro_torch.models.transformer import lm_apply
    api = W.smoke_api("tinyllama-1.1b")
    tr = _trainer(api, mesh)
    model = W.jax_model(api, data["dense_params"])
    tokens = torch.from_numpy(data["dense_batches"][0]["tokens"])
    with torch.no_grad():
        whole, _ = lm_apply(model, tokens, mcfg=api.mcfg)
        tr._layouts(model)
        tr.hold(model, "model")
        with axis_rules(mesh):
            split, _ = lm_apply(model, tokens, mcfg=api.mcfg)
        tr.hold(model, None)
    out["forward"] = {"whole": W._np(whole), "split": W._np(split)}


def _resume_case(data, mesh, out, ckpt):
    """tinyllama saved on (2, 2) after two steps, restored on (4,) and
    stepped once."""
    from repro_torch.launch.mesh import make_mesh
    api = W.smoke_api("tinyllama-1.1b")
    tr = _trainer(api, mesh, cfg=dict(ckpt_dir=ckpt))
    tr.fit(iter(data["dense_batches"]), steps=W.STEPS, model=W.jax_model(api, data["dense_params"]))
    again = _trainer(api, make_mesh((4,), ("data",)), cfg=dict(ckpt_dir=ckpt))
    model, opt = again.init_state()
    model, opt, step0 = again.maybe_restore(model, opt)
    model, opt = again.fit(iter(data["dense_resume"]), steps=1, model=model, opt_state=opt,
                           start_step=step0)
    out["resume"] = {"step0": step0, "loss": [m["loss"] for m in again.metrics_history],
                     "params": {n: W._np(p) for n, p in model.named_parameters()}}


def main(rank: int, world: int, init_file: str, in_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=120))
    out: dict = {}
    try:
        from repro_torch.distributed.sharding import reset_replication_warnings
        from repro_torch.launch.mesh import make_mesh
        while not os.path.exists(in_path):         # written by the test module
            time.sleep(0.1)
        with open(in_path, "rb") as f:
            data = pickle.load(f)
        if world == 2:
            mesh = make_mesh((1, 2), ("data", "model"))
            for case, arch in CASES.items():
                out[f"1x2_{case}"] = _fit_case(W.smoke_api(arch), data[f"{case}_params"],
                                               data[f"{case}_batches"], mesh, spy=True)
            out["1x2_remat"] = _fit_case(W.smoke_api("tinyllama-1.1b", remat=True),
                                         data["dense_params"], data["dense_batches"], mesh)
            for case in SEED_CASES:
                batches = data["padded_batches" if case == "mlp_phi" else "dense_batches"]
                out[f"1x2_{case}"] = _fit_case(seed_api(case), None, batches, mesh, spy=True)
            _nll_case(mesh, data, out)
            _forward_case(mesh, data, out)
        else:
            mesh = make_mesh((2, 2), ("data", "model"))
            for case in ("dense", "moe"):
                out[f"2x2_{case}"] = _fit_case(W.smoke_api(CASES[case]), data[f"{case}_params"],
                                               data[f"{case}_batches"], mesh, spy=True)
            out["2x2_rules"] = _fit_case(W.smoke_api("shapenet-bsa"), data["padded_params"],
                                         data["padded_batches"], mesh, rules=RULES)
            _resume_case(data, mesh, out, os.path.join(out_dir, "ckpt"))
            mesh = make_mesh((1, 4), ("data", "model"))
            out["1x4_dense"] = _fit_case(W.smoke_api("tinyllama-1.1b"), data["dense_params"],
                                         data["dense_batches"], mesh, spy=True)
            reset_replication_warnings()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out["1x4_fallback"] = _fit_case(W.smoke_api("shapenet-bsa", **FALLBACK),
                                                data["fallback_params"],
                                                data["padded_batches"], mesh, spy=True)
            out["1x4_fallback"]["warnings"] = [str(w.message) for w in caught]
    except Exception:
        out["error"] = traceback.format_exc()
        raise
    finally:
        with open(os.path.join(out_dir, f"rank{rank}_of{world}.pkl"), "wb") as f:
            pickle.dump(out, f)
        if dist.is_initialized():
            dist.destroy_process_group()
