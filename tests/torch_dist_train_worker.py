"""The ranks of ``tests/test_torch_dist_train.py`` (not a test module).

:func:`main` runs in each of the test module's spawned CPU processes: it
joins a ``gloo`` group of 4, runs every multi-rank case of the port's
training layer on the inputs the test module wrote (numpy arrays and JAX
parameter trees as numpy), and writes this rank's results to
``out_dir/rank<r>.pkl``.  It imports nothing of JAX, so the ranks start
fast; the test module holds the results against the JAX package and the
single-rank port.
"""

from __future__ import annotations

import datetime
import os
import pickle
import random
import socket
import threading
import traceback

import torch
import torch.distributed as dist

WORLD = 4
STEPS = 2
TRAIN = dict(base_lr=1e-3, weight_decay=0.01, total_steps=10, warmup_steps=1, log_every=1)
# the trainer cases: (arch, (B, N) of the global batches)
ARCHS = {"padded": ("shapenet-bsa", (4, 128)), "packed": ("shapenet-bsa", None),
         "dense": ("tinyllama-1.1b", (4, 64)), "moe": ("qwen2-moe-a2.7b", (4, 64))}
PACKED_SIZES = (90, 64, 120, 30)            # the packed batch's clouds (ball 32)
PACKED_PAD = 384
PIPE = dict(S=4, n_micro=8, B=2, d=16)
COMPRESS_N = 1061                           # 4 blocks of 256 and a ragged tail
LINEAR = dict(B=16, d_in=8, d_out=4)
REMAT_SEQ = 128


def _np(t):
    return t.detach().float().cpu().numpy().copy()


def smoke_api(arch, **scaled):
    from repro_torch.configs import get_config
    from repro_torch.configs.reduce import smoke_config
    from repro_torch.models.api import model_api
    cfg = smoke_config(get_config(arch))
    return model_api(cfg.scaled(**scaled) if scaled else cfg)


def jax_model(api, tree):
    """The port's model holding the JAX parameters ``tree`` (numpy)."""
    from repro_torch.convert import params_from_jax
    return params_from_jax(tree, api.init(0, device="cpu"))


def _trainer_cases(data, mesh, out):
    from repro_torch.runtime import Trainer, TrainerConfig
    for case, (arch, _) in ARCHS.items():
        api = smoke_api(arch)
        tr = Trainer(api, TrainerConfig(**TRAIN), mesh=mesh, device="cpu")
        model, opt = tr.fit(iter(data[f"{case}_batches"]), steps=STEPS,
                            model=jax_model(api, data[f"{case}_params"]))
        full = tr.full_state(model, opt)
        out[f"trainer_{case}"] = {
            "loss": [m["loss"] for m in tr.metrics_history],
            "grad_norm": [m["grad_norm"] for m in tr.metrics_history],
            "params": {n: _np(p) for n, p in model.named_parameters()},
            "m": {n: _np(t) for n, t in full["opt"]["m"].items()},
            "moment_bytes": tr.moment_bytes(opt), "step": opt["step"]}


def _fsdp_case(data, mesh, out):
    """``mcfg.fsdp``: the parameters kept as their parts between steps."""
    from repro_torch.runtime import Trainer, TrainerConfig
    api = smoke_api("shapenet-bsa", fsdp=True)
    tr = Trainer(api, TrainerConfig(**TRAIN), mesh=mesh, device="cpu")
    cut = []
    step = tr._mesh_step

    def spy(model, opt_state, batch):
        res = step(model, opt_state, batch)
        cut.append(sum(p.numel() for p in model.parameters()))
        return res
    tr._step = spy
    model, _ = tr.fit(iter(data["padded_batches"]), steps=STEPS,
                      model=jax_model(api, data["padded_params"]))
    out["fsdp"] = {"loss": [m["loss"] for m in tr.metrics_history],
                   "params": {n: _np(p) for n, p in model.named_parameters()},
                   "numel_between_steps": cut,
                   "numel": sum(p.numel() for p in model.parameters())}


def _elastic_case(data, mesh, out, ckpt):
    """Save on (2, 2) at the last of two steps, restore on (4,) and step."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import Trainer, TrainerConfig
    api = smoke_api("shapenet-bsa")
    cfg = TrainerConfig(**TRAIN, ckpt_dir=ckpt)
    tr = Trainer(api, cfg, mesh=mesh, device="cpu")
    tr.fit(iter(data["padded_batches"]), steps=STEPS, model=jax_model(api, data["padded_params"]))
    flat = make_mesh((WORLD,), ("data",))
    again = Trainer(api, cfg, mesh=flat, device="cpu")
    model, opt = again.init_state()
    model, opt, step0 = again.maybe_restore(model, opt)
    restored = {"step0": step0, "opt_step": opt["step"],
                "moment_shapes": {n: tuple(t.shape) for n, t in opt["m"].items()}}
    model, opt = again.fit(iter(data["resume_batches"]), steps=1, model=model,
                           opt_state=opt, start_step=step0)
    out["elastic"] = {**restored, "loss": [m["loss"] for m in again.metrics_history],
                      "params": {n: _np(p) for n, p in model.named_parameters()}}


def _pipeline_case(data, out):
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((PIPE["S"],), ("stage",))
    params = {"w": torch.from_numpy(data["pipe_w"]).requires_grad_(),
              "b": torch.from_numpy(data["pipe_b"]).requires_grad_()}
    x = torch.from_numpy(data["pipe_x"]).requires_grad_()

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])
    y = pipeline_apply(stage_fn, params, x, mesh=mesh)
    (y * torch.from_numpy(data["pipe_cot"])).sum().backward()
    out["pipeline"] = {"out": _np(y), "dw": _np(params["w"].grad),
                       "db": _np(params["b"].grad), "dx": _np(x.grad)}


def _compress_case(data, out):
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import compress
    mesh = make_local_mesh(axis="pod")
    ax = mesh.axis_group("pod")
    r = ax.index
    g, err = torch.from_numpy(data["cmp_g"][r]), torch.from_numpy(data["cmp_err"][r])
    total, resid = compress.compressed_psum(g, err, ax)
    q, scale, _ = compress._quantize(g + err)
    res = {"total": _np(total), "resid": _np(resid), "q": q.numpy().copy(),
           "scale": _np(scale), "q_dtype": str(q.dtype)}

    class Linear(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.from_numpy(data["lin_w"]).clone())

    def loss_fn(model, batch):
        return ((batch["x"] @ model.w - batch["y"]) ** 2).mean(), {}
    fn = compress.make_compressed_grad_fn(loss_fn, mesh, axis_name="pod")
    model = Linear()
    err = {"w": torch.zeros_like(model.w)}
    batch = {"x": torch.from_numpy(data["lin_x"]), "y": torch.from_numpy(data["lin_y"])}
    for i in range(2):                          # the second step feeds the residual back
        loss, grads, err = fn(model, batch, err)
        res[f"fn{i}"] = {"loss": float(loss), "grad": _np(grads["w"]), "err": _np(err["w"])}
    out["compress"] = res


def _remat_case(data, mesh, out):
    """A ``"sharded"`` LM step with remat and its backward on another
    thread (where a CUDA backward runs), against remat off."""
    from repro_torch.core.backend import use_backend
    from repro_torch.distributed import mesh_context
    res = {}
    batch = {k: torch.from_numpy(v) for k, v in data["remat_batch"].items()}
    for remat in (True, False):
        api = smoke_api("tinyllama-1.1b", remat=remat)
        model = api.init(0, device="cpu")
        with mesh_context(mesh), use_backend("sharded"):
            loss, _ = api.loss(model, batch)
        errors = []

        def backward(loss=loss):
            try:
                loss.backward()
            except Exception as e:               # noqa: BLE001 (reported to the test)
                errors.append(f"{type(e).__name__}: {e}")
        if remat:
            worker = threading.Thread(target=backward)
            worker.start()
            worker.join()
        else:
            with mesh_context(mesh), use_backend("sharded"):
                backward()
        res[remat] = {"loss": float(loss.detach()), "errors": errors,
                      "grads": {n: _np(p.grad) for n, p in model.named_parameters()
                                if p.grad is not None}}
    out["remat"] = res


def _store_port() -> int:
    """A free localhost port below Linux's default ephemeral range
    (32768–60999): the ranks' own gloo connections take ephemeral ports,
    and one could take a port picked there before the store binds it."""
    rng = random.Random(os.getpid())
    for _ in range(200):
        port = rng.randrange(20000, 32768)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port
    raise RuntimeError("no free port in 20000-32767")


def _cli_case(out):
    """``launch.train --mesh 2x2 --distributed --device cpu`` in a process
    group of its own, started from torchrun's environment variables; rank 0
    picks the store's port just before and sends it to the others."""
    import contextlib
    import io
    from repro_torch.launch import train
    rank = dist.get_rank()
    port = torch.tensor([_store_port() if rank == 0 else 0])
    dist.broadcast(port, 0)
    port = int(port)
    dist.destroy_process_group()
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        loss = train.main(["--smoke", "--steps", "2", "--batch", "4", "--seq", "64",
                           "--device", "cpu", "--mesh", "2x2", "--distributed"])
    out["cli"] = {"loss": loss, "stdout": buf.getvalue(),
                  "group_left": dist.is_initialized()}


def main(rank: int, init_file: str, in_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    os.environ["REPRO_TORCH_SHARDED_INNER"] = "reference"
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=WORLD,
                            rank=rank, timeout=datetime.timedelta(seconds=120))
    out: dict = {}
    try:
        from repro_torch.launch.mesh import make_local_mesh, make_mesh
        with open(in_path, "rb") as f:
            data = pickle.load(f)                  # written by the test module
        mesh = make_mesh((2, 2), ("data", "model"))
        _trainer_cases(data, mesh, out)
        _fsdp_case(data, mesh, out)
        _elastic_case(data, mesh, out, os.path.join(out_dir, "ckpt"))
        _pipeline_case(data, out)
        _compress_case(data, out)
        _remat_case(data, make_local_mesh(), out)
        _cli_case(out)
    except Exception:
        out["error"] = traceback.format_exc()
        raise
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        if dist.is_initialized():
            dist.destroy_process_group()
