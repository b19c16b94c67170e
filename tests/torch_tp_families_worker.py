"""The ranks of ``tests/test_torch_tensor_parallel_families.py`` (not a
test module).

:func:`main` runs in each spawned CPU process: it joins a ``gloo`` group
of 2 or 4 ranks and trains the VLM, encoder-decoder, SSM and hybrid smoke
configs with ``runtime.Trainer(mesh=...)`` on the inputs the test module
wrote, recording the weights of every dense product, the widths of every
mamba scan and the bytes a rank holds; on 2 ranks it also runs the two
pieces of the split that are new (a column-cut ``Dense`` with a whole
bias, the gated norm's statistic summed over ``model``) against their
whole forms, and a step where one rank rounds a whole weight's gradient
otherwise.  It writes this rank's results to
``out_dir/rank<r>_of<world>.pkl`` and imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import datetime
import functools
import os
import pickle
import time
import traceback
import warnings
from unittest import mock

import torch
import torch.distributed as dist

import torch_dist_train_worker as W
import torch_tp_worker as TP

# run → (arch, smoke config fields, world size, batches key, from JAX's
# parameters); the SSM and hybrid runs start from the port's seed-0 weights
RUNS = {"1x2_vlm": ("llava-next-34b", {}, 2, "vlm", True),
        "1x2_encdec": ("seamless-m4t-medium", {}, 2, "encdec", True),
        "1x2_ssm": ("mamba2-1.3b", {}, 2, "lm", False),
        "1x2_hybrid": ("jamba-1.5-large-398b", {}, 2, "lm", False),
        "1x4_vlm": ("llava-next-34b", {}, 4, "vlm", True),
        "1x4_encdec_vocab": ("seamless-m4t-medium", {"vocab_size": 510}, 4, "encdec_vocab",
                             True)}
# seamless with a vocabulary that divides 2 ranks and not 4: tok_embed
# and lm_head stay whole on a 4-way axis (the warning), the layers split
VOCAB_RUN = "1x4_encdec_vocab"


def api_of(run):
    arch, scaled, *_ = RUNS[run]
    return W.smoke_api(arch, **scaled)


@contextlib.contextmanager
def record_scans(seen: set):
    """The widths each mamba layer's scan ran on: (the convolution's
    channels, the gated norm's width)."""
    from repro_torch.models import mamba2
    conv, gated = mamba2._conv_train, mamba2._gated
    width = {}

    def rec_conv(w, b, u):
        width["conv"] = w.shape[-1]
        return conv(w, b, u)

    def rec_gated(g, *a, **kw):
        seen.add((width.pop("conv"), g.shape[0]))
        return gated(g, *a, **kw)
    with mock.patch.object(mamba2, "_conv_train", rec_conv), \
            mock.patch.object(mamba2, "_gated", rec_gated):
        yield


def _run(run, data, mesh) -> dict:
    arch, _, _, key, from_jax = RUNS[run]
    scans: set = set()
    with record_scans(scans):
        out = TP._fit_case(api_of(run), data[f"{key}_params"] if from_jax else None,
                           data[f"{key}_batches"], mesh, spy=True, keep_grads=not from_jax)
    out["scans"] = sorted(scans)
    return out


def _bias_case(mesh, data, out):
    """``layers.nn.column_dense`` on a ``Dense`` whose weight is cut on its
    output dim and whose bias stays whole, against ``dense`` on the whole
    layer: the output (this rank's columns) and the gradients of the input,
    the weight (this rank's rows) and the bias (whole, on every rank)."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.distributed.sharding import axis_rules
    from repro_torch.layers.nn import Dense, column_dense, dense
    ax = mesh.axis_group("model")
    x = torch.from_numpy(data["bias_x"])
    gy = torch.from_numpy(data["bias_gy"])
    layer = Dense(x.shape[-1], gy.shape[-1], bias=True,
                  generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        layer.b.copy_(torch.from_numpy(data["bias_b"]))
    xw = x.clone().requires_grad_()
    (dense(layer, xw) * gy).sum().backward()
    whole = {"y": W._np(dense(layer, x)), "x": W._np(xw.grad), "w": W._np(layer.w.grad),
             "b": W._np(layer.b.grad)}
    layer.zero_grad(set_to_none=True)
    n = gy.shape[-1] // ax.size
    layer.w.data = layer.w.data[ax.index * n:(ax.index + 1) * n].clone()
    tp.cut(layer.w, 0)
    xs = x.clone().requires_grad_()
    with axis_rules(mesh):
        y, = column_dense((layer,), xs)
        (y * gy[..., ax.index * n:(ax.index + 1) * n]).sum().backward()
    out["bias"] = {"whole": whole, "n": n, "y": W._np(y), "x": W._np(xs.grad),
                   "w": W._np(layer.w.grad), "b": W._np(layer.b.grad)}


def _statistic_case(mesh, data, out):
    """mamba's gated norm on this rank's heads, the sum of squares summed
    over ``model`` (``tensor_parallel.reduce_statistic``), against the
    whole norm: the output and the gradients of y, z and the gain; and the
    same with the sum's gradient passed as it is
    (``reduce_from_model``), which misses the other ranks' share."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models.mamba2 import _gated
    mcfg = W.smoke_api("mamba2-1.3b").mcfg
    ax = mesh.axis_group("model")
    y, z, g, gy = (torch.from_numpy(data[f"norm_{k}"]) for k in ("y", "z", "g", "gy"))

    def run(statistic, part):
        leaves = [t[..., part].clone().requires_grad_() for t in (y, z, g)]
        o = _gated(leaves[2], leaves[0], leaves[1], mcfg, torch.float32, statistic)
        (o * gy[..., part]).sum().backward()
        return {"out": W._np(o), **{k: W._np(t.grad) for k, t in zip("yzg", leaves)}}
    n = y.shape[-1] // ax.size
    mine = slice(ax.index * n, (ax.index + 1) * n)
    out["statistic"] = {"whole": run(None, slice(None)), "n": n,
                        "split": run(functools.partial(tp.reduce_statistic, ax), mine),
                        "identity": run(functools.partial(tp.reduce_from_model, ax), mine)}


def _agree_case(mesh, data, out):
    """tinyllama on (1, 2) where rank 1 computes the gradient of a weight
    every rank holds whole (``final_norm.g``) otherwise, as a GPU reduction
    may round it otherwise: two steps, then the parameters whose bits
    differ between the ranks."""
    from repro_torch.distributed import comm
    api = W.smoke_api("tinyllama-1.1b")
    tr = TP._trainer(api, mesh)
    model = api.init(0, device="cpu")
    if mesh.axis_group("model").index == 1:
        model.final_norm.g.register_hook(lambda g: g + 1e-3 * g.abs().max())
    model, _ = tr.fit(iter(data["lm_batches"]), steps=W.STEPS, model=model)
    params = {n: p.detach() for n, p in model.named_parameters()}
    out["agree"] = {"differ": [n for n, t in params.items()
                               if not all(torch.equal(x, t) for x in comm.all_gather(
                                   t.contiguous(), mesh.axis_group("model")))]}


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
        mesh = make_mesh((1, world), ("data", "model"))
        if world == 2:
            _bias_case(mesh, data, out)
            _statistic_case(mesh, data, out)
            _agree_case(mesh, data, out)
        for run, (_, _, size, _, _) in RUNS.items():
            if size != world:
                continue
            reset_replication_warnings()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out[run] = _run(run, data, mesh)
            out[run]["warnings"] = [str(w.message) for w in caught]
    except Exception:
        out["error"] = traceback.format_exc()
        raise
    finally:
        with open(os.path.join(out_dir, f"rank{rank}_of{world}.pkl"), "wb") as f:
            pickle.dump(out, f)
        if dist.is_initialized():
            dist.destroy_process_group()
