"""The ranks of ``tests/test_torch_distributed.py`` (not a test module).

:func:`main` runs in each of the test module's spawned CPU processes: it
joins a ``gloo`` group, runs every sharded case of the port with the
``reference`` inner backend on the inputs the test module wrote (numpy
arrays and JAX parameter trees as numpy), and writes this rank's results to
``out_dir/rank<r>.pkl``.  It imports nothing of JAX, so the ranks start
fast; the test module holds the results against the JAX package.
"""

from __future__ import annotations

import datetime
import os
import pickle
import traceback
import warnings

import numpy as np
import torch
import torch.distributed as dist

SHAPES = dict(B=2, N=512, HQ=4, HKV=2, D=16)
CFG = dict(ball_size=64, local_window=64, cmp_block=8, top_k=4, group_size=8)
RING = dict(B=2, N=128, HQ=4, HKV=2, D=16, ELL=8, G=16, KSTAR=4)
VARLEN = dict(T=512, HQ=4, HKV=2, D=16, OFFSETS=(0, 256, 320, 448, 512), ELL=8, G=16,
              KSTAR=4, BALL=64, WINDOW=32)
PACKED_OFFSETS = (0, 256, 448, 512)
SERVE = dict(slots=2, max_len=128, new_tokens=6)


def _np(t):
    return t.detach().float().numpy().copy()


def _falls_back(records) -> int:
    return sum("falls back" in str(r.message) for r in records)


def _leaf(a):
    return torch.from_numpy(np.asarray(a)).clone().requires_grad_(True)


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(val)
    return out


def _bsa_cases(data, mesh, out):
    from repro_torch.convert import params_from_jax, params_to_jax
    from repro_torch.core import (BSAConfig, bsa_attention, bsa_attention_varlen,
                                  nsa_causal_attention, use_backend)
    from repro_torch.core.bsa import bsa_init
    from repro_torch.distributed import mesh_context

    s = SHAPES
    cfg = BSAConfig(**CFG)

    def params(tree):
        p = bsa_init(cfg, n_heads=s["HQ"], n_kv_heads=s["HKV"], head_dim=s["D"],
                     d_model=s["HQ"] * s["D"], generator=torch.Generator().manual_seed(0))
        return params_from_jax(tree, p)

    bp, npar = params(data["bparams"]), params(data["nparams"])
    mask = torch.from_numpy(data["mask"])
    for name, fn, p in (("bsa", bsa_attention, bp), ("nsa", nsa_causal_attention, npar)):
        for tag, m in (("dense", None), ("ragged", mask)):
            reps = 2 if tag == "dense" else 1            # two calls: equal bits
            for r in range(reps):
                p.zero_grad(set_to_none=True)
                q, k, v = (_leaf(data[x]) for x in ("q", "k", "v"))
                with warnings.catch_warnings(record=True) as rec:
                    warnings.simplefilter("always")
                    with mesh_context(mesh), use_backend("sharded"):
                        o = fn(p, q, k, v, cfg=cfg, mask=m)
                        ((o ** 2).sum() / s["N"]).backward()
                key = f"{name}_{tag}" + ("" if r == 0 else "_again")
                out[key] = {"out": _np(o), "dq": _np(q.grad), "dk": _np(k.grad),
                            "dv": _np(v.grad), "falls_back": _falls_back(rec),
                            **{f"p/{n}": a for n, a in
                               _flat(params_to_jax(p, grads=True)).items()}}

    # packed-varlen BSA: segment-sharded, no fallback
    q, k, v = (torch.from_numpy(data[x][0]) for x in ("q", "k", "v"))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        with mesh_context(mesh), use_backend("sharded"), torch.no_grad():
            o = bsa_attention_varlen(bp, q, k, v, cfg=cfg,
                                     offsets=np.asarray(PACKED_OFFSETS, np.int32))
    out["bsa_varlen"] = {"out": _np(o), "falls_back": _falls_back(rec)}

    # a mesh whose "data" axis has one rank: the backend passes straight to
    # the inner one
    from repro_torch.launch.mesh import make_mesh
    one = make_mesh((1, dist.get_world_size()), ("data", "model"))
    q, k, v = (torch.from_numpy(data[x]) for x in ("q", "k", "v"))
    with torch.no_grad():
        with mesh_context(one, axis="data"), use_backend("sharded"):
            sharded = bsa_attention(bp, q, k, v, cfg=cfg, mask=mask)
        with use_backend("reference"):
            ref = bsa_attention(bp, q, k, v, cfg=cfg, mask=mask)
    out["passthrough"] = {"out": _np(sharded), "reference": _np(ref),
                          "mesh_shape": dict(one.shape)}


def _fallback_case(data, mesh, out):
    from repro_torch.core.backend import get_backend
    from repro_torch.distributed import mesh_context
    from repro_torch.distributed.sharded_backend import reset_warnings

    reset_warnings()
    bk = get_backend("sharded")
    q, k, v = (torch.from_numpy(data[x][:, :192]) for x in ("q", "k", "v"))
    counts = []
    with mesh_context(mesh):
        for _ in range(2):                       # 192 / 4 = 48: not a ball multiple
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                o = bk.ball(q, k, v, None, ball_size=64)
            counts.append(_falls_back(rec))
    out["fallback"] = {"out": _np(o), "counts": counts}


def _ring_cases(data, mesh, out):
    from repro_torch.distributed import comm
    from repro_torch.distributed.ring import ring_flash, ring_selection
    from repro_torch.kernels.occupancy import ring_hop_live
    from repro_torch.numerics import key_padding_bias

    r = RING
    ax = mesh.axis_group("data")
    mask = torch.from_numpy(data["ring_mask"])
    w = torch.from_numpy(data["ring_w"])
    for causal in (True, False):
        live = ring_hop_live(ax.size, r["N"] // ax.size, causal=causal)
        q, k, v = (_leaf(data[f"ring_{x}"]) for x in ("q", "k", "v"))
        kb = key_padding_bias(mask, r["B"], r["N"])
        qs, ks, vs = comm.shard(ax, 1, q, k, v)
        o = comm.gather(ax, 1, ring_flash(qs, ks, vs, comm.local_slice(kb, ax, 1), axis=ax,
                                          causal=causal, live=live))
        (o * w).sum().backward()
        out[f"ring_flash_{causal}"] = {"out": _np(o), "dq": _np(q.grad), "dk": _np(k.grad),
                                       "dv": _np(v.grad), "live": int(live.sum())}
    sv = torch.from_numpy(data["ring_sv"])
    # "skewed": every pick on rank 0's slab, so each rank skips the
    # products of all hops but one (the rotations still run everywhere)
    for case, ti in (("ring_selection", data["ring_ti"]),
                     ("ring_selection_skewed", data["ring_ti"] % (r["N"] // r["ELL"] // 4))):
        q, k, v = (_leaf(data[f"ring_{x}"]) for x in ("q", "k", "v"))
        ti = torch.from_numpy(ti)
        qs, ks, vs = comm.shard(ax, 1, q, k, v)
        o = comm.gather(ax, 1, ring_selection(
            qs, ks, vs, comm.local_slice(ti, ax, 1), comm.local_slice(sv, ax, 1),
            comm.local_slice(mask, ax, 1), comm.local_slice(mask, ax, 1), axis=ax,
            block_size=r["ELL"], group_size=r["G"]))
        (o * w).sum().backward()
        out[case] = {"out": _np(o), "dq": _np(q.grad), "dk": _np(k.grad), "dv": _np(v.grad)}


def _varlen_cases(data, mesh, out):
    from repro_torch.core.backend import get_backend
    from repro_torch.distributed import mesh_context

    c = VARLEN
    sb = get_backend("sharded")
    offsets = np.asarray(c["OFFSETS"], np.int32)
    k_off = offsets // c["ELL"]
    q, k, v, m, kc, vc, blkv, ti, sv = (torch.from_numpy(data[f"vl_{x}"]) for x in
                                        ("q", "k", "v", "m", "kc", "vc", "blkv", "ti", "sv"))
    cases = {
        "ball": lambda b, q: b.ball_varlen(q, k, v, offsets, m, ball_size=c["BALL"]),
        "flash": lambda b, q: b.flash_varlen(q, kc, vc, offsets, k_off, key_valid=blkv),
        "window": lambda b, q: b.local_window_varlen(q, k, v, offsets, window=c["WINDOW"],
                                                     mask=m),
        "sel": lambda b, q: b.selection_varlen(q, k, v, ti, sv, offsets, m,
                                               block_size=c["ELL"], group_size=c["G"]),
    }
    with mesh_context(mesh):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            for name, fn in cases.items():
                with torch.no_grad():
                    out[f"varlen_{name}"] = {"out": _np(fn(sb, q))}
            ql = q.clone().requires_grad_(True)
            (cases["ball"](sb, ql) ** 2).sum().backward()
        out["varlen_ball"]["dq"] = _np(ql.grad)
        out["varlen_falls_back"] = _falls_back(rec)


def _serve_case(data, mesh, out):
    from repro_torch.configs import get_config
    from repro_torch.configs.reduce import smoke_config
    from repro_torch.convert import params_from_jax
    from repro_torch.distributed import mesh_context
    from repro_torch.distributed.sharded_backend import RING_DECODE_ENV
    from repro_torch.models.api import model_api
    from repro_torch.serving.engine import ServingEngine

    cfg = smoke_config(get_config("tinyllama-1.1b")).scaled(n_layers=1)
    api = model_api(cfg)
    model = params_from_jax(data["lm_params"], api.init(0, device="cpu"))
    prompts = data["prompts"]
    kw = dict(batch_slots=SERVE["slots"], max_len=SERVE["max_len"], paged=True)
    res = {"unsharded": ServingEngine(api, model, backend="reference", **kw).serve(
        prompts, max_new_tokens=SERVE["new_tokens"])}
    for ring_decode in ("1", "0"):
        os.environ[RING_DECODE_ENV] = ring_decode
        with mesh_context(mesh):
            eng = ServingEngine(api, model, backend="sharded", **kw)
        got = eng.serve(prompts, max_new_tokens=SERVE["new_tokens"])   # outside the block
        eng.kv.check()
        res[f"sharded_ring{ring_decode}"] = got
        res["num_blocks"], res["page"] = eng.num_blocks, eng.page
        res["pool_rows"] = int(eng.caches[0]["pos0"]["k"].shape[0])
    os.environ.pop(RING_DECODE_ENV)
    out["serve"] = res


def _comm_dtypes(mesh, out):
    """Every dtype the sharded ops move (bf16 and bool ride as same-width
    types gloo takes), through a rotation without wrap and a gather."""
    from repro_torch.distributed import comm
    ax = mesh.axis_group("data")
    got = {}
    for dt in (torch.float32, torch.bfloat16, torch.float16, torch.int32, torch.int64,
               torch.bool):
        x = (torch.arange(6).reshape(2, 3) + 10 * ax.index).to(dt)
        got[str(dt)] = ([_np(t) for t in comm.all_gather(x, ax)],
                        _np(comm.rotate_plain(x, ax, wrap=False)), str(x.dtype))
    out["comm_dtypes"] = got


def _mesh_errors(out):
    from repro_torch.launch.mesh import make_local_mesh
    try:
        make_local_mesh(dist.get_world_size() - 1)
        out["mesh_error"] = ""
    except RuntimeError as e:
        out["mesh_error"] = str(e)


def main(rank: int, world: int, init_file: str, in_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    os.environ["REPRO_TORCH_SHARDED_INNER"] = "reference"
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=120))
    out: dict = {}
    try:
        from repro_torch.launch.mesh import make_local_mesh
        with open(in_path, "rb") as f:
            data = pickle.load(f)                  # written by the test module
        mesh = make_local_mesh()
        _bsa_cases(data, mesh, out)
        _fallback_case(data, mesh, out)
        _ring_cases(data, mesh, out)
        _varlen_cases(data, mesh, out)
        _serve_case(data, mesh, out)
        _comm_dtypes(mesh, out)
        _mesh_errors(out)
    except Exception:
        out["error"] = traceback.format_exc()
        raise
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.destroy_process_group()


def quickstart(rank: int, init_file: str, out_dir: str) -> None:
    """The quickstart in a group of two CPU ranks (its section 7 runs)."""
    import contextlib
    import io
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=2,
                            rank=rank, timeout=datetime.timedelta(seconds=120))
    try:
        from repro_torch.launch import quickstart as qs
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            qs.main(["--device", "cpu"])
        with open(os.path.join(out_dir, f"quickstart{rank}.txt"), "w") as f:
            f.write(buf.getvalue())
    finally:
        dist.destroy_process_group()
