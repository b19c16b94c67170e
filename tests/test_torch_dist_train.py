"""The port's distributed training layer against the JAX package:
``distributed/params.py``, ``runtime.Trainer(mesh=...)``, ``launch.train
--mesh / --distributed``, ``distributed/pipeline.py``,
``optim/compress.py``, and remat under a mesh.

* The layouts: every spec of ``param_shardings`` / ``opt_shardings`` /
  ``batch_shardings`` / ``cache_shardings`` equal to JAX's, mapped through
  the layer axis and the transposes (``params.py``'s docstring), for every
  config of ``ARCH_IDS`` and the point-cloud ones, at full size from shapes
  alone (the port's model built on the meta device), on a (2, 2) data ×
  model mesh, a (4,) data mesh and (2, 2) with ``tp=False``.
* Four CPU ranks in one ``gloo`` group, spawned once for the module
  (``torch_dist_train_worker.main``): ``Trainer(mesh=(2, 2))`` for two
  steps on the smoke ``shapenet-bsa`` (padded and packed), tinyllama and
  qwen2-moe, held to JAX's single-device ``make_train_step`` on the same
  weights at ``TOL`` and to the single-rank port within 1e-5, parameters
  equal in bits on every rank; ``mcfg.fsdp``; a save on (2, 2) resumed on
  (4,); ``launch.train --mesh 2x2 --distributed``; ``pipeline_apply`` and
  ``compressed_psum`` / ``make_compressed_grad_fn`` against JAX's, which
  run once in a subprocess with 4 fake devices (as ``tests/
  test_distributed.py`` runs them) while the ranks work; and a remat LM
  step under ``mesh_context`` whose backward runs on another thread.
"""

import contextlib
import dataclasses
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dist_train_worker as W
from repro.configs import ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs.reduce import smoke_config as j_smoke_config
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models.api import model_api as j_model_api
from repro.optim import adamw as j_adamw
from repro_torch.configs import get_config
from repro_torch.convert import named_to_jax
from repro_torch.core.balltree import pack_varlen
from repro_torch.data import lm_batches
from repro_torch.distributed import params as t_params
from repro_torch.launch import train as t_train
from repro_torch.models import api as t_api_module
from repro_torch.models.api import model_api
from repro_torch.runtime import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-3, rtol=1e-3)               # tests/test_torch_train.py's TOL
EXACT = 1e-5                                   # against the single-rank port
POINT_CLOUD = ("shapenet-bsa", "shapenet-bsa-no-group", "shapenet-bsa-group-cmp",
               "shapenet-full", "shapenet-erwin", "elasticity-bsa", "elasticity-full")
MESHES = {"2x2": ((2, 2), ("data", "model"), True), "4": ((4,), ("data",), True),
          "2x2_no_tp": ((2, 2), ("data", "model"), False)}
SPEC_B, SPEC_N = 8, 512                        # the batch and cache sizes of the spec checks


# ---------------------------------------------------------------------------
# the JAX side that needs several devices: one subprocess with 4 fake ones
# ---------------------------------------------------------------------------

JAX_SIDE = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.configs import get_config
from repro.distributed.params import (batch_shardings, cache_shardings, opt_shardings,
                                      param_shardings)
from repro.distributed.pipeline import pipeline_apply
from repro.launch.mesh import make_mesh
from repro.models.api import model_api
from repro.optim import adamw_init
from repro.optim.compress import _quantize, compressed_psum, make_compressed_grad_fn

archs, meshes, B, N, in_path, out_path = pickle.loads(bytes.fromhex(sys.argv[1]))
data = pickle.load(open(in_path, "rb"))

def key(path):
    return "/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path)

def specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {key(p): tuple(s.spec) for p, s in flat}

out = {"specs": {}}
for arch in archs:
    api = model_api(get_config(arch))
    pstruct = jax.eval_shape(api.init, jax.random.PRNGKey(0))
    ostruct = jax.eval_shape(lambda p: adamw_init(p), pstruct)
    bstruct = api.batch_specs(B, N)
    cstruct = None
    if arch.startswith("seamless"):
        cstruct = api.cache_specs(B, N)
    elif api.cache_init is not None:
        cstruct = jax.eval_shape(lambda: api.cache_init(B, N))
    for name, (shape, axes, tp) in meshes.items():
        mesh = make_mesh(shape, axes)
        got = {"param": specs(param_shardings(pstruct, mesh, tp=tp)),
               "param_zero1": specs(param_shardings(pstruct, mesh, zero1=True, tp=tp)),
               "opt": specs(opt_shardings(ostruct, mesh, tp=tp)),
               "batch": specs(batch_shardings(bstruct, mesh, full_dp=not tp)),
               "batch_sp": specs(batch_shardings(bstruct, mesh, seq_parallel=True))}
        for kind, sp in (("cache", False), ("cache_sp", True)):
            if cstruct is None:
                continue
            try:
                got[kind] = specs(cache_shardings(cstruct, mesh, seq_parallel=sp))
            except ValueError as e:      # a spec naming an axis the mesh lacks
                got[kind] = str(e)
        out["specs"][arch, name] = got

mesh = make_mesh((4,), ("stage",))
stage = {"w": jnp.asarray(data["pipe_w"]), "b": jnp.asarray(data["pipe_b"])}
with mesh:
    out["pipeline"] = np.asarray(pipeline_apply(
        lambda p, h: jnp.tanh(h @ p["w"] + p["b"]), stage, jnp.asarray(data["pipe_x"]),
        mesh=mesh))

pods = make_mesh((4,), ("pod",))
def f(gs, err):
    total, resid = compressed_psum(gs[0], err[0], "pod")
    return total[None], resid[None]
total, resid = shard_map(f, mesh=pods, in_specs=(P("pod"), P("pod")),
                         out_specs=(P("pod"), P("pod")), check_rep=False)(
    jnp.asarray(data["cmp_g"]), jnp.asarray(data["cmp_err"]))
quant = [_quantize(jnp.asarray(data["cmp_g"][r] + data["cmp_err"][r])) for r in range(4)]
out["compress"] = {"total": np.asarray(total), "resid": np.asarray(resid),
                   "q": [np.asarray(q) for q, _, _ in quant],
                   "scale": [np.asarray(s) for _, s, _ in quant]}

def loss_fn(params, batch):
    return jnp.mean((batch["x"] @ params["w"] - batch["y"]) ** 2), {}
fn = jax.jit(make_compressed_grad_fn(loss_fn, pods, axis_name="pod"))
params = {"w": jnp.asarray(data["lin_w"])}
batch = {"x": jnp.asarray(data["lin_x"]), "y": jnp.asarray(data["lin_y"])}
err = {"w": jnp.zeros_like(params["w"])}
for i in range(2):
    loss, grads, err = fn(params, batch, err)
    out[f"fn{i}"] = {"loss": float(loss), "grad": np.asarray(grads["w"]),
                     "err": np.asarray(err["w"])}
pickle.dump(out, open(out_path, "wb"))
"""


def _start_jax_side(in_path, out_path):
    meshes = {k: (s, a, tp) for k, (s, a, tp) in MESHES.items()}
    arg = pickle.dumps((list(ARCH_IDS) + list(POINT_CLOUD), meshes, SPEC_B, SPEC_N,
                        str(in_path), str(out_path))).hex()
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SIDE), arg],
        env={"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
             "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src"),
             "PATH": "/usr/bin:/bin"},
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


# ---------------------------------------------------------------------------
# inputs and the single-device references
# ---------------------------------------------------------------------------

def _smoke(arch):
    jcfg = j_smoke_config(j_get_config(arch))
    return jcfg.scaled(bsa=dataclasses.replace(jcfg.bsa, backend="jnp"))


def _batches(case, rng):
    arch, shape = W.ARCHS[case]
    n = W.STEPS + 1                             # the resume case takes one more
    if case == "packed":
        out = []
        for _ in range(n):
            rows = [rng.standard_normal((s, 8)).astype(np.float32) for s in W.PACKED_SIZES]
            packed, offsets, mask = pack_varlen(rows, 32, pad_to=W.PACKED_PAD, max_samples=6)
            out.append({"feats": packed[None, :, :7], "target": packed[None, :, 7:],
                        "mask": mask[None], "offsets": offsets})
        return out
    B, N = shape
    if arch == "shapenet-bsa":
        out = []
        for _ in range(n):
            mask = np.arange(N)[None] < rng.integers(N // 3, N + 1, (B, 1))
            out.append({"feats": rng.standard_normal((B, N, 7)).astype(np.float32),
                        "target": rng.standard_normal((B, N, 1)).astype(np.float32),
                        "mask": mask})
        return out
    out = [b for _, b in zip(range(n), lm_batches(vocab_size=512, batch_size=B, seq_len=N,
                                                  seed=int(rng.integers(1 << 30))))]
    for b in out:
        b.pop("_state", None)
        b["loss_mask"] = rng.random((B, N)) > 0.3
    return out


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    data = {}
    for i, case in enumerate(W.ARCHS):
        jp = j_model_api(_smoke(W.ARCHS[case][0])).init(jax.random.PRNGKey(i))
        data[f"{case}_params"] = jax.tree.map(np.asarray, jp)
        batches = _batches(case, rng)
        data[f"{case}_batches"] = batches[:W.STEPS]
        if case == "padded":
            data["resume_batches"] = batches[W.STEPS:]
    p = W.PIPE
    data.update(pipe_w=(rng.standard_normal((p["S"], p["d"], p["d"])) * 0.3).astype(np.float32),
                pipe_b=(rng.standard_normal((p["S"], p["d"])) * 0.1).astype(np.float32),
                pipe_x=rng.standard_normal((p["n_micro"], p["B"], p["d"])).astype(np.float32),
                pipe_cot=rng.standard_normal((p["n_micro"], p["B"], p["d"])).astype(np.float32),
                cmp_g=rng.standard_normal((W.WORLD, W.COMPRESS_N)).astype(np.float32),
                cmp_err=(rng.standard_normal((W.WORLD, W.COMPRESS_N)) * 0.01).astype(np.float32))
    lin = W.LINEAR
    data.update(lin_w=rng.standard_normal((lin["d_in"], lin["d_out"])).astype(np.float32),
                lin_x=rng.standard_normal((lin["B"], lin["d_in"])).astype(np.float32),
                lin_y=rng.standard_normal((lin["B"], lin["d_out"])).astype(np.float32))
    toks = rng.integers(0, 512, (2, W.REMAT_SEQ), dtype=np.int32)
    data["remat_batch"] = {"tokens": toks, "labels": toks}
    return data


def _jax_steps(case, data) -> dict:
    japi = j_model_api(_smoke(W.ARCHS[case][0]))
    kw = {k: v for k, v in W.TRAIN.items() if k != "log_every"}
    step = jax.jit(j_make_train_step(japi, **kw))
    params = jax.tree.map(jnp.asarray, data[f"{case}_params"])
    state = j_adamw.adamw_init(params)
    losses = []
    for b in data[f"{case}_batches"]:
        params, state, out = step(params, state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(out["loss"]))
    return {"loss": losses, "params": jax.tree.map(np.asarray, params)}


def _single_rank(case, data) -> dict:
    api = W.smoke_api(W.ARCHS[case][0])
    tr = Trainer(api, TrainerConfig(**W.TRAIN), device="cpu")
    model, _ = tr.fit(iter(data[f"{case}_batches"]), steps=W.STEPS,
                      model=W.jax_model(api, data[f"{case}_params"]))
    return {"loss": [m["loss"] for m in tr.metrics_history],
            "grad_norm": [m["grad_norm"] for m in tr.metrics_history],
            "params": {n: W._np(p) for n, p in model.named_parameters()}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the 4 ranks' results, a dict per rank; the references; the JAX
    subprocess's results; the scratch directory)."""
    tmp = tmp_path_factory.mktemp("train_ranks")
    data = _inputs()
    in_path = tmp / "in.pkl"
    in_path.write_bytes(pickle.dumps(data))
    jax_side = _start_jax_side(in_path, tmp / "jax.pkl")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=W.main, args=(r, str(tmp / "group"), str(in_path), str(tmp)))
             for r in range(W.WORLD)]
    for pr in procs:
        pr.start()
    try:
        refs = {case: {"jax": _jax_steps(case, data), "port": _single_rank(case, data)}
                for case in W.ARCHS}
        with contextlib.redirect_stdout(None):
            refs["cli"] = t_train.main(["--smoke", "--steps", "2", "--batch", "4", "--seq",
                                        "64", "--device", "cpu"])
        for pr in procs:
            pr.join(timeout=300)
        _, err = jax_side.communicate(timeout=600)
    finally:
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join()
        if jax_side.poll() is None:
            jax_side.kill()
    assert jax_side.returncode == 0, err[-3000:]
    results = []
    for r, pr in enumerate(procs):
        path = tmp / f"rank{r}.pkl"
        res = pickle.loads(path.read_bytes()) if path.exists() else {}
        assert pr.exitcode == 0 and "error" not in res, (
            f"rank {r} exited {pr.exitcode}: {res.get('error', 'no result')}")
        results.append(res)
    return results, refs, pickle.loads((tmp / "jax.pkl").read_bytes()), tmp, data


# ---------------------------------------------------------------------------
# the layouts, leaf for leaf against JAX's
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _shapes_only():
    """The port's init draws on the meta device: shapes, no memory."""
    randn = torch.randn

    def meta_randn(*shape, generator=None, device=None, **kw):
        return randn(*shape, device="meta", **kw)
    with mock.patch.object(torch, "randn", meta_randn), \
            mock.patch.object(t_api_module, "_generator", lambda seed, device="cpu":
                              torch.Generator()):
        yield


class _Mesh:
    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))


def _norm(spec, ndim):
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    return tuple(e if not isinstance(e, tuple) or len(e) > 1 else e[0] for e in spec)


STACKS = ("layers", "enc_layers", "dec_layers")


def _expected(jspecs: dict, port_shapes: dict, sizes: dict) -> dict:
    """JAX's specs (path → spec on JAX's layout) as the port's: a stacked
    leaf ``<stack>/<rest>`` becomes ``<stack>.<i>.<rest>`` for each layer
    i, its layer-axis entry an owner (``i · size / n``); a ``w`` is
    reversed."""
    out = {}
    for path, spec in jspecs.items():
        parts = path.split("/")
        at = next((i for i, p in enumerate(parts) if p in STACKS), None)
        flip = parts[-1] == "w"
        if at is None:
            shape = port_shapes[".".join(parts)]
            s = _norm(spec, len(shape))
            out[".".join(parts)] = (tuple(reversed(s)) if flip else s, None)
            continue
        prefix, rest = parts[:at + 1], parts[at + 1:]
        n = sum(1 for name in port_shapes
                if name.startswith(".".join(prefix) + ".")
                and name.split(".")[len(prefix) + 1:] == rest)
        for i in range(n):
            name = ".".join(prefix + [str(i)] + rest)
            s = _norm(spec, len(port_shapes[name]) + 1)
            layer, s = s[0], s[1:]
            owner = None
            if layer is not None:
                axes = layer if isinstance(layer, tuple) else (layer,)
                owner = (axes, i * int(np.prod([sizes[a] for a in axes])) // n)
            out[name] = (tuple(reversed(s)) if flip else s, owner)
    return out


def _got(specs: dict) -> dict:
    return {n: (tuple(s), s.owner) for n, s in specs.items()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCH_IDS) + list(POINT_CLOUD))
def test_layouts_match_jax(ranks, arch, mesh):
    jspecs = ranks[2]["specs"][arch, mesh]
    shape, axes, tp = MESHES[mesh]
    fake, sizes = _Mesh(shape, axes), dict(zip(axes, shape))
    api = model_api(get_config(arch))
    with _shapes_only():
        model = api.init(0, device="meta")
    named = dict(model.named_parameters())
    shapes = {n: tuple(p.shape) for n, p in named.items()}
    for kind, zero1 in (("param", False), ("param_zero1", True)):
        got = _got(t_params.param_shardings(named, fake, zero1=zero1, tp=tp))
        assert got == _expected(jspecs[kind], shapes, sizes), kind
    opt = t_params.opt_shardings({"m": named, "v": named, "step": 0}, fake, tp=tp)
    assert tuple(opt["step"]) == () and jspecs["opt"]["step"] == ()
    for k in ("m", "v"):
        want = _expected({p[2:]: s for p, s in jspecs["opt"].items() if p[:2] == k + "/"},
                         shapes, sizes)
        assert _got(opt[k]) == want, k
    batch = _batch_shapes(api.mcfg, SPEC_B, SPEC_N)
    for kind, kw in (("batch", dict(full_dp=not tp)), ("batch_sp", dict(seq_parallel=True))):
        got = {k: tuple(s) for k, s in t_params.batch_shardings(batch, fake, **kw).items()}
        assert got == {k: _norm(s, batch[k].ndim) for k, s in jspecs[kind].items()}, kind
    if "cache" in jspecs:
        caches = _cache_shapes(api, model, SPEC_B, SPEC_N)
        for kind, kw in (("cache", {}), ("cache_sp", dict(seq_parallel=True))):
            got = t_params.cache_shardings(caches, fake, **kw)
            if isinstance(jspecs[kind], str):
                # JAX puts mamba's state heads on "model" whatever the mesh,
                # and NamedSharding refuses a mesh without that axis; the
                # port's rule asks for a model axis of more than one rank
                assert "model" in jspecs[kind] and "model" not in sizes
                assert all("model" not in tuple(s) for period in got
                           for leaf in period.values() for s in leaf.values()), kind
                continue
            for path, spec in jspecs[kind].items():
                for i, period in enumerate(got):
                    leaf = period
                    for part in path.split("/"):
                        leaf = leaf[part]
                    assert tuple(leaf) == _norm(spec, len(leaf) + 1)[1:], (kind, path, i)


def _batch_shapes(mcfg, B, N) -> dict:
    """The port's batches, as ``make_batch`` lays them out."""
    def t(*shape):
        return torch.empty(shape, device="meta")
    if mcfg.family == "pointcloud":
        return {"feats": t(B, N, mcfg.in_dim), "target": t(B, N, mcfg.out_dim),
                "mask": t(B, N)}
    if mcfg.family == "vlm":
        S = N - mcfg.vision_tokens
        return {"tokens": t(B, S), "patch_embeds": t(B, mcfg.vision_tokens, mcfg.d_frontend),
                "labels": t(B, S)}
    if mcfg.family == "audio":
        Sd = max(N // mcfg.dec_ratio, 16)
        return {"frames": t(B, N, mcfg.d_frontend), "dec_tokens": t(B, Sd), "labels": t(B, Sd)}
    return {"tokens": t(B, N), "labels": t(B, N)}


def _cache_shapes(api, model, B, S):
    if api.mcfg.family == "audio":
        memory = torch.empty(B, S, api.mcfg.d_model, device="meta")
        return api.cache_init(B, S, params=model, memory=memory, device="meta")
    return api.cache_init(B, S, device="meta")


def test_zero1_owns_whole_layers_where_jax_cuts_the_layer_axis():
    """shapenet-bsa's gate vectors, (18, 8) stacked in JAX, get P('data',
    None) on (2, 2): layer i's (8,) vector belongs to data rank i·2/18."""
    api = model_api(get_config("shapenet-bsa"))
    with _shapes_only():
        named = dict(api.init(0, device="meta").named_parameters())
    specs = t_params.opt_shardings({"m": named, "v": named, "step": 0},
                                   _Mesh((2, 2), ("data", "model")))["m"]
    for i in range(18):
        for g in ("ball", "cmp", "slc"):
            s = specs[f"layers.{i}.attn.bsa.gates.{g}"]
            assert tuple(s) == (None,) and s.owner == (("data",), i * 2 // 18)
    assert specs["layers.3.attn.wq.w"] == ("model", "data")     # (d_out, d_in)


# ---------------------------------------------------------------------------
# training across 4 ranks
# ---------------------------------------------------------------------------

def _max_err(got: dict, want: dict) -> float:
    return max(float(np.abs(np.asarray(got[n]) - want[n]).max()) for n in want)


@pytest.mark.parametrize("case", list(W.ARCHS))
def test_trainer_on_a_mesh_matches_jax_and_one_rank(ranks, case):
    res, refs, _, _, _ = ranks
    got, port, jref = res[0][f"trainer_{case}"], refs[case]["port"], refs[case]["jax"]
    np.testing.assert_allclose(got["loss"], jref["loss"], **TOL)
    np.testing.assert_allclose(got["loss"], port["loss"], rtol=EXACT, atol=EXACT)
    np.testing.assert_allclose(got["grad_norm"], port["grad_norm"], rtol=EXACT, atol=EXACT)
    want = params_to_jax_np(got["params"])
    for name, arr in _flat(jref["params"]).items():
        np.testing.assert_allclose(want[name], arr, err_msg=name, **TOL)
    assert _max_err(got["params"], port["params"]) < EXACT
    assert got["step"] == W.STEPS
    for r in range(1, W.WORLD):                 # the same bits on every rank
        for name, arr in got["params"].items():
            np.testing.assert_array_equal(res[r][f"trainer_{case}"]["params"][name], arr,
                                          err_msg=f"{name} on rank {r}")
        for name, arr in got["m"].items():
            np.testing.assert_array_equal(res[r][f"trainer_{case}"]["m"][name], arr)


def params_to_jax_np(named: dict) -> dict:
    return _flat(named_to_jax({n: torch.from_numpy(a) for n, a in named.items()}))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def test_trainer_holds_only_its_parts_of_the_moments(ranks):
    res, _, _, _, data = ranks
    api = W.smoke_api("shapenet-bsa")
    whole = 2 * sum(p.numel() * 4 for p in api.init(0, device="cpu").parameters())
    for r in range(W.WORLD):
        mine = res[r]["trainer_padded"]["moment_bytes"]
        assert whole / 5 < mine < whole / 3, (r, mine, whole)   # ~¼: data × model
    assert sum(res[r]["trainer_padded"]["moment_bytes"] for r in range(W.WORLD)) >= whole


def test_fsdp_keeps_parameter_parts_between_steps(ranks):
    res, refs, _, _, _ = ranks
    got = res[0]["fsdp"]
    np.testing.assert_allclose(got["loss"], refs["padded"]["port"]["loss"], rtol=EXACT,
                               atol=EXACT)
    assert _max_err(got["params"], refs["padded"]["port"]["params"]) < EXACT
    assert all(n < got["numel"] / 2 for n in got["numel_between_steps"])


def test_resume_on_another_mesh_matches_one_rank(ranks):
    res, _, _, tmp, data = ranks
    got = res[0]["elastic"]
    assert got["step0"] == W.STEPS - 1 and got["opt_step"] == W.STEPS
    api = W.smoke_api("shapenet-bsa")
    tr = Trainer(api, TrainerConfig(**W.TRAIN, ckpt_dir=str(tmp / "ckpt")), device="cpu")
    model, opt = tr.init_state()
    model, opt, step0 = tr.maybe_restore(model, opt)
    model, _ = tr.fit(iter(data["resume_batches"]), steps=1, model=model, opt_state=opt,
                      start_step=step0)
    np.testing.assert_allclose(got["loss"], [m["loss"] for m in tr.metrics_history],
                               rtol=EXACT, atol=EXACT)
    assert _max_err(got["params"], {n: W._np(p) for n, p in model.named_parameters()}) < EXACT
    for r in range(1, W.WORLD):
        for name, arr in got["params"].items():
            np.testing.assert_array_equal(res[r]["elastic"]["params"][name], arr)
    # each of the 4 data ranks restored a quarter of a cut moment
    shapes = res[0]["elastic"]["moment_shapes"]
    assert shapes["layers.0.ffn.up.w"] == (api.mcfg.d_ff // 4, api.mcfg.d_model)


def test_launch_train_mesh_distributed(ranks):
    res, refs, _, _, _ = ranks
    got = [res[r]["cli"] for r in range(W.WORLD)]
    assert all(g["loss"] == got[0]["loss"] for g in got)
    np.testing.assert_allclose(got[0]["loss"], refs["cli"], rtol=EXACT, atol=EXACT)
    assert "mesh {'data': 2, 'model': 2}" in got[0]["stdout"]
    assert got[1]["stdout"] == "" and not any(g["group_left"] for g in got)


def test_mesh_flag_without_a_process_group_names_torchrun(capsys):
    with pytest.raises(SystemExit):
        t_train.main(["--smoke", "--device", "cpu", "--mesh", "2x2", "--steps", "1"])
    assert "torchrun" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# pipeline_apply and the compressed reduction
# ---------------------------------------------------------------------------

def test_pipeline_matches_jax(ranks):
    res, _, jx, _, data = ranks
    w, b, x, cot = (jnp.asarray(data[k]) for k in ("pipe_w", "pipe_b", "pipe_x", "pipe_cot"))

    def sequential(w, b, x):
        for s in range(w.shape[0]):
            x = jnp.tanh(x @ w[s] + b[s])
        return x
    want, vjp = jax.vjp(sequential, w, b, x)
    dw, db, dx = vjp(cot)
    for r in range(W.WORLD):
        got = res[r]["pipeline"]
        for key, ref in (("out", want), ("dw", dw), ("db", db), ("dx", dx)):
            np.testing.assert_allclose(got[key], np.asarray(ref), atol=EXACT, rtol=EXACT,
                                       err_msg=f"{key} on rank {r}")
        np.testing.assert_allclose(got["out"], jx["pipeline"], atol=EXACT, rtol=EXACT)


def test_compressed_psum_matches_jax(ranks):
    res, _, jx, _, data = ranks
    exact = data["cmp_g"].sum(0) + data["cmp_err"].sum(0)
    for r in range(W.WORLD):
        got = res[r]["compress"]
        assert got["q_dtype"] == "torch.int8"
        np.testing.assert_array_equal(got["q"], jx["compress"]["q"][r])    # int8 payload
        np.testing.assert_array_equal(got["scale"], jx["compress"]["scale"][r])
        np.testing.assert_allclose(got["total"], jx["compress"]["total"][r], atol=EXACT,
                                   rtol=EXACT)
        np.testing.assert_allclose(got["resid"], jx["compress"]["resid"][r], atol=EXACT,
                                   rtol=EXACT)
        assert np.abs(got["total"] - exact).max() / np.abs(exact).max() < 2e-2
        assert np.abs(got["resid"]).max() > 0


def test_compressed_grad_fn_matches_jax(ranks):
    """Two steps, the second feeding each pod's residual back.  JAX returns
    the residual as a replicated output that each device holds its own
    value of (``check_rep=False``): the host reads pod 0's, and the next
    call feeds every pod its own, as each rank here keeps its own."""
    res, _, jx, _, _ = ranks
    for r in range(W.WORLD):
        for i in range(2):
            got, want = res[r]["compress"][f"fn{i}"], jx[f"fn{i}"]
            np.testing.assert_allclose(got["loss"], want["loss"], atol=EXACT, rtol=EXACT)
            np.testing.assert_allclose(got["grad"], want["grad"], atol=EXACT, rtol=EXACT)
            if r == 0:
                np.testing.assert_allclose(got["err"], want["err"], atol=EXACT, rtol=EXACT)
            assert np.abs(got["err"]).max() > 0


# ---------------------------------------------------------------------------
# remat under a mesh
# ---------------------------------------------------------------------------

def test_remat_recompute_keeps_the_mesh(ranks):
    """The recompute of a checkpointed period runs on the thread of the
    backward (autograd's own on the card); it re-enters the forward's
    ``mesh_context`` there, else the sharded backend finds no mesh."""
    res = ranks[0]
    for r in range(W.WORLD):
        on, off = res[r]["remat"][True], res[r]["remat"][False]
        assert not on["errors"], on["errors"]
        assert on["loss"] == off["loss"]
        assert sorted(on["grads"]) == sorted(off["grads"])
        for name, g in off["grads"].items():
            np.testing.assert_allclose(on["grads"][name], g, atol=1e-6, rtol=1e-6,
                                       err_msg=name)
