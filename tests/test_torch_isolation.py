"""The port stands alone and never drops to the CPU on its own.

* No file of ``src/repro_torch/`` nor ``chip_smoke.py`` imports ``jax`` or
  anything of ``repro``, and importing the port leaves ``jax`` out of
  ``sys.modules``; importing the models leaves the ``"sharded"`` backend
  unloaded.
* On CPU tensors no kernel counter moves, forward or backward (the plain
  versions run; the point-cloud model and the LM with remat); asking
  for ``device="cuda"`` without a card raises instead of running on the CPU.
* On CPU tensors the kernel backend answers the causal LM's ops
  (``local_window``, ``local_window_varlen``, ``paged_gather``) with the
  kernels' plain versions, equal to the reference backend; the built-in
  ``kernels`` / ``auto`` backends answer the packed-varlen ops with their
  own methods, never with the reference's.
* The kernel library's ctypes signatures match the C entry points of
  ``csrc/*.cu`` one for one.
"""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels._build import SIGNATURES

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
# modules the checks below must reach by name, whatever the glob finds
NAMED = ("configs/base.py", "kernels/local.py", "kernels/_build.py", "layers/losses.py",
         "data/lm.py", "data/__init__.py", "models/transformer.py", "models/api.py",
         "optim/adamw.py", "launch/steps.py", "launch/train.py", "core/__init__.py",
         "core/backend.py", "core/balltree.py", "configs/stablelm_1_6b.py",
         "configs/phi4_mini_3_8b.py", "configs/granite_20b.py", "checkpoint/manager.py",
         "runtime/trainer.py", "runtime/watchdog.py", "launch/quickstart.py",
         "launch/train_shapenet.py", "launch/serve.py", "distributed/params.py",
         "distributed/pipeline.py", "optim/compress.py", "distributed/tensor_parallel.py")


def _imported_modules(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_named_modules_are_checked():
    assert {ROOT / "src" / "repro_torch" / m for m in NAMED} <= set(PORT_FILES)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_repro(path):
    bad = _imported_modules(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path.name} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.serving.engine, repro_torch.kernels.ref, "
            "repro_torch.convert, repro_torch.configs, "
            "repro_torch.launch.train_shapenet, repro_torch.launch.serve, "
            "repro_torch.core.nsa_causal, repro_torch.models.transformer, "
            "repro_torch.serving.paged_cache, repro_torch.configs.reduce, "
            "repro_torch.kernels.local, repro_torch.kernels.paged, "
            "repro_torch.launch.train, repro_torch.layers.losses, repro_torch.data.lm, "
            "repro_torch.data, repro_torch.optim.adamw, repro_torch.core, "
            "repro_torch.checkpoint, repro_torch.runtime, repro_torch.launch.quickstart; "
            "repro_torch.configs.list_configs(); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_models_leave_the_sharded_backend_unloaded():
    """The models reach the distributed layer only through ``sharding``
    (remat's ``forward_context``, the losses' ``batch_total``) and
    ``tensor_parallel`` (the compute over ``model``, on ``comm``): importing
    them loads neither the ring nor the ``"sharded"`` backend, which
    ``core.backend`` registers on first use, and the package's names still
    resolve."""
    code = ("import sys, repro_torch.models.api, repro_torch.models.transformer, "
            "repro_torch.models.encdec, repro_torch.launch.steps; "
            "from repro_torch.core.backend import get_backend, list_backends; "
            "print(sorted(m for m in sys.modules if m.startswith('repro_torch.distributed.')), "
            "list_backends()); "
            "from repro_torch.distributed import mesh_context, sharding, sharded_backend; "
            "get_backend('sharded'); "
            "print(mesh_context is sharding.mesh_context is sharded_backend.mesh_context, "
            "list_backends())")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.splitlines() == [
        "['repro_torch.distributed.comm', 'repro_torch.distributed.sharding', "
        "'repro_torch.distributed.tensor_parallel'] ['kernels', 'reference']",
        "True ['kernels', 'reference', 'sharded']"]


def _tiny():
    from repro_torch.configs import get_config
    from repro_torch.core.config import BSAConfig
    return get_config("shapenet-bsa").scaled(
        n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
        bsa=BSAConfig(ball_size=16, cmp_block=4, slc_block=4, top_k=2, group_size=4))


@pytest.mark.parametrize("backend", ["kernels", "auto", "reference"])
def test_cpu_runs_move_no_kernel_counter(backend):
    from repro_torch.configs import get_config
    from repro_torch.configs.reduce import smoke_config
    from repro_torch.core.backend import use_backend
    from repro_torch.core.balltree import pack_varlen
    from repro_torch.kernels.common import COUNTERS, reset_counters
    from repro_torch.models.api import model_api
    import repro_torch.kernels.ops  # noqa: F401  (registers every counter)
    api = model_api(_tiny())
    model = api.init(0, device="cpu")
    batch = api.make_batch(np.random.default_rng(0), 2, 32, device="cpu")
    rows, offsets, mask = pack_varlen([np.ones((n, 8), np.float32) for n in (20, 9)], 16,
                                      max_samples=3)
    packed = {"feats": torch.from_numpy(rows[None, :, :7]),
              "target": torch.from_numpy(rows[None, :, 7:]),
              "mask": torch.from_numpy(mask[None]), "offsets": torch.from_numpy(offsets)}
    lm_api = model_api(smoke_config(get_config("tinyllama-1.1b")).scaled(remat=True))
    lm = lm_api.init(0, device="cpu")
    tokens = lm_api.make_batch(np.random.default_rng(0), 2, 64, device="cpu")
    reset_counters()
    with use_backend(backend):
        for b in (batch, packed):
            out = api.forward(model, b)
            loss, _ = api.loss(model, b)
            loss.backward()                            # the backward plain versions
            assert out.shape == b["mask"].shape + (1,) and torch.isfinite(out).all()
        loss, _ = lm_api.loss(lm, tokens)              # the LM, remat on
        loss.backward()
        assert torch.isfinite(loss)
    assert set(COUNTERS) == {"bta_fwd", "flash_fwd", "selection_fwd", "epilogue_fwd",
                             "bta_bwd", "flash_dq", "flash_dkv", "selection_bwd",
                             "selection_dq", "selection_dkv",
                             "epilogue_bwd", "varlen_fwd", "varlen_dq", "varlen_dkv",
                             "local_fwd", "local_dq", "local_dkv", "paged_gather",
                             "paged_gather_pair"}
    assert all(c.n == 0 for c in COUNTERS.values())


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the no-card behaviour is not observable")
    from repro_torch.models.api import model_api
    api = model_api(_tiny())
    with pytest.raises((RuntimeError, AssertionError)):
        api.init(0)                                    # default device is cuda
    with pytest.raises((RuntimeError, AssertionError)):
        api.make_batch(np.random.default_rng(0), 1, 32)


def _lm_op_args(op):
    """Inputs of the causal LM's backend ops, on the CPU: blocked local
    attention (GQA rep 2, a masked tail; packed: three samples at window
    multiples) and the paged row gather."""
    g = torch.Generator().manual_seed(0)
    if op == "paged_gather":
        return (torch.randn(40, 2, 16, generator=g),
                torch.randint(0, 40, (3, 7), generator=g)), {}
    if op == "local_window":
        mask = torch.ones(2, 64, dtype=torch.bool)
        mask[1, 50:] = False
        return (torch.randn(2, 64, 4, 16, generator=g), torch.randn(2, 64, 2, 16, generator=g),
                torch.randn(2, 64, 2, 16, generator=g)), dict(window=16, mask=mask)
    mask = torch.ones(64, dtype=torch.bool)
    mask[40:48] = False
    return (torch.randn(64, 4, 16, generator=g), torch.randn(64, 2, 16, generator=g),
            torch.randn(64, 2, 16, generator=g), np.array([0, 16, 48, 64], np.int32)), \
        dict(window=16, mask=mask)


@pytest.mark.parametrize("op", ["local_window", "local_window_varlen", "paged_gather"])
def test_kernel_backend_answers_lm_ops_on_cpu_like_the_reference(op):
    """The kernels backend on CPU tensors runs the kernels' plain versions:
    equal to the reference backend, and no kernel counter moves."""
    from repro_torch.core.backend import get_backend
    from repro_torch.kernels.common import COUNTERS, reset_counters
    args, kw = _lm_op_args(op)
    reset_counters()
    got = getattr(get_backend("kernels"), op)(*args, **kw)
    want = getattr(get_backend("reference"), op)(*args, **kw)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert all(c.n == 0 for c in COUNTERS.values())


@pytest.mark.parametrize("backend", ["kernels", "auto"])
@pytest.mark.parametrize("op", ["ball", "flash", "selection"])
def test_builtin_backends_resolve_varlen_ops_to_their_own(backend, op, monkeypatch):
    from repro_torch.core import backend as bk
    from repro_torch.kernels import ops
    fn = bk.get_varlen(bk.get_backend(backend), op)
    assert fn != getattr(bk.get_backend("reference"), f"{op}_varlen")
    # on a CUDA tensor the op reaches the kernel wrapper (spied here: this
    # machine may have no card), never the reference
    calls = []
    monkeypatch.setattr(ops, f"{op}_attention_varlen", lambda *a, **kw: calls.append(a))
    monkeypatch.setattr(bk.ReferenceBackend, f"{op}_varlen",
                        lambda *a, **kw: pytest.fail("reached the reference"))
    class OnCard:                                      # what "auto" reads of a tensor
        device = torch.device("cuda")

    n_args, kw = {"ball": (5, dict(ball_size=16)), "flash": (5, {}),
                  "selection": (7, dict(block_size=4, group_size=4))}[op]
    fn(OnCard(), *[None] * (n_args - 1), **kw)
    assert len(calls) == 1


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has the CUDA toolkit")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "kernels").exists()


def _c_entry_points() -> dict[str, list[str]]:
    from repro_torch.kernels import _build
    text = "".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu")))
    return {m.group(1): [a.strip() for a in m.group(2).split(",")]
            for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text)}


@pytest.mark.parametrize("name", sorted(SIGNATURES))
def test_build_signatures_match_the_c_entry_points(name):
    """Each ctypes signature names the C entry point's parameters one for
    one (a pointer as c_void_p, an int as c_int): a missing int shifts the
    stream pointer into an int and crashes only on the card."""
    import ctypes

    params = _c_entry_points()[name]
    assert SIGNATURES[name] == [ctypes.c_void_p if "*" in a else ctypes.c_int
                                       for a in params], params


def test_every_c_entry_point_has_a_signature():
    assert sorted(_c_entry_points()) == sorted(SIGNATURES)


def test_wrappers_refuse_mixed_or_odd_devices():
    from repro_torch.kernels import bta
    q = torch.zeros(2, 1, 16, 16)
    kv = torch.zeros(2, 16, 16)
    bias = torch.zeros(2, 16, device="meta")
    with pytest.raises(ValueError):
        bta.ball_attention_fwd(q, kv, kv, bias, ball_size=16, n_heads=1)
