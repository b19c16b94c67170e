"""The port stands alone and never drops to the CPU on its own.

* No file of ``src/repro_torch/`` nor ``chip_smoke.py`` imports ``jax`` or
  anything of ``repro``, and importing the port leaves ``jax`` out of
  ``sys.modules``.
* On CPU tensors no kernel counter moves, forward or backward (the plain
  versions run); asking
  for ``device="cuda"`` without a card raises instead of running on the CPU.
* The kernel backend raises for the ops whose kernels later slices bring.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_repro(path):
    bad = _imported_modules(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path.name} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.serving.engine, repro_torch.kernels.ref, "
            "repro_torch.convert, repro_torch.configs, "
            "repro_torch.launch.train_shapenet; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def _tiny():
    from repro_torch.configs import get_config
    from repro_torch.core.config import BSAConfig
    return get_config("shapenet-bsa").scaled(
        n_layers=1, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
        bsa=BSAConfig(ball_size=16, cmp_block=4, slc_block=4, top_k=2, group_size=4))


@pytest.mark.parametrize("backend", ["kernels", "auto", "reference"])
def test_cpu_runs_move_no_kernel_counter(backend):
    from repro_torch.core.backend import use_backend
    from repro_torch.kernels.common import COUNTERS, reset_counters
    from repro_torch.models.api import model_api
    import repro_torch.kernels.ops  # noqa: F401  (registers every counter)
    api = model_api(_tiny())
    model = api.init(0, device="cpu")
    batch = api.make_batch(np.random.default_rng(0), 2, 32, device="cpu")
    reset_counters()
    with use_backend(backend):
        out = api.forward(model, batch)
        loss, _ = api.loss(model, batch)
        loss.backward()                                # the backward plain versions
    assert out.shape == (2, 32, 1) and torch.isfinite(out).all()
    assert set(COUNTERS) == {"bta_fwd", "flash_fwd", "selection_fwd", "epilogue_fwd",
                             "bta_bwd", "flash_dq", "flash_dkv", "selection_bwd",
                             "epilogue_bwd"}
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


@pytest.mark.parametrize("op", ["local_window", "ball_varlen", "flash_varlen",
                                "selection_varlen", "local_window_varlen",
                                "paged_gather"])
def test_kernel_backend_raises_for_unported_ops(op):
    from repro_torch.core.backend import get_backend
    with pytest.raises(NotImplementedError):
        getattr(get_backend("kernels"), op)(torch.zeros(1, 16, 1, 16))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has the CUDA toolkit")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "kernels").exists()


def test_wrappers_refuse_mixed_or_odd_devices():
    from repro_torch.kernels import bta
    q = torch.zeros(2, 1, 16, 16)
    kv = torch.zeros(2, 16, 16)
    bias = torch.zeros(2, 16, device="meta")
    with pytest.raises(ValueError):
        bta.ball_attention_fwd(q, kv, kv, bias, ball_size=16, n_heads=1)
