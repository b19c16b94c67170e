"""Checkpoints: an npz of a state's tensors beside a JSON manifest, written
by an async writer, published by an atomic rename, pruned to the last k.

Counterpart of ``repro/checkpoint/manager.py``, with its layout:

  <dir>/step_00000100.tmp/        (written, then renamed)
  <dir>/step_00000100/
      manifest.json               step, extra, each leaf's shape and dtype
      proc00.npz                  every leaf, keyed by its path

A state is a nested dict whose leaves are tensors or Python numbers (the
optimizer's step count); a leaf's key is its path joined by ``/``.  numpy
has no bfloat16, so a bf16 tensor is stored as its int16 bits, with
``bfloat16`` in the manifest, and restored bit for bit.  The
port updates parameters in place, where JAX arrays are immutable: so
``save`` copies every tensor to the host before it returns, and the
writer thread owns that copy.  ``restore`` fills the template's tensors in
place (the port keeps one copy of the weights) after checking each shape.
Over a mesh of ranks (``runtime.Trainer(mesh=...)``) the trainer gathers
the full state before a save and one rank writes it; ``restore(...,
take=)`` cuts each full leaf to this rank's part before it fills the
template, which is JAX's restore onto the shardings of another mesh.
"""

from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["CheckpointManager", "latest_step"]

_SEP = "/"


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{_SEP}{k}" if prefix else str(k)
        out.update(_flatten(v, key) if isinstance(v, dict) else {key: v})
    return out


def _unflatten_like(tree, flat: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{_SEP}{k}" if prefix else str(k)
        out[k] = _unflatten_like(v, flat, key) if isinstance(v, dict) else flat[key]
    return out


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A host copy of ``leaf`` that nothing else writes, and its dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    arr = np.array(leaf)                                # a Python number
    return arr, str(arr.dtype)


def latest_step(ckpt_dir) -> int | None:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in d.iterdir()
             if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp")]
    return max(steps) if steps else None


class CheckpointManager:
    def __init__(self, ckpt_dir, *, keep_last: int = 3, async_save: bool = True):
        self.dir = Path(ckpt_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self.save_count = 0

    # ---------------- save ----------------

    def save(self, step: int, state: dict, *, extra: dict | None = None,
             block: bool = False) -> None:
        """Snapshot ``state`` at ``step``.  Every leaf is copied to the host
        before this returns, so the caller may update its tensors in place
        while an async write runs."""
        self.wait()                                     # never two writes in flight
        host, dtypes = {}, {}
        for key, leaf in _flatten(state).items():
            host[key], dtypes[key] = _to_host(leaf)
        meta = {"step": int(step), "extra": extra or {},
                "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                           for k, v in host.items()},
                "time": time.time()}
        if self.async_save and not block:
            self._thread = threading.Thread(target=self._write_async,
                                            args=(step, host, meta), daemon=True)
            self._thread.start()
        else:
            self._write(step, host, meta)

    def _write_async(self, step: int, host: dict, meta: dict) -> None:
        try:
            self._write(step, host, meta)
        except Exception as e:                          # re-raised by wait()
            self._error = e

    def _write(self, step: int, host: dict, meta: dict) -> None:
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "proc00.npz", **host)
        (tmp / "manifest.json").write_text(json.dumps(meta))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                               # atomic publish
        self.save_count += 1
        self._prune()

    def wait(self) -> None:
        """Block until the write in flight, if any, is on disk; raise its
        error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _prune(self) -> None:
        steps = sorted(int(p.name.split("_")[1]) for p in self.dir.iterdir()
                       if p.is_dir() and p.name.startswith("step_")
                       and not p.name.endswith(".tmp"))
        for s in steps[:-self.keep_last]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ---------------- restore ----------------

    def restore(self, template: dict, *, step: int | None = None,
                take=None) -> tuple[dict, dict]:
        """Restore the checkpoint at ``step`` (default: the newest) into the
        structure of ``template``.  Tensor leaves are filled in place and
        returned, Python numbers come back as numbers of the template's
        type.  ``take(key, full)``, when given, returns the part of a
        tensor leaf's full saved value that the template holds.  Returns
        (state, manifest)."""
        if step is None:
            step = latest_step(self.dir)
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        meta = json.loads((d / "manifest.json").read_text())
        flat = {}
        with np.load(d / "proc00.npz") as data:
            for key, want in _flatten(template).items():
                if key not in meta["leaves"]:
                    raise KeyError(f"{key}: not in the checkpoint at step {step}")
                arr = data[key]
                if meta["leaves"][key]["dtype"] == "bfloat16":
                    arr = torch.from_numpy(arr).view(torch.bfloat16)
                if take is not None and isinstance(want, torch.Tensor):
                    arr = take(key, torch.as_tensor(arr))
                shape = tuple(want.shape) if hasattr(want, "shape") else ()
                if tuple(arr.shape) != shape:
                    raise ValueError(f"{key}: checkpoint {tuple(arr.shape)} != "
                                     f"template {shape}")
                if isinstance(want, torch.Tensor):
                    with torch.no_grad():
                        want.copy_(torch.as_tensor(arr))
                    flat[key] = want
                else:
                    flat[key] = type(want)(np.asarray(arr).item())
        return _unflatten_like(template, flat), meta
