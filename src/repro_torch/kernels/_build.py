"""Build the port's CUDA kernels into one shared library and load it.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a``; the objects are linked into one shared
library under ``build/kernels/`` at the repository root.  The library's
file name carries a hash of the sources and flags, so the build runs at
first use and again only when a source changes.  The library has a plain C
interface and is loaded with ``ctypes``: pointers and the stream go as
``c_void_p``, and every entry point returns ``cudaGetLastError()`` after
its launch (0 = success).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build", "load", "last_build"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v"]

P = ctypes.c_void_p
I = ctypes.c_int
# C signatures of the entry points (csrc/*.cu); every one returns an int
# carrying cudaGetLastError() (or cudaErrorInvalidValue for a head_dim
# that has no instantiation)
SIGNATURES = {
    # q, k, v, key_bias, live, o, lse, BH, rep, N, D, ball, n_heads, bf16, path
    # (0 rows, 1 fma, 2 mma), stream
    "bta_fwd": [P] * 7 + [I] * 8 + [P],
    # q, k, v, key_bias, q_valid, o, lse, BH, rep, N, L, D, n_heads,
    # causal, block_causal, ell, bf16, stream
    "flash_fwd": [P] * 7 + [I] * 10 + [P],
    # q, kb, vb, idx, tok_bias, o, lse, B, Hkv, G, M, NB, ell, k_star, D, bf16,
    # path (0 warp, 1 tiles, 2 groups), stream
    "selection_fwd": [P] * 7 + [I] * 10 + [P],
    # o1, o2, o3, g1, g2, g3, m, out, R, D, H, gs1, gs2, gs3, bf16, lanes (0 = the
    # warp kernel), stream
    "epilogue_fwd": [P] * 8 + [I] * 8 + [P],
    # q, k, v, key_bias, live, do, lse, delta, dq, dk, dv, BH, rep, N, D, ball,
    # n_heads, bf16, path (0 rows, 1 fma, 2 mma), stream
    "bta_bwd": [P] * 11 + [I] * 8 + [P],
    # q, k, v, key_bias, do, lse, delta, dq, BH, rep, N, L, D, n_heads, causal,
    # block_causal, ell, bf16, stream
    "flash_dq": [P] * 8 + [I] * 10 + [P],
    # q, k, v, key_bias, do, lse, delta, dk, dv, ws, BH, rep, N, L, D, n_heads,
    # causal, block_causal, ell, S, bf16, stream
    "flash_dkv": [P] * 10 + [I] * 11 + [P],
    # q, kb, vb, idx, tok_bias, do, lse, delta, rank, offsets, ws, dq, dkb, dvb, B,
    # Hkv, G, M, NB, ell, k_star, D, bf16, stream
    "selection_bwd": [P] * 14 + [I] * 9 + [P],
    # q, kb, vb, idx, tok_bias, do, lse, delta, dq, B, Hkv, G, M, NB, ell, k_star,
    # D, bf16, stream
    "selection_dq": [P] * 9 + [I] * 9 + [P],
    # q, kb, vb, idx, tok_bias, do, lse, delta, order, offsets, ws, dkb, dvb, B,
    # Hkv, G, M, NB, ell, k_star, D, bf16, stream
    "selection_dkv": [P] * 13 + [I] * 9 + [P],
    # o1, o2, o3, g1, g2, g3, m, do, do1, do2, do3, dg1, dg2, dg3, R, D, bf16,
    # lanes (0 = the warp kernel), stream
    "epilogue_bwd": [P] * 14 + [I] * 4 + [P],
    # q, k, v, key_bias, qseg, kseg, k_bounds, tiles, o, lse, H, rep, T, L, n_tiles, D,
    # bf16, stream
    "varlen_fwd": [P] * 10 + [I] * 7 + [P],
    # q, k, v, key_bias, qseg, kseg, q_bounds, k_bounds, do, lse, delta, tiles, dq, H,
    # rep, T, L, n_tiles, D, bf16, stream
    "varlen_dq": [P] * 13 + [I] * 7 + [P],
    # q, k, v, key_bias, qseg, kseg, q_bounds, k_bounds, do, lse, delta, tiles, ws,
    # dk, dv, H, rep, T, L, n_tiles, S, D, bf16, stream
    "varlen_dkv": [P] * 15 + [I] * 8 + [P],
    # q, k, v, key_bias, live, o, lse, BH, rep, N, D, window, n_heads, bf16, tiles,
    # stream
    "local_fwd": [P] * 7 + [I] * 8 + [P],
    # q, k, v, key_bias, live, do, lse, delta, dq, BH, rep, N, D, window, n_heads,
    # bf16, tiles, stream
    "local_dq": [P] * 9 + [I] * 8 + [P],
    # q, k, v, key_bias, live, do, lse, delta, dk, dv, BH, rep, N, D, window,
    # n_heads, bf16, tiles, stream
    "local_dkv": [P] * 10 + [I] * 8 + [P],
    # pool, rows, out, R, M, row_bytes, idx64, stream
    "paged_gather": [P] * 3 + [I] * 4 + [P],
    # k_pool, v_pool, rows, k_out, v_out, R, M, row_bytes, idx64, stream
    "paged_gather_pair": [P] * 5 + [I] * 4 + [P],
}

_lib = None
_entry: dict = {}            # name -> the loaded entry point, signature declared
last_build: dict = {}        # {"path", "seconds", "built", "log"} of load()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, bool, str]:
    """Compile (if needed) and return (library path, built now?, nvcc log)."""
    sources = sorted(CSRC.glob("*.cu"))
    out = BUILD_DIR / f"librepro_torch_kernels-{_digest()}.so"
    if out.exists():
        return out, False, ""
    nvcc = _nvcc()
    work = BUILD_DIR / f"tmp-{out.stem}-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources:                    # one nvcc per source, all at once
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, proc in procs:
        text, _ = proc.communicate()
        log.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp_lib = work / out.name
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp_lib),
                           *[str(o) for _, o, _ in procs]],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp_lib, out)               # atomic: a reader sees all or none
    shutil.rmtree(work, ignore_errors=True)
    return out, True, "\n".join(log)


def load():
    """The loaded kernel library (built at first use), with its C
    signatures declared."""
    global _lib
    if _lib is None:
        t0 = time.perf_counter()
        path, built, log = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _entry[name] = fn
        last_build.update(path=str(path), built=built, log=log,
                          seconds=time.perf_counter() - t0)
        _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call entry point ``name`` and raise if its launch was refused (or if
    the wrapper passed another number of arguments than its signature)."""
    if len(args) != len(SIGNATURES[name]):
        raise TypeError(f"{name}: {len(args)} arguments for a signature of "
                        f"{len(SIGNATURES[name])}")
    if not _entry:
        load()
    err = _entry[name](*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
