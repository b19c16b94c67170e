"""Paged-KV-cache row gather kernel (the paged decode's hot fetch).

Replaces ``repro/kernels/paged.py::_copy_kernel`` (Pallas, TPU).  The CUDA
source is ``csrc/paged_gather.cu``.  ``paged_gather(pool (R, Hkv, D), rows)``
returns ``pool[rows]`` with shape ``rows.shape + (Hkv, D)``.  Indices
follow jnp indexing under jit (and the Pallas kernel in interpret mode): a
negative index counts from the end, then an index still outside [0, R)
reads the nearest edge row, so no index reads out of bounds.

What bounds it on the H100: it only moves bytes (each gathered row read once
and written once), so memory bounds it; the decode step's gathers are small
(a few to a few thousand rows of Hkv·D elements), so the call's host work
and the launch are most of their time.  The TPU scalar-prefetched each row
index into a BlockSpec and pipelined one row DMA per grid cell; here one
warp copies one row with 16-byte vector loads, neighbouring lanes on
neighbouring addresses.  The kernel reads int32 or int64 indices itself,
and the wrapper neither casts nor reshapes them: a call is one
``torch.empty`` and one launch.

``paged_gather_pair(k_pool, v_pool, rows)`` gathers the K and the V pool
with the same rows in one launch (``csrc/paged_gather.cu``'s
``paged_gather_pair``): the paged decode fetches every row set from both
pools, and at its sizes the call, not the copy, is the cost.  One
``torch.empty`` holds both outputs, returned as two views.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import _counter, check_cuda_inputs, on_cpu

__all__ = ["paged_gather", "paged_gather_plain", "paged_gather_pair",
           "paged_gather_pair_plain", "COUNT", "COUNT_PAIR"]

COUNT = _counter("paged_gather")
COUNT_PAIR = _counter("paged_gather_pair")


def _check(pool, rows):
    if pool.dim() != 3:
        raise ValueError(f"paged_gather: pool must be (R, Hkv, D), got {tuple(pool.shape)}")
    if rows.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"paged_gather: rows must be an integer tensor, got {rows.dtype}")
    if pool.shape[0] == 0:
        raise ValueError("paged_gather: empty pool")


def paged_gather_plain(pool, rows):
    """Plain PyTorch version of the kernel: ``pool[rows]`` with negative
    indices from the end and the rest clamped to [0, R−1]."""
    _check(pool, rows)
    R = pool.shape[0]
    r = rows.long()
    return pool[torch.where(r < 0, r + R, r).clamp(0, R - 1)]


_DATA = (torch.float32, torch.bfloat16)
_INDEX = (torch.int32, torch.int64)


def _kernel_takes(pool, rows) -> bool:
    """The kernel takes these tensors as they are: both on one card, pool
    (R > 0, Hkv, D) fp32 or bf16, rows int32 or int64, both contiguous.
    One expression, so that a decode step's calls pay for no more checks."""
    return (pool.is_cuda and rows.is_cuda and pool.get_device() == rows.get_device()
            and pool.dim() == 3 and pool.shape[0] > 0 and pool.dtype in _DATA
            and rows.dtype in _INDEX and pool.is_contiguous() and rows.is_contiguous())


def paged_gather(pool, rows):
    """``pool[rows]`` (negative from the end, then clamped): the CUDA kernel
    on CUDA tensors, the plain version on CPU tensors.  ``rows``: int32 or
    int64 tensor of any shape (contiguous on the card)."""
    if not _kernel_takes(pool, rows):          # the CPU, or raise on what it does not take
        _check(pool, rows)
        if on_cpu(pool, rows):
            return paged_gather_plain(pool, rows)
        check_cuda_inputs("paged_gather", data=(pool,), index=(rows,))
    R, H, D = pool.shape
    out = pool.new_empty((*rows.shape, H, D))     # less host work than torch.empty(device=)
    _build.launch("paged_gather", pool.data_ptr(), rows.data_ptr(), out.data_ptr(), R,
                  rows.numel(), H * D * pool.element_size(), int(rows.dtype == torch.int64),
                  torch._C._cuda_getCurrentRawStream(pool.get_device()))
    COUNT.hit()
    return out


def paged_gather_pair_plain(k_pool, v_pool, rows):
    """Plain PyTorch version of the pair kernel: two calls of
    :func:`paged_gather_plain` with the same rows."""
    return paged_gather_plain(k_pool, rows), paged_gather_plain(v_pool, rows)


def paged_gather_pair(k_pool, v_pool, rows):
    """``(k_pool[rows], v_pool[rows])`` (negative from the end, then
    clamped) for two pools of one shape and dtype: one CUDA launch on CUDA
    tensors, the plain version on CPU tensors.  ``rows``: int32 or int64
    tensor of any shape (contiguous on the card)."""
    if not (_kernel_takes(k_pool, rows) and v_pool.is_cuda
            and v_pool.get_device() == k_pool.get_device() and v_pool.dtype == k_pool.dtype
            and v_pool.shape == k_pool.shape and v_pool.is_contiguous()):
        _check(k_pool, rows)
        _check(v_pool, rows)
        if v_pool.shape != k_pool.shape or v_pool.dtype != k_pool.dtype:
            raise ValueError(f"paged_gather_pair: the pools differ: {tuple(k_pool.shape)} "
                             f"{k_pool.dtype} and {tuple(v_pool.shape)} {v_pool.dtype}")
        if on_cpu(k_pool, v_pool, rows):
            return paged_gather_pair_plain(k_pool, v_pool, rows)
        check_cuda_inputs("paged_gather_pair", data=(k_pool, v_pool), index=(rows,))
    R, H, D = k_pool.shape
    out = k_pool.new_empty((2, *rows.shape, H, D))
    M, row_bytes = rows.numel(), H * D * k_pool.element_size()
    _build.launch("paged_gather_pair", k_pool.data_ptr(), v_pool.data_ptr(), rows.data_ptr(),
                  out.data_ptr(), out.data_ptr() + M * row_bytes, R, M, row_bytes,
                  int(rows.dtype == torch.int64),
                  torch._C._cuda_getCurrentRawStream(k_pool.get_device()))
    COUNT_PAIR.hit()
    return out.unbind(0)
