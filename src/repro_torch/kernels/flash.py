"""Flash-attention forward kernel with the mask modes BSA needs.

Replaces ``repro/kernels/flash.py::_fwd_kernel`` (Pallas, TPU), with the
index masks of ``flash.py::_mask_logits``.  The CUDA source is
``csrc/flash_fwd.cu``.

What bounds it on the H100: in the compression branch (N queries against
L = N/ℓ pooled keys, D = 32) the work is 4·L·D FLOP per query row, so the
arithmetic bounds it.  The TPU carried the running softmax state across
sequential grid steps; Hopper blocks run in no order, so the K loop runs
inside the block: one block owns 128 query rows, stages 64-key K/V tiles
into shared memory and folds them with an online softmax on the fp32 pipes.
The ragged last tile (L = 480) is masked in the kernel, so nothing is
padded here.  A block whose rows are all invalid queries (``q_valid``)
writes zeros and stops: such rows are unspecified by the contract.

Layout: q (B·Hkv, rep, N, D); k, v (B·Hkv, L, D); key_bias (B, L) fp32;
q_valid (B, N) bool or None.  ``causal``: key j visible to query t iff
j ≤ t; ``block_causal``: coarse key j visible iff (j+1)·ℓ − 1 < t.
Returns o like q and lse (B·Hkv, rep, N) fp32.
"""

from __future__ import annotations

import torch

from repro_torch.core.branches import sdpa
from repro_torch.kernels import _build
from repro_torch.kernels.common import _counter, check_cuda_inputs, on_cpu
from repro_torch.numerics import NEG_INF

__all__ = ["flash_attention_fwd", "flash_attention_fwd_plain", "COUNT"]

COUNT = _counter("flash_fwd")


def visible_keys(N: int, L: int, *, causal: bool, block_causal: bool, ell: int,
                 device=None) -> torch.Tensor | None:
    """(N, L) bool index mask of the causal modes, None in plain mode."""
    if not (causal or block_causal):
        return None
    t = torch.arange(N, device=device)[:, None]
    j = torch.arange(L, device=device)[None, :]
    return (j + 1) * ell - 1 < t if block_causal else j <= t


def flash_attention_fwd_plain(q, k, v, key_bias, q_valid=None, *, n_heads: int,
                              causal: bool = False, block_causal: bool = False,
                              ell: int = 1):
    """Plain PyTorch version of the kernel: same inputs, same (o, lse) on
    every valid query row (``q_valid`` is only a skip hint; the plain
    version computes every row)."""
    BH, rep, N, D = q.shape
    L = k.shape[1]
    bias = key_bias.repeat_interleave(n_heads, dim=0)[:, None, None, :]
    ok = visible_keys(N, L, causal=causal, block_causal=block_causal, ell=ell,
                      device=q.device)
    if ok is not None:
        bias = torch.where(ok, bias, torch.full_like(bias, NEG_INF))
    return sdpa(q, k[:, None], v[:, None], bias, return_lse=True)


def flash_attention_fwd(q, k, v, key_bias, q_valid=None, *, n_heads: int,
                        causal: bool = False, block_causal: bool = False,
                        ell: int = 1):
    """(o, lse) of streaming attention: the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors."""
    BH, rep, N, D = q.shape
    L = k.shape[1]
    B = BH // n_heads
    if k.shape != (BH, L, D) or v.shape != k.shape or key_bias.shape != (B, L):
        raise ValueError(f"flash_fwd: k/v must be {(BH, L, D)} and key_bias "
                         f"{(B, L)}, got {tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(key_bias.shape)}")
    if q_valid is not None and q_valid.shape != (B, N):
        raise ValueError(f"flash_fwd: q_valid must be {(B, N)}")
    if on_cpu(q, k, v, key_bias):
        return flash_attention_fwd_plain(q, k, v, key_bias, q_valid,
                                         n_heads=n_heads, causal=causal,
                                         block_causal=block_causal, ell=ell)
    qv = None if q_valid is None else q_valid.to(torch.uint8).contiguous()
    check_cuda_inputs("flash_fwd", data=(q, k, v), f32=(key_bias,), head_dim=D)
    o = torch.empty_like(q)
    lse = torch.empty((BH, rep, N), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.launch("flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  key_bias.data_ptr(), None if qv is None else qv.data_ptr(),
                  o.data_ptr(), lse.data_ptr(), BH, rep, N, L, D, n_heads,
                  int(causal), int(block_causal), ell,
                  int(q.dtype == torch.bfloat16), stream)
    COUNT.hit()
    return o, lse
