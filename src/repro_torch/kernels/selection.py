"""Group-selected sparse attention forward kernel (the NSA/BSA hot path).

Replaces ``repro/kernels/selection.py::_fwd_kernel`` (Pallas, TPU).  The
CUDA source is ``csrc/selection_fwd.cu``.

What bounds it on the H100: each query group gathers k* blocks of ℓ keys
and values for only 4·M·k*·ℓ·D FLOP (M = g·rep = 8 rows at the paper's
shapes), so memory traffic bounds it.  The TPU scalar-prefetched the
indices to drive its block fetches; here each warp loads its own group's
indices and gathers the selected blocks itself.  With 8 rows against 8 keys
a tensor-core tile would be mostly empty, so one warp owns one
(batch, KV head, group): 8 rows × 4 lanes, D/4 dims a lane, shuffles sum a
row's dot products.  Invalid selections (−1) cost nothing; a group with no
valid selection writes zeros and lse = ``LSE_EMPTY``.

Layout: q (B, Hkv, G, M, D); kb, vb (B, Hkv, NB, ℓ, D); idx (B, Hkv, G, k*)
int32 (−1 = invalid); tok_bias (B, NB, ℓ) fp32.  Returns o like q and lse
(B, Hkv, G, M) fp32.
"""

from __future__ import annotations

import torch

from repro_torch.core.branches import sdpa
from repro_torch.kernels import _build
from repro_torch.kernels.common import _counter, check_cuda_inputs, on_cpu
from repro_torch.numerics import NEG_INF

__all__ = ["selection_attention_fwd", "selection_attention_fwd_plain", "COUNT"]

COUNT = _counter("selection_fwd")


def selection_attention_fwd_plain(q, kb, vb, idx, tok_bias):
    """Plain PyTorch version of the kernel: same inputs, same (o, lse)."""
    B, Hkv, G, M, D = q.shape
    NB, ell = kb.shape[2], kb.shape[3]
    k_star = idx.shape[-1]
    valid = idx >= 0
    safe = torch.where(valid, idx, torch.zeros_like(idx)).long()
    flat = safe.reshape(B, Hkv, G * k_star)
    kg = torch.gather(kb.reshape(B, Hkv, NB, ell * D), 2,
                      flat[..., None].expand(-1, -1, -1, ell * D))
    vg = torch.gather(vb.reshape(B, Hkv, NB, ell * D), 2,
                      flat[..., None].expand(-1, -1, -1, ell * D))
    kg = kg.reshape(B, Hkv, G, k_star * ell, D)
    vg = vg.reshape(B, Hkv, G, k_star * ell, D)
    tb = torch.gather(tok_bias[:, None].expand(-1, Hkv, -1, -1).reshape(B, Hkv, NB, ell),
                      2, flat[..., None].expand(-1, -1, -1, ell))
    tb = tb.reshape(B, Hkv, G, k_star, ell)
    bias = torch.where(valid[..., None], tb, torch.full_like(tb, NEG_INF))
    bias = bias.reshape(B, Hkv, G, 1, k_star * ell)
    return sdpa(q, kg, vg, bias, return_lse=True)


def selection_attention_fwd(q, kb, vb, idx, tok_bias):
    """(o, lse) of group-selected attention: the CUDA kernel on CUDA tensors,
    the plain version on CPU tensors."""
    B, Hkv, G, M, D = q.shape
    NB, ell = kb.shape[2], kb.shape[3]
    if (kb.shape != (B, Hkv, NB, ell, D) or vb.shape != kb.shape
            or idx.shape[:3] != (B, Hkv, G) or tok_bias.shape != (B, NB, ell)):
        raise ValueError("selection_fwd: shapes disagree: q "
                         f"{tuple(q.shape)}, kb {tuple(kb.shape)}, vb "
                         f"{tuple(vb.shape)}, idx {tuple(idx.shape)}, "
                         f"tok_bias {tuple(tok_bias.shape)}")
    if on_cpu(q, kb, vb, idx, tok_bias):
        return selection_attention_fwd_plain(q, kb, vb, idx, tok_bias)
    check_cuda_inputs("selection_fwd", data=(q, kb, vb), f32=(tok_bias,),
                      i32=(idx,), head_dim=D)
    o = torch.empty_like(q)
    lse = torch.empty((B, Hkv, G, M), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.launch("selection_fwd", q.data_ptr(), kb.data_ptr(), vb.data_ptr(),
                  idx.data_ptr(), tok_bias.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), B, Hkv, G, M, NB, ell, idx.shape[-1], D,
                  int(q.dtype == torch.bfloat16), stream)
    COUNT.hit()
    return o, lse
