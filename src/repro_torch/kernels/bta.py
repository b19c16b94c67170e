"""Ball-Tree Attention forward kernel (block-diagonal fused attention).

Replaces ``repro/kernels/bta.py::_fwd_kernel`` (Pallas, TPU).  The CUDA
source is ``csrc/bta_fwd.cu``.

What bounds it on the H100: at the paper's shapes (ball m = 256, D = 32)
the work is 4·m·D FLOP per query row against 8·D bytes of q and o, so the
arithmetic bounds it.  The kernel stages one ball's K and V (64 KB in fp32)
into shared memory once per block and runs every query row of the ball
against it with fp32 FMAs (no tensor cores yet); a ball with no valid key
skips all of it and writes zeros with lse = ``LSE_EMPTY``.

Layout (GQA-native, as the TPU kernel): q (B·Hkv, rep, N, D); k, v
(B·Hkv, N, D); key_bias (B, N) fp32 additive (0 / NEG_INF).  Returns
o like q and lse (B·Hkv, rep, N) fp32.
"""

from __future__ import annotations

import torch

from repro_torch.core.branches import sdpa
from repro_torch.kernels import _build
from repro_torch.kernels.common import _counter, check_cuda_inputs, on_cpu
from repro_torch.kernels.occupancy import key_tile_live

__all__ = ["ball_attention_fwd", "ball_attention_fwd_plain", "COUNT"]

COUNT = _counter("bta_fwd")


def ball_attention_fwd_plain(q, k, v, key_bias, *, ball_size: int, n_heads: int):
    """Plain PyTorch version of the kernel: same inputs, same (o, lse)."""
    BH, rep, N, D = q.shape
    m = ball_size
    nb = N // m
    qb = q.reshape(BH, rep, nb, m, D).transpose(1, 2)        # (BH, nb, rep, m, D)
    kb = k.reshape(BH, 1, nb, m, D).transpose(1, 2)          # (BH, nb, 1, m, D)
    vb = v.reshape(BH, 1, nb, m, D).transpose(1, 2)
    bias = key_bias.repeat_interleave(n_heads, dim=0)        # (BH, N)
    bias = bias.reshape(BH, nb, 1, 1, m)
    o, lse = sdpa(qb, kb, vb, bias, return_lse=True)
    return (o.transpose(1, 2).reshape(BH, rep, N, D),
            lse.transpose(1, 2).reshape(BH, rep, N))


def ball_attention_fwd(q, k, v, key_bias, *, ball_size: int, n_heads: int):
    """(o, lse) of ball attention: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors."""
    BH, rep, N, D = q.shape
    if k.shape != (BH, N, D) or v.shape != k.shape:
        raise ValueError(f"k/v must be {(BH, N, D)}, got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if key_bias.shape != (BH // n_heads, N) or N % ball_size:
        raise ValueError(f"key_bias must be {(BH // n_heads, N)} and ball_size "
                         f"{ball_size} must divide N={N}")
    if on_cpu(q, k, v, key_bias):
        return ball_attention_fwd_plain(q, k, v, key_bias, ball_size=ball_size,
                                        n_heads=n_heads)
    live = key_tile_live(key_bias, ball_size).to(torch.int32)
    check_cuda_inputs("bta_fwd", data=(q, k, v), f32=(key_bias,), i32=(live,),
                      head_dim=D)
    o = torch.empty_like(q)
    lse = torch.empty((BH, rep, N), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.launch("bta_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  key_bias.data_ptr(), live.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), BH, rep, N, D, ball_size, n_heads,
                  int(q.dtype == torch.bfloat16), stream)
    COUNT.hit()
    return o, lse
