"""Fused gated-combine epilogue kernels, forward and backward.

Replaces ``repro/kernels/epilogue.py::_fwd_kernel`` and ``::_bwd_kernel``
(Pallas, TPU).  The CUDA sources are ``csrc/epilogue_fwd.cu`` and
``csrc/epilogue_bwd.cu``.

    out = (g₁·o₁ + g₂·o₂ + g₃·o₃) · m        (fp32 accumulation)
    d oᵦ = gᵦ·m·dO        d gᵦ = Σ_D (m·dO·oᵦ)

What bounds them on the H100: memory — the forward moves four (R, D)
tensors for six FLOP per element, the backward seven.  Each kernel is one
coalesced pass, so each element is read and written once instead of the
round trips of the composed form.  The backward gives one warp to a row so
that the sum over D for d gᵦ is a warp reduction.

Layout: o₁..o₃ (R, D) in the compute dtype; g₁..g₃ (R,) fp32 per-row gate
values; m (R,) fp32 query validity (1 real / 0 padded).  Returns (R, D) in
o₁'s dtype.  :class:`GatedCombineFn` is the differentiable op (the mask
takes no gradient), as ``jax.custom_vjp`` wraps the Pallas pair.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import _build
from repro_torch.kernels.common import _counter, check_cuda_inputs, on_cpu

__all__ = ["gated_combine_fwd", "gated_combine_fwd_plain", "gated_combine_bwd",
           "gated_combine_bwd_plain", "GatedCombineFn", "COUNT", "COUNT_BWD"]

COUNT = _counter("epilogue_fwd")
COUNT_BWD = _counter("epilogue_bwd")


def _check_shapes(name, o1, o2, o3, g1, g2, g3, m):
    R, D = o1.shape
    if o2.shape != o1.shape or o3.shape != o1.shape or any(
            t.shape != (R,) for t in (g1, g2, g3, m)):
        raise ValueError(f"{name}: branch outputs must be {(R, D)} and "
                         f"gates / mask {(R,)}")


def gated_combine_fwd_plain(o1, o2, o3, g1, g2, g3, m):
    """Plain PyTorch version of the kernel: same inputs, same output."""
    acc = (g1[:, None] * o1.float() + g2[:, None] * o2.float()
           + g3[:, None] * o3.float())
    return (acc * m[:, None]).to(o1.dtype)


def gated_combine_fwd(o1, o2, o3, g1, g2, g3, m):
    """The fused epilogue: the CUDA kernel on CUDA tensors, the plain version
    on CPU tensors."""
    _check_shapes("epilogue_fwd", o1, o2, o3, g1, g2, g3, m)
    if on_cpu(o1, o2, o3, g1, g2, g3, m):
        return gated_combine_fwd_plain(o1, o2, o3, g1, g2, g3, m)
    check_cuda_inputs("epilogue_fwd", data=(o1, o2, o3), f32=(g1, g2, g3, m))
    R, D = o1.shape
    out = torch.empty_like(o1)
    stream = torch.cuda.current_stream(o1.device).cuda_stream
    _build.launch("epilogue_fwd", o1.data_ptr(), o2.data_ptr(), o3.data_ptr(),
                  g1.data_ptr(), g2.data_ptr(), g3.data_ptr(), m.data_ptr(),
                  out.data_ptr(), R, D, int(o1.dtype == torch.bfloat16), stream)
    COUNT.hit()
    return out


def gated_combine_bwd_plain(o1, o2, o3, g1, g2, g3, m, do):
    """Plain PyTorch version of the backward kernel: (d o₁, d o₂, d o₃) in
    the branch dtypes and (d g₁, d g₂, d g₃) (R,) fp32."""
    dom = do.float() * m[:, None]
    douts = tuple((g[:, None] * dom).to(o.dtype) for o, g in ((o1, g1), (o2, g2), (o3, g3)))
    dgs = tuple((dom * o.float()).sum(-1) for o in (o1, o2, o3))
    return douts + dgs


def gated_combine_bwd(o1, o2, o3, g1, g2, g3, m, do):
    """Backward of the epilogue: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors."""
    _check_shapes("epilogue_bwd", o1, o2, o3, g1, g2, g3, m)
    if do.shape != o1.shape:
        raise ValueError(f"epilogue_bwd: dO must be {tuple(o1.shape)}")
    if on_cpu(o1, o2, o3, g1, g2, g3, m, do):
        return gated_combine_bwd_plain(o1, o2, o3, g1, g2, g3, m, do)
    check_cuda_inputs("epilogue_bwd", data=(o1, o2, o3, do), f32=(g1, g2, g3, m))
    R, D = o1.shape
    douts = [torch.empty_like(o) for o in (o1, o2, o3)]
    dgs = [torch.empty_like(g1) for _ in range(3)]
    stream = torch.cuda.current_stream(o1.device).cuda_stream
    _build.launch("epilogue_bwd", o1.data_ptr(), o2.data_ptr(), o3.data_ptr(),
                  g1.data_ptr(), g2.data_ptr(), g3.data_ptr(), m.data_ptr(),
                  do.data_ptr(), *(t.data_ptr() for t in douts),
                  *(t.data_ptr() for t in dgs), R, D,
                  int(o1.dtype == torch.bfloat16), stream)
    COUNT_BWD.hit()
    return (*douts, *dgs)


class GatedCombineFn(torch.autograd.Function):
    """Differentiable epilogue: forward and backward kernels (or their plain
    versions on CPU tensors).  Gradients flow to o₁..o₃ and g₁..g₃."""

    @staticmethod
    def forward(ctx, o1, o2, o3, g1, g2, g3, m):
        ctx.save_for_backward(o1, o2, o3, g1, g2, g3, m)
        return gated_combine_fwd(o1, o2, o3, g1, g2, g3, m)

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        grads = gated_combine_bwd(*ctx.saved_tensors, do.contiguous())
        return (*grads, None)
