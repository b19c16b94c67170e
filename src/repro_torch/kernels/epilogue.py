"""Fused gated-combine epilogue kernels, forward and backward.

Replaces ``repro/kernels/epilogue.py::_fwd_kernel`` and ``::_bwd_kernel``
(Pallas, TPU).  The CUDA sources are ``csrc/epilogue_fwd.cu`` and
``csrc/epilogue_bwd.cu``.

    out = (g₁·o₁ + g₂·o₂ + g₃·o₃) · m        (fp32 accumulation)
    d oᵦ = gᵦ·m·dO        d gᵦ = Σ_D (m·dO·oᵦ)

What bounds them on the H100: memory — the forward moves four (R, D)
tensors for six FLOP per element, the backward seven.  Each kernel is one
coalesced pass, so each element is read and written once instead of the
round trips of the composed form.  The backward has two kernels, one rule
(:func:`epilogue_bwd_plan`): ``vec`` where D is a multiple of one 16-byte
vector (4 fp32, 8 bf16) and the (R, D) inputs are 16-byte aligned — a row
on L = D/4 (fp32) or D/8 (bf16) lanes, a power of two up to 32, 16-byte
loads and stores, the sums over D for d gᵦ a butterfly over the row's
lanes (a fixed order: two calls give the same bits); ``warp`` for any
other D or alignment — one warp a row, warp reductions.

Layout: o₁..o₃ (R, D) in the compute dtype; g₁..g₃ (R,) fp32 per-row gate
values; m (R,) fp32 query validity (1 real / 0 padded).  Returns (R, D) in
o₁'s dtype.  :class:`GatedCombineFn` is the differentiable op (the mask
takes no gradient), as ``jax.custom_vjp`` wraps the Pallas pair.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import _build
from repro_torch.kernels.common import _counter, check_cuda_inputs, on_cpu

__all__ = ["gated_combine_fwd", "gated_combine_fwd_plain", "gated_combine_bwd",
           "gated_combine_bwd_plain", "epilogue_bwd_plan", "EpiloguePlan", "GatedCombineFn",
           "COUNT", "COUNT_BWD"]

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


class EpiloguePlan(NamedTuple):
    """How ``epilogue_bwd`` takes one shape: ``path`` ``"vec"`` or
    ``"warp"``; ``lanes``: lanes a row (the kernel's ``lanes`` argument is
    0 on the warp path); ``rows``: rows a warp."""
    path: str
    lanes: int
    rows: int


def epilogue_bwd_plan(D: int, dtype: torch.dtype, aligned: bool = True) -> EpiloguePlan:
    """The backward kernel for rows of D elements (``csrc/epilogue_bwd.cu``):
    ``vec`` when D is a multiple of one 16-byte vector (4 fp32 or 8 bf16
    elements) and ``aligned`` (every (R, D) tensor starts on 16 bytes) —
    L lanes a row, the largest power of two up to 32 that is at most D's
    vectors, 32 / L rows a warp; else ``warp``, one warp a row."""
    per_vec = 16 // dtype.itemsize
    if aligned and D >= per_vec and D % per_vec == 0:
        lanes = min(32, 1 << ((D // per_vec).bit_length() - 1))
        return EpiloguePlan("vec", lanes, 32 // lanes)
    return EpiloguePlan("warp", 32, 1)


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
    plan = epilogue_bwd_plan(D, o1.dtype,
                             all(t.data_ptr() % 16 == 0 for t in (o1, o2, o3, do)))
    douts = torch.empty((3, R, D), dtype=o1.dtype, device=o1.device)
    dgs = torch.empty((3, R), dtype=torch.float32, device=o1.device)
    stream = torch.cuda.current_stream(o1.device).cuda_stream
    d0, g0, step = douts.data_ptr(), dgs.data_ptr(), R * D * douts.element_size()
    _build.launch("epilogue_bwd", o1.data_ptr(), o2.data_ptr(), o3.data_ptr(),
                  g1.data_ptr(), g2.data_ptr(), g3.data_ptr(), m.data_ptr(),
                  do.data_ptr(), d0, d0 + step, d0 + 2 * step, g0, g0 + 4 * R,
                  g0 + 8 * R, R, D,
                  int(o1.dtype == torch.bfloat16),
                  plan.lanes if plan.path == "vec" else 0, stream)
    COUNT_BWD.hit()
    return (*douts.unbind(0), *dgs.unbind(0))


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
