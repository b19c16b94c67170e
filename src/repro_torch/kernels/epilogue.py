"""Fused gated-combine epilogue kernels, forward and backward.

Replaces ``repro/kernels/epilogue.py::_fwd_kernel`` and ``::_bwd_kernel``
(Pallas, TPU).  The CUDA sources are ``csrc/epilogue_fwd.cu`` and
``csrc/epilogue_bwd.cu``.

    out = (g₁·o₁ + g₂·o₂ + g₃·o₃) · m        (fp32 accumulation)
    d oᵦ = gᵦ·m·dO        d gᵦ = Σ_D (m·dO·oᵦ)

What bounds them on the H100: memory — the forward moves four (R, D)
tensors for six FLOP per element, the backward seven.  Each kernel is one
coalesced pass, so each element is read and written once instead of the
round trips of the composed form.  Both have two kernels under one rule
(:func:`epilogue_plan`): ``vec`` where D is a multiple of one 16-byte
vector (4 fp32, 8 bf16) and the (R, D) tensors are 16-byte aligned — a
row on L = D/4 (fp32) or D/8 (bf16) lanes, a power of two up to 32,
16-byte loads and stores (the backward's sums over D for d gᵦ a butterfly
over the row's lanes: a fixed order, so two calls give the same bits);
``warp`` for any other D or alignment — one warp a row.

Layout: o₁..o₃ (R, D) in the compute dtype, R = B·N·H rows (token-major,
head-minor); returns (R, D) in o₁'s dtype.  The forward reads the gates
and the mask where the layer keeps them: a gate is fp32 (T, H) with unit
stride along H, T = 1 for one gate a head (``gate_mode="scalar"``) or T =
R/H for one a row (``"token"``, whose rows may be strided: the layer's
(B·N, 3H) projection sliced per branch); the mask is (R/H,) bool, one
value a token, or None.  The backward kernel takes (R,) fp32 gates and
mask; :class:`GatedCombineFn` expands them to rows inside ``backward``
only and sums a per-head gate's row gradients back to (1, H) there, as
``jax.custom_vjp`` wraps the Pallas pair (the mask takes no gradient).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import _build
from repro_torch.kernels.common import _counter, check_cuda_inputs, on_cpu

__all__ = ["gated_combine_fwd", "gated_combine_fwd_plain", "gated_combine_bwd",
           "gated_combine_bwd_plain", "epilogue_plan", "EpiloguePlan", "GatedCombineFn",
           "COUNT", "COUNT_BWD"]

COUNT = _counter("epilogue_fwd")
COUNT_BWD = _counter("epilogue_bwd")


def _check_shapes(name, o1, o2, o3, g1, g2, g3, m):
    R, D = o1.shape
    if o2.shape != o1.shape or o3.shape != o1.shape or any(
            t.shape != (R,) for t in (g1, g2, g3, m)):
        raise ValueError(f"{name}: branch outputs must be {(R, D)} and "
                         f"gates / mask {(R,)}")


def _check_fwd(o1, o2, o3, g1, g2, g3, m):
    """Raise on a forward call the kernel does not take: three (R, D)
    branch outputs, three fp32 (1 | R/H, H) gates with unit stride along H,
    a (R/H,) bool mask or None."""
    R, D = o1.shape
    H = g1.shape[-1]
    if o2.shape != o1.shape or o3.shape != o1.shape:
        raise ValueError(f"epilogue_fwd: branch outputs must be {(R, D)}")
    for g in (g1, g2, g3):
        if (not isinstance(g, torch.Tensor) or g.dim() != 2 or g.shape[1] != H
                or R % H or g.shape[0] not in (1, R // H) or g.dtype != torch.float32
                or (H > 1 and g.stride(1) != 1)):
            raise ValueError(
                "epilogue_fwd: a gate is an fp32 (1, H) tensor (one a head) or "
                f"({R // max(H, 1)}, H) (one a row) with unit stride along H, all of "
                f"one H dividing R = {R}; got "
                f"{tuple(g.shape) if isinstance(g, torch.Tensor) else type(g).__name__}")
    if m is not None and (m.shape != (R // H,) or m.dtype != torch.bool):
        raise ValueError(f"epilogue_fwd: the mask is ({R // H},) bool, one a token, "
                         f"or None; got {tuple(m.shape)} {m.dtype}")


def gated_combine_fwd_plain(o1, o2, o3, g1, g2, g3, m):
    """Plain PyTorch version of the kernel: same inputs, same output."""
    R = o1.shape[0]
    T, H = R // g1.shape[1], g1.shape[1]
    rows = [g.expand(T, H).reshape(R, 1) for g in (g1, g2, g3)]
    acc = rows[0] * o1.float() + rows[1] * o2.float() + rows[2] * o3.float()
    if m is not None:
        acc = acc * m[:, None].expand(T, H).reshape(R, 1).float()
    return acc.to(o1.dtype)


_DATA = (torch.float32, torch.bfloat16)


def _fwd_takes(o1, o2, o3, g1, g2, g3, m) -> bool:
    """The forward kernel takes these tensors as they are: all on one card,
    o₁..o₃ one fp32 or bf16 (R, D) shape, contiguous; fp32 (1 | R/H, H)
    gates with unit stride along H; a (R/H,) bool mask or None.  One
    expression, so that a layer's call pays for no more checks."""
    R = o1.shape[0]
    H = g1.shape[-1]
    dev = o1.get_device()
    return (o1.is_cuda and o1.dtype in _DATA and o1.dim() == 2 and o2.dtype == o1.dtype
            and o3.dtype == o1.dtype and o2.shape == o1.shape and o3.shape == o1.shape
            and o1.is_contiguous() and o2.is_contiguous() and o3.is_contiguous()
            and o2.get_device() == dev and o3.get_device() == dev and H > 0 and R % H == 0
            and all(g.dim() == 2 and g.dtype == torch.float32 and g.get_device() == dev
                    and g.shape[1] == H and g.shape[0] in (1, R // H)
                    and (g.stride(1) == 1 or H == 1) for g in (g1, g2, g3))
            and (m is None or (m.dtype == torch.bool and m.get_device() == dev
                               and m.shape == (R // H,) and m.is_contiguous())))


def gated_combine_fwd(o1, o2, o3, g1, g2, g3, m):
    """The fused epilogue: the CUDA kernel on CUDA tensors, the plain version
    on CPU tensors.  Gates fp32 (1, H) or (R/H, H), the mask (R/H,) bool or
    None (see the module's layout)."""
    if not _fwd_takes(o1, o2, o3, g1, g2, g3, m):     # the CPU, or raise
        _check_fwd(o1, o2, o3, g1, g2, g3, m)
        if on_cpu(o1, o2, o3, g1, g2, g3, *(() if m is None else (m,))):
            return gated_combine_fwd_plain(o1, o2, o3, g1, g2, g3, m)
        check_cuda_inputs("epilogue_fwd", data=(o1, o2, o3))
        raise ValueError("epilogue_fwd: the mask must be contiguous")
    R, D = o1.shape
    H = g1.shape[1]
    out = torch.empty_like(o1)
    aligned = (o1.data_ptr() | o2.data_ptr() | o3.data_ptr() | out.data_ptr()) % 16 == 0
    plan = epilogue_plan(D, o1.dtype, aligned)
    _build.launch("epilogue_fwd", o1.data_ptr(), o2.data_ptr(), o3.data_ptr(),
                  g1.data_ptr(), g2.data_ptr(), g3.data_ptr(),
                  None if m is None else m.data_ptr(), out.data_ptr(), R, D, H,
                  g1.stride(0) if g1.shape[0] > 1 else 0,
                  g2.stride(0) if g2.shape[0] > 1 else 0,
                  g3.stride(0) if g3.shape[0] > 1 else 0,
                  int(o1.dtype == torch.bfloat16), plan.lanes if plan.path == "vec" else 0,
                  torch._C._cuda_getCurrentRawStream(o1.get_device()))
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
    """How ``epilogue_fwd`` and ``epilogue_bwd`` take one shape: ``path`` ``"vec"`` or
    ``"warp"``; ``lanes``: lanes a row (the kernel's ``lanes`` argument is
    0 on the warp path); ``rows``: rows a warp."""
    path: str
    lanes: int
    rows: int


def epilogue_plan(D: int, dtype: torch.dtype, aligned: bool = True) -> EpiloguePlan:
    """The kernel of either epilogue for rows of D elements (one rule for
    ``csrc/epilogue_fwd.cu`` and ``csrc/epilogue_bwd.cu``, whose vec kernels
    share ``csrc/epilogue.cuh``'s row-to-lane mapping):
    ``vec`` when D is a multiple of one 16-byte vector (4 fp32 or 8 bf16
    elements) and ``aligned`` (every (R, D) tensor starts on 16 bytes) —
    L lanes a row, the largest power of two up to 32 that is at most D's
    vectors, 32 / L rows a warp; else ``warp``, one warp a row."""
    per_vec = 16 // dtype.itemsize
    if aligned and D >= per_vec and D % per_vec == 0:
        lanes = min(32, 1 << ((D // per_vec).bit_length() - 1))
        return EpiloguePlan("vec", lanes, 32 // lanes)
    return EpiloguePlan("warp", 32, 1)


def _bwd_takes(o1, o2, o3, g1, g2, g3, m, do) -> bool:
    """The backward kernel takes these tensors as they are: all on one
    card, o₁..o₃ and dO one fp32 or bf16 (R, D) shape, contiguous; the
    gates and the mask fp32 (R,), contiguous.  One expression."""
    R = o1.shape[0]
    dev = o1.get_device()
    return (o1.is_cuda and o1.dtype in _DATA and o1.dim() == 2
            and all(t.dtype == o1.dtype and t.shape == o1.shape and t.is_contiguous()
                    and t.get_device() == dev for t in (o1, o2, o3, do))
            and all(t.dtype == torch.float32 and t.shape == (R,) and t.is_contiguous()
                    and t.get_device() == dev for t in (g1, g2, g3, m)))


def gated_combine_bwd(o1, o2, o3, g1, g2, g3, m, do):
    """Backward of the epilogue: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors.  Gates and mask (R,) fp32."""
    if not _bwd_takes(o1, o2, o3, g1, g2, g3, m, do):   # the CPU, or raise
        _check_shapes("epilogue_bwd", o1, o2, o3, g1, g2, g3, m)
        if do.shape != o1.shape:
            raise ValueError(f"epilogue_bwd: dO must be {tuple(o1.shape)}")
        if on_cpu(o1, o2, o3, g1, g2, g3, m, do):
            return gated_combine_bwd_plain(o1, o2, o3, g1, g2, g3, m, do)
        check_cuda_inputs("epilogue_bwd", data=(o1, o2, o3, do), f32=(g1, g2, g3, m))
    R, D = o1.shape
    aligned = (o1.data_ptr() | o2.data_ptr() | o3.data_ptr() | do.data_ptr()) % 16 == 0
    plan = epilogue_plan(D, o1.dtype, aligned)
    douts = torch.empty((3, R, D), dtype=o1.dtype, device=o1.device)
    dgs = torch.empty((3, R), dtype=torch.float32, device=o1.device)
    d0, g0, step = douts.data_ptr(), dgs.data_ptr(), R * D * douts.element_size()
    _build.launch("epilogue_bwd", o1.data_ptr(), o2.data_ptr(), o3.data_ptr(),
                  g1.data_ptr(), g2.data_ptr(), g3.data_ptr(), m.data_ptr(),
                  do.data_ptr(), d0, d0 + step, d0 + 2 * step, g0, g0 + 4 * R,
                  g0 + 8 * R, R, D,
                  int(o1.dtype == torch.bfloat16),
                  plan.lanes if plan.path == "vec" else 0,
                  torch._C._cuda_getCurrentRawStream(o1.get_device()))
    COUNT_BWD.hit()
    return (*douts.unbind(0), *dgs.unbind(0))


class GatedCombineFn(torch.autograd.Function):
    """Differentiable epilogue: forward and backward kernels (or their plain
    versions on CPU tensors).  Gradients flow to o₁..o₃ and g₁..g₃ in their
    forward forms: the backward expands the gates and the mask to (R,) rows
    for its kernel and sums a per-head gate's row gradients back to (1, H)."""

    @staticmethod
    def forward(ctx, o1, o2, o3, g1, g2, g3, m):
        ctx.save_for_backward(o1, o2, o3, g1, g2, g3, m)
        return gated_combine_fwd(o1, o2, o3, g1, g2, g3, m)

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        o1, o2, o3, g1, g2, g3, m = ctx.saved_tensors
        R, H = o1.shape[0], g1.shape[1]
        T = R // H

        def rows(g):
            return g.expand(T, H).reshape(R)

        mr = (torch.ones(R, dtype=torch.float32, device=o1.device) if m is None
              else m[:, None].expand(T, H).reshape(R).float())
        *douts, dg1, dg2, dg3 = gated_combine_bwd(o1, o2, o3, rows(g1), rows(g2), rows(g3),
                                                  mr, do.contiguous())
        dgs = tuple(dg.view(T, H).sum(0, keepdim=True) if g.shape[0] == 1 else dg.view(T, H)
                    for dg, g in ((dg1, g1), (dg2, g2), (dg3, g3)))
        return (*douts, *dgs, None)
