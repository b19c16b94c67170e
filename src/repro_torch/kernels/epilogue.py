"""Fused gated-combine epilogue forward kernel.

Replaces ``repro/kernels/epilogue.py::_fwd_kernel`` (Pallas, TPU).  The
CUDA source is ``csrc/epilogue_fwd.cu``.

    out = (g₁·o₁ + g₂·o₂ + g₃·o₃) · m        (fp32 accumulation)

What bounds it on the H100: memory — four (R, D) tensors move for six FLOP
per element.  The kernel is one coalesced grid-stride pass, so each element
is read and written once instead of the seven round trips of the composed
form.

Layout: o₁..o₃ (R, D) in the compute dtype; g₁..g₃ (R,) fp32 per-row gate
values; m (R,) fp32 query validity (1 real / 0 padded).  Returns (R, D) in
o₁'s dtype.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import _counter, check_cuda_inputs, on_cpu

__all__ = ["gated_combine_fwd", "gated_combine_fwd_plain", "COUNT"]

COUNT = _counter("epilogue_fwd")


def gated_combine_fwd_plain(o1, o2, o3, g1, g2, g3, m):
    """Plain PyTorch version of the kernel: same inputs, same output."""
    acc = (g1[:, None] * o1.float() + g2[:, None] * o2.float()
           + g3[:, None] * o3.float())
    return (acc * m[:, None]).to(o1.dtype)


def gated_combine_fwd(o1, o2, o3, g1, g2, g3, m):
    """The fused epilogue: the CUDA kernel on CUDA tensors, the plain version
    on CPU tensors."""
    R, D = o1.shape
    if o2.shape != o1.shape or o3.shape != o1.shape or any(
            t.shape != (R,) for t in (g1, g2, g3, m)):
        raise ValueError(f"epilogue_fwd: branch outputs must be {(R, D)} and "
                         f"gates / mask {(R,)}")
    if on_cpu(o1, o2, o3, g1, g2, g3, m):
        return gated_combine_fwd_plain(o1, o2, o3, g1, g2, g3, m)
    check_cuda_inputs("epilogue_fwd", data=(o1, o2, o3), f32=(g1, g2, g3, m))
    out = torch.empty_like(o1)
    stream = torch.cuda.current_stream(o1.device).cuda_stream
    _build.launch("epilogue_fwd", o1.data_ptr(), o2.data_ptr(), o3.data_ptr(),
                  g1.data_ptr(), g2.data_ptr(), g3.data_ptr(), m.data_ptr(),
                  out.data_ptr(), R, D, int(o1.dtype == torch.bfloat16), stream)
    COUNT.hit()
    return out
