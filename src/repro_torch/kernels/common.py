"""Shared kernel utilities: the precision contract, the logsumexp residual,
launch counters and the device/dtype checks every wrapper runs.

Counterpart of ``repro/kernels/common.py``.  Each forward kernel emits a
per-query-row logsumexp ``lse = m + log l`` (``LSE_EMPTY`` for a row with
no valid key), the residual its backward kernel recomputes
``p = exp(s − lse)`` from, together with ``δ = rowsum(dO·O)``
(:func:`row_delta`, plain PyTorch as in the JAX package).

Dispatch rule shared by every kernel wrapper (``bta``, ``flash``,
``selection``, ``epilogue``, forward and backward): a CPU tensor runs the
kernel's plain PyTorch version, a CUDA tensor launches the CUDA kernel or
raises.  There is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from repro_torch.numerics import NEG_INF

__all__ = ["LSE_EMPTY", "resolve_compute_dtype", "mma_dtype", "lse_finalize",
           "p_from_lse", "row_delta", "LaunchCounter", "COUNTERS", "reset_counters",
           "on_cpu", "check_cuda_inputs", "SUPPORTED_HEAD_DIMS"]

# Sentinel logsumexp for query rows with NO valid key: exp(s − LSE_EMPTY)
# underflows to exactly 0 for any finite logit s.
LSE_EMPTY = 1e30

# head dims the CUDA kernels are instantiated for (csrc/*.cu dispatch)
SUPPORTED_HEAD_DIMS = (16, 32, 64)


def resolve_compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """Input dtype → matmul-operand dtype of the kernels.

    fp32 (and wider) inputs compute in fp32; bf16/fp16 inputs keep their
    storage dtype as the QKᵀ and PV operand dtype while every product
    accumulates in fp32 and the softmax statistics stay fp32.  (The JAX
    package's ``REPRO_FP8`` experiment is not ported.)"""
    if dtype.itemsize >= 4:
        return torch.float32
    return dtype


def mma_dtype(compute: torch.dtype) -> torch.dtype:
    """Operand dtype for the non-QKᵀ matmuls (PV); never below 16 bits."""
    return torch.bfloat16 if compute.itemsize == 1 else compute


def lse_finalize(m_safe: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """Per-row logsumexp residual from the running max and sum (fp32)."""
    return torch.where(l > 0.0, m_safe + torch.log(torch.clamp(l, min=1e-30)),
                       torch.full_like(l, LSE_EMPTY))


def p_from_lse(s: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """Recompute normalised attention probabilities from logits + residual."""
    p = torch.exp(s - lse)
    return torch.where(s <= NEG_INF / 2, torch.zeros_like(p), p)


def row_delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """δ = Σ_D dO·O per query row, fp32: the softmax backward's row term."""
    return (do.float() * o.float()).sum(-1)


class LaunchCounter:
    """How many times one CUDA kernel was launched.

    Each wrapper calls :meth:`hit` right where it launches its kernel and
    nowhere else, so a run can show that a path really went through the
    kernel (``chip_smoke.py`` resets, drives the model, then reads)."""

    def __init__(self):
        self.n = 0

    def hit(self) -> None:
        self.n += 1

    def reset(self) -> None:
        self.n = 0


COUNTERS: dict[str, LaunchCounter] = {}


def _counter(name: str) -> LaunchCounter:
    COUNTERS[name] = LaunchCounter()
    return COUNTERS[name]


def reset_counters() -> None:
    for c in COUNTERS.values():
        c.reset()


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (→ the plain version runs);
    False when every one is a CUDA tensor (→ the kernel launches).  Any
    other device, or a mix, raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("kernel inputs lie on different CUDA devices: "
                             f"{sorted({str(t.device) for t in tensors})}")
        return False
    raise ValueError(f"kernel inputs must all lie on the CPU or all on one "
                     f"CUDA device, got {sorted(kinds)}")


def check_cuda_inputs(name: str, *, data=(), f32=(), i32=(),
                      head_dim: int | None = None) -> None:
    """Raise on anything the CUDA kernel ``name`` does not take.

    ``data``: operand tensors that must share one dtype, fp32 or bf16;
    ``f32`` / ``i32``: side inputs of fixed dtype.  Every tensor must be
    contiguous."""
    dts = {t.dtype for t in data}
    if len(dts) > 1:
        raise TypeError(f"{name}: operands must share one dtype, got {dts}")
    if dts and next(iter(dts)) not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, "
                        f"got {next(iter(dts))}")
    for t in f32:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected a float32 side input, got {t.dtype}")
    for t in i32:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected an int32 side input, got {t.dtype}")
    for t in (*data, *f32, *i32):
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if head_dim is not None and head_dim not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {head_dim} not built "
                         f"(kernels take {SUPPORTED_HEAD_DIMS})")
