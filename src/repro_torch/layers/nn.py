"""Minimal NN layers: dense, RMSNorm, SwiGLU.

Counterpart of ``repro/layers/nn.py``.  Layers are ``nn.Module``s whose
parameter names mirror the JAX pytree keys (``w``, ``b``, ``g``), so
``repro_torch.convert.params_from_jax`` can load a JAX parameter tree by
name.  One difference in storage: a ``Dense`` weight is (d_out, d_in), the
PyTorch habit, where JAX stores (d_in, d_out).

Initialisation follows the JAX package's distributions (He-normal dense
weights, zero biases, unit norm gains) from an explicit ``torch.Generator``;
the two frameworks draw different numbers from the same seed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["he_scale", "Dense", "dense", "RMSNorm", "rmsnorm", "SwiGLU", "swiglu"]


def he_scale(fan_in: int) -> float:
    return (2.0 / max(fan_in, 1)) ** 0.5


class Dense(nn.Module):
    """y = x wᵀ + b.  ``w``: (d_out, d_in); ``b``: (d_out,) when ``bias``."""

    def __init__(self, d_in: int, d_out: int, *, generator: torch.Generator,
                 scale: float | None = None, bias: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        if scale is None:
            scale = he_scale(d_in)
        w = torch.randn((d_out, d_in), generator=generator) * scale
        self.w = nn.Parameter(w.to(dtype=dtype, device=device))
        self.b = (nn.Parameter(torch.zeros(d_out, dtype=dtype, device=device))
                  if bias else None)

    def forward(self, x):
        return dense(self, x)


def dense(p, x: torch.Tensor) -> torch.Tensor:
    """x @ wᵀ (+ b): the weight is cast to x's dtype, the product accumulates
    in fp32, the bias adds in fp32, and the result returns in x's dtype."""
    w = p.w.to(x.dtype)
    if x.dtype == torch.float32:
        y = F.linear(x, w)
    else:                       # exact widened products, fp32 accumulation
        y = F.linear(x.float(), w.float())
    if p.b is not None:
        y = y + p.b.float()
    return y.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, eps: float = 1e-5, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(d, dtype=dtype, device=device))

    def forward(self, x):
        return rmsnorm(self, x, self.eps)


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    scale = torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * p.g.to(x.dtype)


class SwiGLU(nn.Module):
    def __init__(self, d_model: int, d_ff: int, *, generator: torch.Generator,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.gate = Dense(d_model, d_ff, **kw)
        self.up = Dense(d_model, d_ff, **kw)
        self.down = Dense(d_ff, d_model, scale=he_scale(d_ff), **kw)

    def forward(self, x):
        return swiglu(self, x)


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    g = dense(p.gate, x)
    u = dense(p.up, x)
    h = F.silu(g.float()).to(x.dtype) * u
    return dense(p.down, h)
