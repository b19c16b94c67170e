"""Minimal NN layers: dense, RMSNorm, SwiGLU, a two-layer GELU MLP, token
embedding.

Counterpart of ``repro/layers/nn.py``.  Layers are ``nn.Module``s whose
parameter names mirror the JAX pytree keys (``w``, ``b``, ``g``), so
``repro_torch.convert.params_from_jax`` can load a JAX parameter tree by
name.  One difference in storage: a ``Dense`` weight is (d_out, d_in), the
PyTorch habit, where JAX stores (d_in, d_out).

Under tensor parallelism (``distributed/tensor_parallel.py``: a weight
that ``runtime.Trainer`` holds as this rank's part over the ``model``
axis) :func:`column_dense` and :func:`row_dense` are ``dense`` on a weight
cut on its output or its input dim; :func:`swiglu` and :func:`mlp` run
their first products as column products and the last as a row product,
:func:`embed` looks up the ids of this rank's vocabulary rows, and
:func:`unembed` gives this rank's vocabulary columns; on whole weights
they are the one-card functions.

Initialisation follows the JAX package's distributions (He-normal dense
weights, zero biases, unit norm gains, N(0, 1/d) embeddings) from an
explicit ``torch.Generator``, drawn on the generator's device; the two
frameworks draw different numbers from the same seed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import tensor_parallel as tp

__all__ = ["he_scale", "Dense", "dense", "column_dense", "row_dense", "RMSNorm", "rmsnorm",
           "SwiGLU", "swiglu", "MLP", "mlp", "Embed", "embed", "unembed"]


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
        w = torch.randn((d_out, d_in), generator=generator,
                        device=generator.device) * scale
        self.w = nn.Parameter(w.to(dtype=dtype, device=device))
        self.b = (nn.Parameter(torch.zeros(d_out, dtype=dtype, device=device))
                  if bias else None)

    def forward(self, x):
        return dense(self, x)


def _product(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x @ wᵀ in fp32, the weight cast to x's dtype first."""
    w = w.to(x.dtype)
    if x.dtype == torch.float32:
        return F.linear(x, w)
    return F.linear(x.float(), w.float())   # exact widened products, fp32 accumulation


def dense(p, x: torch.Tensor) -> torch.Tensor:
    """x @ wᵀ (+ b): the weight is cast to x's dtype, the product accumulates
    in fp32, the bias adds in fp32, and the result returns in x's dtype."""
    y = _product(p.w, x)
    if p.b is not None:
        y = y + p.b.float()
    return y.to(x.dtype)


def column_dense(layers, x: torch.Tensor) -> tuple:
    """:func:`dense` of each layer of ``layers`` on ``x``; where their
    weights are cut over ``model`` on the output dim, this rank's columns,
    with one ``tensor_parallel.copy_to_model`` of ``x`` for all of them.
    A bias that stays whole (``param_shardings`` cuts no vector) adds its
    entries of this rank's columns, its gradient summed over ``model``."""
    dims = {tp.cut_dim(p.w) for p in layers}
    if dims == {None}:
        return tuple(dense(p, x) for p in layers)
    if dims != {0}:
        raise ValueError(f"column_dense: weights cut on dims {dims}, not all on the output")
    ax = tp.axis()
    xc = tp.copy_to_model(ax, x)
    out = []
    for p in layers:
        y = _product(p.w, xc)
        b = p.b
        if b is not None and tp.cut_dim(b) is None:
            n = y.shape[-1]
            b = tp.copy_to_model(ax, b).narrow(0, ax.index * n, n)
        if b is not None:
            y = y + b.float()
        out.append(y.to(x.dtype))
    return tuple(out)


def row_dense(p, x: torch.Tensor) -> torch.Tensor:
    """:func:`dense` where the weight is cut over ``model`` on its input dim
    and ``x`` holds this rank's input features: the partial products in
    fp32, summed over ``model``, the bias added once after the sum, the
    result in x's dtype."""
    dim = tp.cut_dim(p.w)
    if dim is None:
        return dense(p, x)
    if dim != 1:
        raise ValueError("row_dense: the weight is not cut on its input dim")
    y = tp.reduce_from_model(tp.axis(), _product(p.w, x))
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
    """down(silu(gate(x)) · up(x)); gate / up column and down row products
    where the weights are cut over ``model``."""
    g, u = column_dense((p.gate, p.up), x)
    h = F.silu(g.float()).to(x.dtype) * u
    return row_dense(p.down, h)


class MLP(nn.Module):
    """``fc1`` d_in → d_hidden and ``fc2`` d_hidden → d_out, both with bias;
    fc2's weights He-scaled by d_hidden."""

    def __init__(self, d_in: int, d_hidden: int, d_out: int, *,
                 generator: torch.Generator, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(generator=generator, bias=True, dtype=dtype, device=device)
        self.fc1 = Dense(d_in, d_hidden, **kw)
        self.fc2 = Dense(d_hidden, d_out, scale=he_scale(d_hidden), **kw)

    def forward(self, x):
        return mlp(self, x)


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    """fc2(GELU(fc1(x))): the tanh form of GELU (``jax.nn.gelu``'s default),
    in fp32, cast back to x's dtype.  ``p`` carries ``fc1`` and ``fc2``;
    fc1 a column and fc2 a row product where they are cut over ``model``."""
    h = F.gelu(column_dense((p.fc1,), x)[0].float(), approximate="tanh").to(x.dtype)
    return row_dense(p.fc2, h)


class Embed(nn.Module):
    """Token embedding ``table`` (vocab, d_model), N(0, 1/d_model)."""

    def __init__(self, vocab: int, d_model: int, *, generator: torch.Generator,
                 dtype=torch.float32, device=None):
        super().__init__()
        t = torch.randn((vocab, d_model), generator=generator,
                        device=generator.device) * (1.0 / d_model ** 0.5)
        self.table = nn.Parameter(t.to(dtype=dtype, device=device))


def embed(p, ids: torch.Tensor, dtype=None) -> torch.Tensor:
    """Rows of the table for ``ids`` (any shape), cast to ``dtype``.  With
    the table cut over ``model`` (vocabulary-parallel): this rank looks up
    the ids in its range of rows, writes zeros for the others, and the
    ranks' rows are summed (one rank's row and zeros: exact)."""
    t = p.table if dtype is None else p.table.to(dtype)
    if tp.cut_dim(p.table) is None:
        return t[ids.long()]
    ax = tp.axis()
    rows = t.shape[0]
    local = ids.long() - ax.index * rows
    hit = (local >= 0) & (local < rows)
    x = t[local.clamp(0, rows - 1)]
    return tp.reduce_from_model(ax, torch.where(hit[..., None], x, torch.zeros_like(x)))


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    """Tied logits projection x (…, d) · tableᵀ → (…, vocab), fp32; with
    the table cut over ``model``, this rank's vocabulary columns."""
    if tp.cut_dim(p.table) is not None:
        x = tp.copy_to_model(tp.axis(), x)
    return torch.matmul(x.float(), p.table.to(x.dtype).float().t())
