"""The paper's model: n_layers × [RMSNorm → BSA → RMSNorm → SwiGLU] on
ball-ordered point clouds, with a linear regression head.

Counterpart of ``repro/models/pointcloud.py`` (``pc_init``, ``pc_apply``,
``pc_loss``).
The JAX version stacks the layers' parameters and runs them under
``lax.scan``; here they are an ``nn.ModuleList`` walked by a Python loop.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.layers.nn import Dense, RMSNorm, SwiGLU, dense, rmsnorm, swiglu
from repro_torch.models.attention_layer import AttentionLayer, attention_layer_apply

__all__ = ["PCLayer", "PointCloudModel", "pc_init", "pc_layer", "pc_apply",
           "pc_loss"]


class PCLayer(nn.Module):
    def __init__(self, mcfg, *, generator, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = RMSNorm(mcfg.d_model, eps=mcfg.norm_eps, **kw)
        self.attn = AttentionLayer(mcfg, generator=generator, **kw)
        self.norm2 = RMSNorm(mcfg.d_model, eps=mcfg.norm_eps, **kw)
        self.ffn = SwiGLU(mcfg.d_model, mcfg.d_ff, generator=generator, **kw)


class PointCloudModel(nn.Module):
    """Parameters of the point-cloud regressor; names mirror the JAX pytree
    (``embed``, ``layers``, ``final_norm``, ``head``)."""

    def __init__(self, mcfg, *, generator: torch.Generator, device=None):
        super().__init__()
        self.mcfg = mcfg
        kw = dict(generator=generator, dtype=mcfg.pdtype(), device=device)
        self.embed = Dense(mcfg.in_dim, mcfg.d_model, bias=True, **kw)
        self.layers = nn.ModuleList(PCLayer(mcfg, **kw) for _ in range(mcfg.n_layers))
        self.final_norm = RMSNorm(mcfg.d_model, eps=mcfg.norm_eps,
                                  dtype=mcfg.pdtype(), device=device)
        self.head = Dense(mcfg.d_model, mcfg.out_dim, scale=0.02, bias=True, **kw)

    def forward(self, feats, mask=None):
        return pc_apply(self, feats, mcfg=self.mcfg, mask=mask)


def pc_init(mcfg, *, generator: torch.Generator, device) -> PointCloudModel:
    return PointCloudModel(mcfg, generator=generator, device=device)


def pc_layer(lp: PCLayer, x, *, mcfg, mask=None) -> torch.Tensor:
    """One block: x + BSA(norm(x)), then + SwiGLU(norm(x))."""
    h = rmsnorm(lp.norm1, x, mcfg.norm_eps)
    x = x + attention_layer_apply(lp.attn, h, mcfg=mcfg, mask=mask)
    h = rmsnorm(lp.norm2, x, mcfg.norm_eps)
    return x + swiglu(lp.ffn, h)


def pc_apply(params: PointCloudModel, feats, *, mcfg, mask=None) -> torch.Tensor:
    """feats: (B, N, in_dim) ball-ordered; mask: (B, N) bool.  → (B, N,
    out_dim) fp32, differentiable (the serving entry points call it under
    ``torch.no_grad()``)."""
    x = dense(params.embed, feats.to(mcfg.cdtype()))
    for lp in params.layers:
        x = pc_layer(lp, x, mcfg=mcfg, mask=mask)
    x = rmsnorm(params.final_norm, x, mcfg.norm_eps)
    return dense(params.head, x).float()


def pc_loss(params: PointCloudModel, batch: dict, *, mcfg):
    """batch: {feats (B, N, F), target (B, N, out_dim), mask (B, N)} →
    (masked MSE, {"mse": MSE}): the squared error summed over real points,
    divided by max(mask.sum()·out_dim, 1)."""
    pred = pc_apply(params, batch["feats"], mcfg=mcfg, mask=batch.get("mask"))
    err = (pred - batch["target"].float()) ** 2
    m = batch.get("mask")
    if m is not None:
        err = torch.where(m[..., None], err, torch.zeros_like(err))
        denom = torch.clamp(m.sum() * mcfg.out_dim, min=1)
    else:
        denom = err.numel()
    loss = err.sum() / denom
    return loss, {"mse": loss}
