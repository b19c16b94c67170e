"""Gradient compression for the slow cross-pod reduction.

Counterpart of ``repro/optim/compress.py``.  int8 block-quantized
all-gather-sum with ERROR FEEDBACK: instead of a bf16 all-reduce over the
``pod`` axis, each pod quantizes its gradient to int8 (one scale a block
of 256), all-gathers the int8 payload and the scales, and sums locally in
the order of the gather.  The quantization residual is carried to the
next step's gradient (EF-SGD).  ``round`` is half-to-even in both
packages, so the payload is the same int8 bits.  gloo and NCCL both move
int8 tensors (``comm.all_gather`` moves bits only).
"""

from __future__ import annotations

import torch

from repro_torch.distributed import comm

__all__ = ["BLOCK", "compressed_psum", "make_compressed_grad_fn"]

BLOCK = 256


def _quantize(g: torch.Tensor):
    """per-block int8 quantization; returns (q, scale, residual)."""
    flat = g.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    deq = (q.float() * scale).reshape(flat.shape)[:g.numel()].reshape(g.shape)
    return q, scale.float(), g - deq


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape)


def compressed_psum(g: torch.Tensor, err: torch.Tensor, ax):
    """Error-feedback int8 'psum' over the ranks of ``ax`` (a
    ``Mesh.axis_group``).  Returns (summed gradient ≈ Σ g, new residual)."""
    g = g + err                                  # error feedback
    q, scale, residual = _quantize(g)
    q_all = comm.all_gather(q, ax)               # int8 on the wire
    s_all = comm.all_gather(scale, ax)
    total = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
    for qi, si in zip(q_all, s_all):             # in the order of the gather
        total = total + _dequantize(qi, si, g.shape)
    return total.to(g.dtype), residual


def make_compressed_grad_fn(loss_fn, mesh, *, axis_name: str = "pod"):
    """A per-pod gradient with the compressed cross-pod reduction:
    ``fn(model, batch, err) → (loss, grads, new_err)``.  Gradients w.r.t.
    the model's parameters, which every pod holds whole; ``batch`` is the
    global batch, of which each pod takes its slice along dim 0; ``err``
    maps each parameter name to its residual (zeros at the first step).
    ``loss`` is the mean of the pods' losses, ``grads`` (name → tensor) the
    compressed sum over the pods divided by their number.  ``loss_fn(model,
    batch) → (loss, aux)``, as ``ModelAPI.loss``."""
    ax = mesh.axis_group(axis_name)

    def per_pod(model, batch, err):
        mine = {k: comm.local_slice(v, ax, 0) if isinstance(v, torch.Tensor) else v
                for k, v in batch.items()}
        params = dict(model.named_parameters())
        loss, _ = loss_fn(model, mine)
        got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads, new_err = {}, {}
        for (name, p), g in zip(params.items(), got):
            g = torch.zeros_like(p) if g is None else g
            total, new_err[name] = compressed_psum(g, err[name], ax)
            grads[name] = total / ax.size
        loss = comm.all_reduce_sum(loss.detach(), ax) / ax.size
        return loss, grads, new_err

    return per_pod
