"""The train step: loss → backward → global-norm clipping → AdamW.

Counterpart of ``repro/launch/steps.py::make_train_step``.  The JAX step is
a pure function returning new parameters; this one updates the model's
parameters and the optimizer state in place (and returns them, so the two
read alike).  It runs on the device of the model and the batch: the
attention ops take their CUDA forward and backward kernels there.
"""

from __future__ import annotations

import torch

from repro_torch.optim import adamw_update, clip_by_global_norm, cosine_schedule

__all__ = ["make_train_step"]


def make_train_step(api, *, base_lr=1e-3, weight_decay=0.01, total_steps=100_000,
                    warmup_steps=1000, max_grad_norm=1.0):
    """(model, opt_state, batch) → (model, opt_state, metrics) with metrics
    ``loss``, ``grad_norm`` (device tensors, before clipping) and ``lr``
    (float).  The schedule is read at the step count before the update, so
    the first warm-up step has lr 0, as in the JAX step.  After the step
    each parameter's ``.grad`` holds its clipped gradient."""

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        model.zero_grad(set_to_none=True)
        loss, metrics = api.loss(model, batch)
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        _, gnorm = clip_by_global_norm(list(grads.values()), max_grad_norm)
        lr = cosine_schedule(opt_state["step"], base_lr=base_lr,
                             total_steps=total_steps, warmup_steps=warmup_steps)
        opt_state = adamw_update(params, grads, opt_state, lr=lr,
                                 weight_decay=weight_decay)
        out = {"loss": loss.detach(), "grad_norm": gnorm, "lr": lr}
        out.update({k: v.detach() for k, v in metrics.items() if v.ndim == 0})
        return model, opt_state, out

    return train_step
