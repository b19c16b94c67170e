"""Step functions: the train step, the prefill step and the serve steps.

Counterpart of ``repro/launch/steps.py``.  ``make_train_step``: loss →
backward → global-norm clipping → AdamW.  The JAX step is a pure function
returning new parameters; this one updates the model's parameters and the
optimizer state in place (and returns them, so the two read alike).
``make_prefill_step``, ``make_serve_step``, ``make_paged_serve_step`` and
``make_paged_serve_window`` are the LM serving steps: they run under
``torch.inference_mode()`` (no autograd bookkeeping, which is most of a
decode step's host time) and update the caches in place.  Every step runs on the device of the model
and its inputs: the attention ops take their CUDA kernels there.  The JAX
package jits each step once; PyTorch runs them eagerly.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.sharding import batch_total
from repro_torch.optim import adamw_update, clip_by_global_norm, cosine_schedule

__all__ = ["make_train_step", "make_prefill_step", "make_serve_step",
           "make_paged_serve_step", "make_paged_serve_window"]


def make_train_step(api, *, base_lr=1e-3, weight_decay=0.01, total_steps=100_000,
                    warmup_steps=1000, max_grad_norm=1.0, update=None, grad_norm=None):
    """(model, opt_state, batch) → (model, opt_state, metrics) with metrics
    ``loss``, ``grad_norm`` (device tensors, before clipping) and ``lr``
    (float).  The schedule is read at the step count before the update, so
    the first warm-up step has lr 0, as in the JAX step.  After the step
    each parameter's ``.grad`` holds its clipped gradient.

    Where ``sharding.axis_rules`` split the batch across ranks
    (``runtime.Trainer`` with a mesh), the gradients, the loss and the
    scalar metrics are summed over those ranks (``sharding.batch_total``;
    on one rank it returns its input untouched).  ``update(params, grads,
    opt_state, lr) → opt_state`` takes the place of the AdamW update on the
    whole parameters (the mesh ``Trainer`` updates this rank's parts), and
    ``grad_norm(grads) → norm`` that of the global norm the clip reads (the
    mesh ``Trainer``'s is the whole gradient's where the parameters are
    held as their parts over ``model``)."""

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        model.zero_grad(set_to_none=True)
        loss, metrics = api.loss(model, batch)
        loss.backward()
        grads = batch_total({n: p.grad if p.grad is not None else torch.zeros_like(p)
                             for n, p in params.items()})
        _, gnorm = clip_by_global_norm(list(grads.values()), max_grad_norm,
                                       norm=None if grad_norm is None else grad_norm(grads))
        lr = cosine_schedule(opt_state["step"], base_lr=base_lr,
                             total_steps=total_steps, warmup_steps=warmup_steps)
        if update is None:
            opt_state = adamw_update(params, grads, opt_state, lr=lr,
                                     weight_decay=weight_decay)
        else:
            opt_state = update(params, grads, opt_state, lr)
        out = {"loss": batch_total(loss.detach()), "grad_norm": gnorm, "lr": lr}
        out.update({k: batch_total(v.detach()) for k, v in metrics.items() if v.ndim == 0})
        return model, opt_state, out

    return train_step


def make_prefill_step(api):
    """(model, batch) → last-position logits (B, V) fp32."""

    @torch.inference_mode()
    def prefill_step(model, batch):
        return api.forward(model, batch)[:, -1].float()

    return prefill_step


def make_serve_step(api):
    """(model, caches, token (B,)) → (next_token (B,), logits (B, V), caches):
    one greedy decode step over the dense caches."""

    @torch.inference_mode()
    def serve_step(model, caches, token):
        logits, caches = api.decode_step(model, token, caches)
        return logits.argmax(-1).to(torch.int32), logits, caches

    return serve_step


def make_paged_serve_step(api, *, page: int):
    """The continuous-batching decode step (block-table addressing):
    (model, caches, token (B,), table (B, n_pages), lengths (B,)) →
    (next_token (B,), logits (B, V), caches)."""

    @torch.inference_mode()
    def paged_serve_step(model, caches, token, table, lengths):
        logits, caches = api.paged_decode_step(model, token, caches, table, lengths, page)
        return logits.argmax(-1).to(torch.int32), logits, caches

    return paged_serve_step


def make_paged_serve_window(api, *, page: int):
    """W greedy continuous-batching steps with the samples kept on the
    device: nothing in the loop waits for the card.  Per-step feeds are
    data: ``feed (W, B)`` holds prompt tokens and ``use_prev (W, B)``
    switches a slot to feeding its previous sample once its prompt is
    spent, so prefill turns into decode inside the window.  ``occ (B,)``
    advances only the occupied slots' lengths.

    (model, caches, feed (W, B), use_prev (W, B) bool, prev (B,), table
    (B, n_pages), lengths (B,), occ (B,)) → (samples (W, B) int32, caches)."""

    @torch.inference_mode()
    def paged_serve_window(model, caches, feed, use_prev, prev, table, lengths, occ):
        samples = []
        for feed_t, use_t in zip(feed, use_prev):
            tok = torch.where(use_t, prev, feed_t)
            logits, caches = api.paged_decode_step(model, tok, caches, table, lengths,
                                                   page)
            prev = logits.argmax(-1).to(torch.int32)
            samples.append(prev)
            lengths = lengths + occ
        return torch.stack(samples), caches

    return paged_serve_window
