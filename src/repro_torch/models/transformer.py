"""Decoder-only LM backbone, dense family.

Counterpart of ``repro/models/transformer.py`` for the dense family
(tinyllama's period of one [attention, dense SwiGLU] layer): ``layer_spec``,
``lm_init``, ``lm_apply``, the dense-cache decode (``lm_cache_init``,
``lm_decode_step``) and the paged decode (``lm_paged_cache_init``,
``lm_paged_decode_step``, ``lm_paged_cache_copy_block``,
``lm_paged_cache_reset_slot``).  The JAX version stacks the parameters of
the periods and runs them under ``lax.scan``; here the periods are an
``nn.ModuleList`` walked by a Python loop, each period a module whose
layers are named ``pos0``, ``pos1``, … as the JAX pytree's keys, so a JAX
tree loads by name (``convert.params_from_jax``).  ``lm_loss`` is the
training loss; with ``mcfg.remat`` each period runs under
``torch.utils.checkpoint`` when autograd records (JAX's
``jax.checkpoint`` with the ``nothing_saveable`` policy): its forward runs
again in the backward, under the attention backend the forward used.  Caches are a list over
periods of dicts (one per ``pos``) of tensors, updated in place.  The MoE
and mamba mixers (the moe / ssm / hybrid families) are not ported yet.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.backend import active_backend, use_backend
from repro_torch.core.nsa_causal import dense_step, paged_step
from repro_torch.layers.losses import masked_mean_nll
from repro_torch.layers.nn import (Dense, Embed, RMSNorm, SwiGLU, dense, embed, rmsnorm,
                                   swiglu, unembed)
from repro_torch.models.attention_layer import (AttentionLayer, attention_cache_init,
                                                attention_layer_apply,
                                                attention_layer_decode,
                                                attention_layer_decode_paged,
                                                attention_paged_cache_init)

__all__ = ["layer_spec", "n_periods", "LanguageModel", "lm_init", "lm_apply", "lm_loss",
           "lm_cache_init", "lm_decode_step", "lm_paged_cache_init",
           "lm_paged_decode_step", "lm_has_recurrent_state", "lm_paged_cache_reset_slot",
           "lm_paged_cache_copy_block"]


def layer_spec(mcfg) -> list[tuple[str, str]]:
    """[(mixer, ffn)] of one period."""
    if mcfg.family != "dense":
        raise NotImplementedError(
            f"family {mcfg.family!r} (MoE / mamba mixers) is not ported yet: it comes "
            "with the other model families (ROADMAP queue 1 item 2)")
    return [("attn", "dense" if mcfg.d_ff else "none")]


def n_periods(mcfg) -> int:
    P = len(layer_spec(mcfg))
    if mcfg.n_layers % P:
        raise ValueError(f"n_layers={mcfg.n_layers} is not a multiple of the period {P}")
    return mcfg.n_layers // P


class LMLayer(nn.Module):
    """One (mixer, ffn) position of a period: RMSNorm → attention, RMSNorm →
    SwiGLU."""

    def __init__(self, mcfg, ffn: str, *, generator, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = RMSNorm(mcfg.d_model, eps=mcfg.norm_eps, **kw)
        self.attn = AttentionLayer(mcfg, generator=generator, **kw)
        if ffn != "none":
            self.norm2 = RMSNorm(mcfg.d_model, eps=mcfg.norm_eps, **kw)
            self.ffn = SwiGLU(mcfg.d_model, mcfg.d_ff, generator=generator, **kw)


class LMPeriod(nn.Module):
    def __init__(self, mcfg, *, generator, dtype, device):
        super().__init__()
        for i, (_, ffn) in enumerate(layer_spec(mcfg)):
            setattr(self, f"pos{i}", LMLayer(mcfg, ffn, generator=generator, dtype=dtype,
                                             device=device))

    def positions(self):
        return [getattr(self, f"pos{i}") for i in range(len(self._modules))]


class LanguageModel(nn.Module):
    """Parameters of the LM; names mirror the JAX pytree (``embed.table``,
    ``layers`` of periods with ``pos0``…, ``final_norm``, ``lm_head``)."""

    def __init__(self, mcfg, *, generator: torch.Generator, device=None):
        super().__init__()
        self.mcfg = mcfg
        kw = dict(generator=generator, dtype=mcfg.pdtype(), device=device)
        self.embed = Embed(mcfg.vocab_size, mcfg.d_model, **kw)
        self.layers = nn.ModuleList(LMPeriod(mcfg, **kw) for _ in range(n_periods(mcfg)))
        self.final_norm = RMSNorm(mcfg.d_model, eps=mcfg.norm_eps, dtype=mcfg.pdtype(),
                                  device=device)
        if not mcfg.tie_embeddings:
            self.lm_head = Dense(mcfg.d_model, mcfg.vocab_size, scale=0.02, **kw)


def lm_init(mcfg, *, generator: torch.Generator, device) -> LanguageModel:
    return LanguageModel(mcfg, generator=generator, device=device)


def _logits(params: LanguageModel, x, mcfg) -> torch.Tensor:
    x = rmsnorm(params.final_norm, x, mcfg.norm_eps)
    if mcfg.tie_embeddings:
        return unembed(params.embed, x)
    return dense(params.lm_head, x).float()


def lm_layer(lp: LMLayer, x, *, mcfg, mask=None, positions=None) -> torch.Tensor:
    """One position of a period, full sequence: x + attn(norm(x)), then
    + SwiGLU(norm(x))."""
    h = rmsnorm(lp.norm1, x, mcfg.norm_eps)
    x = x + attention_layer_apply(lp.attn, h, mcfg=mcfg, causal=True, mask=mask,
                                  positions=positions)
    if hasattr(lp, "ffn"):
        x = x + swiglu(lp.ffn, rmsnorm(lp.norm2, x, mcfg.norm_eps))
    return x


def _period_apply(period: LMPeriod, x, positions, *, mcfg, mask=None,
                  backend: str | None = None) -> torch.Tensor:
    # ``backend``: the forward's ``use_backend``, re-entered when the
    # checkpointed period runs again on autograd's thread
    with use_backend(backend) if backend else contextlib.nullcontext():
        for lp in period.positions():
            x = lm_layer(lp, x, mcfg=mcfg, mask=mask, positions=positions)
    return x


def lm_apply(params: LanguageModel, tokens, *, mcfg, mask=None,
             positions=None) -> torch.Tensor:
    """tokens: (B, N) int → logits (B, N, V) fp32.  Differentiable (the
    serving entry points call it under ``torch.inference_mode()``).  The JAX
    version also returns the MoE auxiliary loss, 0 for the dense family."""
    x = embed(params.embed, tokens, dtype=mcfg.cdtype())
    B, N, _ = x.shape
    if positions is None:
        positions = torch.arange(N, device=x.device)[None].expand(B, N)
    remat = mcfg.remat and torch.is_grad_enabled()
    for period in params.layers:
        if remat:
            x = checkpoint(_period_apply, period, x, positions, mcfg=mcfg, mask=mask,
                           backend=active_backend(), use_reentrant=False)
        else:
            x = _period_apply(period, x, positions, mcfg=mcfg, mask=mask)
    return _logits(params, x, mcfg)


def lm_loss(params: LanguageModel, batch: dict, *, mcfg):
    """batch: {tokens (B, N), labels (B, N)[, loss_mask (B, N)]} →
    (loss + 0.01·aux_loss, {"loss", "aux_loss"}); the auxiliary (MoE) loss
    is a 0-d fp32 zero for the dense family, as in JAX."""
    logits = lm_apply(params, batch["tokens"], mcfg=mcfg)
    loss = masked_mean_nll(logits, batch["labels"], batch.get("loss_mask"))
    aux_loss = torch.zeros((), dtype=torch.float32, device=logits.device)
    return loss + 0.01 * aux_loss, {"loss": loss, "aux_loss": aux_loss}


# ---------------------------------------------------------------------------
# Decode: dense caches (lockstep) and paged pools (continuous batching)
# ---------------------------------------------------------------------------

def lm_cache_init(mcfg, batch: int, max_len: int, dtype=torch.bfloat16,
                  device=None) -> list:
    """Per period, per position: the layer's dense decode cache."""
    return [{f"pos{i}": attention_cache_init(mcfg, batch, max_len, dtype, device)
             for i in range(len(layer_spec(mcfg)))} for _ in range(n_periods(mcfg))]


def _decode(params: LanguageModel, token, caches, mcfg, attend,
            layer_input=None) -> tuple:
    """One decode step through the stack; ``attend(attn, h, cache)`` is the
    layer's attention decode (its addressing built once for the step).
    ``layer_input(n, x)``, when given, returns what the stack's n-th layer
    takes in place of ``x`` (a teacher-forced check feeds it the forward's
    input at the slot's position)."""
    x1 = embed(params.embed, token[:, None], dtype=mcfg.cdtype())      # (B,1,d)
    new, n = [], 0
    for period, pc in zip(params.layers, caches):
        nc = {}
        for i, lp in enumerate(period.positions()):
            if layer_input is not None:
                x1 = layer_input(n, x1)
            n += 1
            h, nc[f"pos{i}"] = attend(lp.attn, rmsnorm(lp.norm1, x1, mcfg.norm_eps),
                                      pc[f"pos{i}"])
            x1 = x1 + h
            if hasattr(lp, "ffn"):
                x1 = x1 + swiglu(lp.ffn, rmsnorm(lp.norm2, x1, mcfg.norm_eps))
        new.append(nc)
    return _logits(params, x1, mcfg)[:, 0], new


def lm_decode_step(params: LanguageModel, token, caches, *, mcfg):
    """token: (B,) int → (logits (B, V) fp32, caches)."""
    step = dense_step(caches[0]["pos0"], mcfg.bsa)
    return _decode(params, token, caches, mcfg,
                   lambda p, h, c: attention_layer_decode(p, h, c, mcfg=mcfg, step=step))


def lm_paged_cache_init(mcfg, batch: int, num_blocks: int, page: int,
                        dtype=torch.bfloat16, device=None) -> list:
    """Per period, per position: the layer's paged pools, one block layout
    for every layer (one host block table serves the stack)."""
    return [{f"pos{i}": attention_paged_cache_init(mcfg, num_blocks, page, dtype, device)
             for i in range(len(layer_spec(mcfg)))} for _ in range(n_periods(mcfg))]


def lm_paged_decode_step(params: LanguageModel, token, caches, table, lengths, *, mcfg,
                         page: int, layer_input=None):
    """token: (B,) int; table (B, n_pages); lengths (B,) per-slot positions
    → (logits (B, V) fp32, caches).  Lengths are not advanced (the host
    owns them).  ``layer_input``: see :func:`_decode`."""
    step = paged_step(table, lengths, cfg=mcfg.bsa, page=page)
    return _decode(params, token, caches, mcfg,
                   lambda p, h, c: attention_layer_decode_paged(p, h, c, table, lengths,
                                                                mcfg=mcfg, page=page,
                                                                step=step),
                   layer_input)


def lm_has_recurrent_state(mcfg) -> bool:
    """True when a mixer carries unpaged per-slot state (mamba); never for
    the dense family."""
    return any(mixer != "attn" for mixer, _ in layer_spec(mcfg))


def lm_paged_cache_reset_slot(mcfg, caches, slot):
    """Zero a slot's recurrent state on admission: attention pools need no
    reset (every read is masked to positions the slot has written), so for
    attention-only stacks this returns ``caches`` unchanged."""
    if lm_has_recurrent_state(mcfg):
        raise NotImplementedError("recurrent (mamba) state is not ported yet")
    return caches


@torch.no_grad()
def lm_paged_cache_copy_block(mcfg, caches, src: int, dst: int, *, page: int):
    """Copy pool block ``src`` → ``dst`` in every attention layer's pools
    (token rows and compressed rows), in place: the device half of
    copy-on-write."""
    cpp = page // mcfg.bsa.cmp_block
    for pc in caches:
        for c in pc.values():
            for key, t in c.items():
                rows = page if key in ("k", "v") else cpp
                t[dst * rows:(dst + 1) * rows] = t[src * rows:(src + 1) * rows]
    return caches
