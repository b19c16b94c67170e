"""Decoder-only LM backbone: the dense, MoE, SSM and hybrid families.

Counterpart of ``repro/models/transformer.py``.  Layers come in periods, the
smallest repeating pattern of (mixer, ffn) pairs (``layer_spec``):
tinyllama's [attention, dense SwiGLU], qwen2-moe's [attention, MoE],
mamba2's [mamba], jamba's eight layers of mamba with attention fifth and an
MoE every second.  ``lm_init``, ``lm_apply`` (logits and the summed MoE
auxiliary loss), ``lm_loss``, the dense-cache decode (``lm_cache_init``,
``lm_decode_step``) and the paged decode (``lm_paged_cache_init``,
``lm_paged_decode_step``, ``lm_paged_cache_copy_block``,
``lm_paged_cache_reset_slot``, which zeroes a slot's mamba state).  The
JAX version stacks the parameters of the periods and runs them under
``lax.scan``; here the periods are an ``nn.ModuleList`` walked by a Python
loop, each period a module whose layers are named ``pos0``, ``pos1``, …
as the JAX pytree's keys, so a JAX tree loads by name
(``convert.params_from_jax``).  With ``mcfg.remat`` each period runs under
``torch.utils.checkpoint`` when autograd records (JAX's ``jax.checkpoint``
with the ``nothing_saveable`` policy): its forward runs again in the
backward, under the attention backend the forward used.  Caches are a list
over periods of dicts (one per ``pos``) of tensors; attention pools are
updated in place, a mamba layer's state is replaced by the step's.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import comm, tensor_parallel
from repro_torch.distributed.sharding import forward_context
from repro_torch.core.nsa_causal import dense_step, paged_step
from repro_torch.layers.losses import masked_mean_nll
from repro_torch.layers.nn import (Dense, Embed, RMSNorm, SwiGLU, column_dense, dense, embed,
                                   rmsnorm, swiglu, unembed)
from repro_torch.models.attention_layer import (AttentionLayer, attention_cache_init,
                                                attention_layer_apply,
                                                attention_layer_decode,
                                                attention_layer_decode_paged,
                                                attention_paged_cache_init)
from repro_torch.models.mamba2 import Mamba2, mamba2_apply, mamba2_cache_init, mamba2_decode
from repro_torch.models.moe import MoE, moe_apply

__all__ = ["layer_spec", "n_periods", "LanguageModel", "lm_init", "lm_apply", "lm_loss",
           "lm_cache_init", "lm_decode_step", "lm_paged_cache_init",
           "lm_paged_decode_step", "lm_has_recurrent_state", "lm_paged_cache_reset_slot",
           "lm_paged_cache_copy_block"]


def layer_spec(mcfg) -> list[tuple[str, str]]:
    """[(mixer, ffn)] of one period: mixer "attn" | "mamba", ffn "dense" |
    "moe" | "none".  The hybrid's one attention layer sits at ``P // 2``."""
    if mcfg.attn_period:
        P = mcfg.attn_period
        mixers = ["mamba"] * P
        mixers[P // 2] = "attn"
    elif mcfg.family == "ssm":
        P = max(mcfg.moe_period, 1)
        mixers = ["mamba"] * P
    else:
        P = max(mcfg.moe_period, 1) if mcfg.moe else 1
        mixers = ["attn"] * P
    mp = max(mcfg.moe_period, 1)
    ffns = ["none" if mcfg.d_ff == 0 and not mcfg.moe
            else "moe" if mcfg.moe and i % mp == mp - 1 else "dense" for i in range(P)]
    return list(zip(mixers, ffns))


def n_periods(mcfg) -> int:
    P = len(layer_spec(mcfg))
    if mcfg.n_layers % P:
        raise ValueError(f"n_layers={mcfg.n_layers} is not a multiple of the period {P}")
    return mcfg.n_layers // P


class LMLayer(nn.Module):
    """One (mixer, ffn) position of a period: RMSNorm → ``attn`` or
    ``mamba``, then RMSNorm → ``ffn`` (SwiGLU) or ``moe``, or no FFN."""

    def __init__(self, mcfg, mixer: str, ffn: str, *, generator, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = RMSNorm(mcfg.d_model, eps=mcfg.norm_eps, **kw)
        if mixer == "attn":
            self.attn = AttentionLayer(mcfg, generator=generator, **kw)
        else:
            self.mamba = Mamba2(mcfg, generator=generator, **kw)
        if ffn != "none":
            self.norm2 = RMSNorm(mcfg.d_model, eps=mcfg.norm_eps, **kw)
            if ffn == "moe":
                self.moe = MoE(mcfg, generator=generator, **kw)
            else:
                self.ffn = SwiGLU(mcfg.d_model, mcfg.d_ff, generator=generator, **kw)


class LMPeriod(nn.Module):
    def __init__(self, mcfg, *, generator, dtype, device):
        super().__init__()
        for i, (mixer, ffn) in enumerate(layer_spec(mcfg)):
            setattr(self, f"pos{i}", LMLayer(mcfg, mixer, ffn, generator=generator,
                                             dtype=dtype, device=device))

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


def _vocab_part(params: LanguageModel, mcfg):
    """``tensor_parallel.vocab_part`` of the logits' weight (``lm_head``,
    or the tied table)."""
    return tensor_parallel.vocab_part(params.embed.table if mcfg.tie_embeddings
                                      else params.lm_head.w)


def _logits(params: LanguageModel, x, mcfg) -> torch.Tensor:
    """fp32 logits; this rank's vocabulary slice where ``_vocab_part``."""
    x = rmsnorm(params.final_norm, x, mcfg.norm_eps)
    if mcfg.tie_embeddings:
        return unembed(params.embed, x)
    return column_dense((params.lm_head,), x)[0].float()


def _ffn(lp: LMLayer, x, mcfg, aux: list | None = None) -> torch.Tensor:
    """x + the position's FFN (SwiGLU or MoE) of norm(x); an MoE appends its
    auxiliary loss to ``aux`` when given."""
    if hasattr(lp, "ffn"):
        return x + swiglu(lp.ffn, rmsnorm(lp.norm2, x, mcfg.norm_eps))
    if hasattr(lp, "moe"):
        h, a = moe_apply(lp.moe, rmsnorm(lp.norm2, x, mcfg.norm_eps), mcfg)
        if aux is not None:
            aux.append(a["aux_loss"])
        return x + h
    return x


def lm_layer(lp: LMLayer, x, *, mcfg, mask=None, positions=None,
             aux: list | None = None) -> torch.Tensor:
    """One position of a period, full sequence: x + mixer(norm(x)) (causal
    attention at ``positions``, or mamba), then + FFN(norm(x)).  An MoE
    layer appends its auxiliary loss to ``aux`` when given."""
    h = rmsnorm(lp.norm1, x, mcfg.norm_eps)
    if hasattr(lp, "attn"):
        x = x + attention_layer_apply(lp.attn, h, mcfg=mcfg, causal=True, mask=mask,
                                      positions=positions)
    else:
        x = x + mamba2_apply(lp.mamba, h, mcfg)
    return _ffn(lp, x, mcfg, aux)


def _period_apply(period: LMPeriod, x, positions, *, mcfg, mask=None,
                  ctx=None) -> tuple:
    # ``ctx``: the forward's backend, mesh and axis rules
    # (``sharding.forward_context``), re-entered when the
    # checkpointed period runs again on autograd's thread
    aux = []
    with ctx() if ctx else contextlib.nullcontext():
        for lp in period.positions():
            x = lm_layer(lp, x, mcfg=mcfg, mask=mask, positions=positions, aux=aux)
    return x, sum(aux) if aux else torch.zeros((), dtype=torch.float32, device=x.device)


def lm_apply(params: LanguageModel, tokens=None, *, mcfg, inputs_embeds=None, mask=None,
             positions=None) -> tuple:
    """tokens: (B, N) int, or ``inputs_embeds`` (B, N, d) → (logits (B, N, V)
    fp32, the MoE auxiliary loss summed over the layers: a 0-d fp32 zero
    without MoE).  Differentiable (the serving entry points call it under
    ``torch.inference_mode()``).  Under tensor parallelism the vocabulary
    slices are gathered into the whole logits (:func:`lm_loss` never
    gathers them)."""
    logits, aux = _lm_forward(params, tokens, mcfg=mcfg, inputs_embeds=inputs_embeds,
                              mask=mask, positions=positions)
    part = _vocab_part(params, mcfg)
    if part is not None:
        logits = comm.gather(part[0], -1, logits)
    return logits, aux


def _lm_forward(params: LanguageModel, tokens=None, *, mcfg, inputs_embeds=None, mask=None,
                positions=None) -> tuple:
    """:func:`lm_apply` with the logits of this rank's vocabulary slice
    under tensor parallelism."""
    if inputs_embeds is None:
        x = embed(params.embed, tokens, dtype=mcfg.cdtype())
    else:
        x = inputs_embeds.to(mcfg.cdtype())
    B, N, _ = x.shape
    if positions is None:
        positions = torch.arange(N, device=x.device)[None].expand(B, N)
    remat = mcfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ctx = forward_context() if remat else None
    for period in params.layers:
        if remat:
            x, a = checkpoint(_period_apply, period, x, positions, mcfg=mcfg, mask=mask,
                              ctx=ctx, use_reentrant=False)
        else:
            x, a = _period_apply(period, x, positions, mcfg=mcfg, mask=mask)
        aux = aux + a
    return _logits(params, x, mcfg), aux


def lm_loss(params: LanguageModel, batch: dict, *, mcfg):
    """batch: {tokens (B, N), labels (B, N)[, loss_mask (B, N)][,
    inputs_embeds]} → (loss + 0.01·aux_loss, {"loss", "aux_loss"})."""
    logits, aux_loss = _lm_forward(params, batch["tokens"], mcfg=mcfg,
                                   inputs_embeds=batch.get("inputs_embeds"))
    loss = masked_mean_nll(logits, batch["labels"], batch.get("loss_mask"),
                           part=_vocab_part(params, mcfg))
    return loss + 0.01 * aux_loss, {"loss": loss, "aux_loss": aux_loss}


# ---------------------------------------------------------------------------
# Decode: dense caches (lockstep) and paged pools (continuous batching)
# ---------------------------------------------------------------------------

def _period_caches(mcfg, attn_cache, mamba_cache) -> list:
    spec = layer_spec(mcfg)
    return [{f"pos{i}": attn_cache() if mixer == "attn" else mamba_cache()
             for i, (mixer, _) in enumerate(spec)} for _ in range(n_periods(mcfg))]


def lm_cache_init(mcfg, batch: int, max_len: int, dtype=torch.bfloat16,
                  device=None) -> list:
    """Per period, per position: the layer's dense decode cache (attention)
    or its recurrent state (mamba)."""
    return _period_caches(
        mcfg, lambda: attention_cache_init(mcfg, batch, max_len, dtype, device),
        lambda: mamba2_cache_init(mcfg, batch, dtype, device))


def _first_attention_cache(mcfg, caches):
    """The first attention layer's cache, or None for a stack without one."""
    for i, (mixer, _) in enumerate(layer_spec(mcfg)):
        if mixer == "attn":
            return caches[0][f"pos{i}"]
    return None


def _decode(params: LanguageModel, token, caches, mcfg, attend,
            layer_input=None) -> tuple:
    """One decode step through the stack; ``attend(attn, h, cache)`` is the
    layer's attention decode (its addressing built once for the step), a
    mamba layer steps its recurrence.  ``layer_input(n, x)``, when given,
    returns what the stack's n-th layer takes in place of ``x`` (a
    teacher-forced check feeds it the forward's input at the slot's
    position)."""
    x1 = embed(params.embed, token[:, None], dtype=mcfg.cdtype())      # (B,1,d)
    new, n = [], 0
    for period, pc in zip(params.layers, caches):
        nc = {}
        for i, lp in enumerate(period.positions()):
            if layer_input is not None:
                x1 = layer_input(n, x1)
            n += 1
            h = rmsnorm(lp.norm1, x1, mcfg.norm_eps)
            if hasattr(lp, "attn"):
                h, nc[f"pos{i}"] = attend(lp.attn, h, pc[f"pos{i}"])
            else:
                h, nc[f"pos{i}"] = mamba2_decode(lp.mamba, h, pc[f"pos{i}"], mcfg)
            x1 = _ffn(lp, x1 + h, mcfg)
        new.append(nc)
    return _logits(params, x1, mcfg)[:, 0], new


def lm_decode_step(params: LanguageModel, token, caches, *, mcfg):
    """token: (B,) int → (logits (B, V) fp32, caches)."""
    first = _first_attention_cache(mcfg, caches)
    step = (dense_step(first, mcfg.bsa)
            if first is not None and mcfg.attention == "bsa" else None)
    return _decode(params, token, caches, mcfg,
                   lambda p, h, c: attention_layer_decode(p, h, c, mcfg=mcfg, step=step))


def lm_paged_cache_init(mcfg, batch: int, num_blocks: int, page: int,
                        dtype=torch.bfloat16, device=None) -> list:
    """Per period, per position: an attention layer's paged pools, one block
    layout for every layer (one host block table serves the stack), or a
    mamba layer's per-slot recurrent rows (constant size: no paging, but
    :func:`lm_paged_cache_reset_slot` on admission)."""
    return _period_caches(
        mcfg, lambda: attention_paged_cache_init(mcfg, num_blocks, page, dtype, device),
        lambda: mamba2_cache_init(mcfg, batch, dtype, device))


def lm_paged_decode_step(params: LanguageModel, token, caches, table, lengths, *, mcfg,
                         page: int, layer_input=None):
    """token: (B,) int; table (B, n_pages); lengths (B,) per-slot positions
    → (logits (B, V) fp32, caches).  Lengths are not advanced (the host
    owns them).  ``layer_input``: see :func:`_decode`."""
    has_attn = any(mixer == "attn" for mixer, _ in layer_spec(mcfg))
    step = (paged_step(table, lengths, cfg=mcfg.bsa, page=page)
            if has_attn and mcfg.attention == "bsa" else None)
    return _decode(params, token, caches, mcfg,
                   lambda p, h, c: attention_layer_decode_paged(p, h, c, table, lengths,
                                                                mcfg=mcfg, page=page,
                                                                step=step),
                   layer_input)


def lm_has_recurrent_state(mcfg) -> bool:
    """True when a mixer carries unpaged per-slot state (mamba): it must be
    zeroed on admission, and it rules out prefix-block reuse (a cached KV
    page cannot restore a recurrent state)."""
    return any(mixer != "attn" for mixer, _ in layer_spec(mcfg))


@torch.inference_mode()
def lm_paged_cache_reset_slot(mcfg, caches, slot):
    """Zero a slot's recurrent (mamba) state in place on admission.
    Attention pools need no reset (every read is masked to positions the
    slot has written), so for attention-only stacks this returns ``caches``
    unchanged."""
    for pc in caches:
        for i, (mixer, _) in enumerate(layer_spec(mcfg)):
            if mixer != "attn":
                for t in pc[f"pos{i}"].values():
                    t[slot] = 0
    return caches


@torch.no_grad()
def lm_paged_cache_copy_block(mcfg, caches, src: int, dst: int, *, page: int):
    """Copy pool block ``src`` → ``dst`` in every attention layer's pools
    (token rows and compressed rows), in place: the device half of
    copy-on-write."""
    cpp = page // mcfg.bsa.cmp_block
    spec = layer_spec(mcfg)
    for pc in caches:
        for i, (mixer, _) in enumerate(spec):
            if mixer != "attn":
                continue
            pools = pc[f"pos{i}"]
            if hasattr(pools, "copy_block"):      # row blocks across ranks (sharded)
                pools.copy_block(src, dst, page=page, cmp_block=mcfg.bsa.cmp_block)
                continue
            for key, t in pools.items():
                rows = page if key in ("k", "v") else cpp
                t[dst * rows:(dst + 1) * rows] = t[src * rows:(src + 1) * rows]
    return caches
