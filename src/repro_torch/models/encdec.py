"""Encoder-decoder backbone (the seamless-m4t family).

Counterpart of ``repro/models/encdec.py``.  Encoder: non-causal BSA over
the stubbed modality frame embeddings (the paper's point-set form of BSA
on 1-D frames), no RoPE, the frame mask as the token mask.  Decoder:
causal BSA self-attention with RoPE, cross-attention to the encoder output
(``full_attention`` on the flash kernels, the frame mask as key
validity), SwiGLU.  With ``mcfg.remat`` each layer runs under
``torch.utils.checkpoint`` when autograd records (JAX checkpoints each
layer of its scans), re-entering the forward's attention backend.  The
decode keeps, per decoder layer, a self-attention cache and the memory's
cross-attention K/V computed once (``encdec_cache_init``).

Under tensor parallelism (``distributed/tensor_parallel.py``) the train
step splits over ``model``: ``frontend_proj`` is a column product whose
columns are all-gathered into the residual stream, every attention layer
(the encoder's non-causal BSA, the decoder's causal BSA and its
cross-attention) runs this rank's heads, SwiGLU its columns,
``tok_embed`` is vocabulary-parallel and the loss reads this rank's
vocabulary slice of ``lm_head``'s logits; :func:`decode_train` gathers
the slices.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import comm, tensor_parallel
from repro_torch.distributed.sharding import forward_context
from repro_torch.core.nsa_causal import dense_step
from repro_torch.layers.losses import masked_mean_nll
from repro_torch.layers.nn import (Dense, Embed, RMSNorm, SwiGLU, column_dense, dense, embed,
                                   rmsnorm, swiglu)
from repro_torch.models.attention_layer import (AttentionLayer, attention_cache_init,
                                                attention_layer_apply,
                                                attention_layer_decode,
                                                cross_attention_apply, memory_kv)

__all__ = ["EncDecModel", "encdec_init", "encode", "decode_train", "encdec_loss",
           "encdec_cache_init", "encdec_decode_step"]


class EncLayer(nn.Module):
    def __init__(self, mcfg, **kw):
        super().__init__()
        nk = dict(eps=mcfg.norm_eps, dtype=kw["dtype"], device=kw["device"])
        self.norm1 = RMSNorm(mcfg.d_model, **nk)
        self.attn = AttentionLayer(mcfg, **kw)
        self.norm2 = RMSNorm(mcfg.d_model, **nk)
        self.ffn = SwiGLU(mcfg.d_model, mcfg.d_ff, **kw)


class DecLayer(nn.Module):
    def __init__(self, mcfg, **kw):
        super().__init__()
        nk = dict(eps=mcfg.norm_eps, dtype=kw["dtype"], device=kw["device"])
        self.norm1 = RMSNorm(mcfg.d_model, **nk)
        self.self_attn = AttentionLayer(mcfg, **kw)
        self.norm_x = RMSNorm(mcfg.d_model, **nk)
        self.cross_attn = AttentionLayer(mcfg, **kw)
        self.norm2 = RMSNorm(mcfg.d_model, **nk)
        self.ffn = SwiGLU(mcfg.d_model, mcfg.d_ff, **kw)


class EncDecModel(nn.Module):
    """Parameters named as the JAX pytree's: ``frontend_proj``,
    ``enc_layers``, ``enc_norm``, ``tok_embed``, ``dec_layers``,
    ``dec_norm``, ``lm_head``."""

    def __init__(self, mcfg, *, generator: torch.Generator, device=None):
        super().__init__()
        self.mcfg = mcfg
        pd = mcfg.pdtype()
        kw = dict(generator=generator, dtype=pd, device=device)
        d = mcfg.d_model
        self.frontend_proj = Dense(mcfg.d_frontend or d, d, bias=True, **kw)
        self.enc_layers = nn.ModuleList(EncLayer(mcfg, **kw)
                                        for _ in range(mcfg.n_encoder_layers or mcfg.n_layers))
        self.enc_norm = RMSNorm(d, eps=mcfg.norm_eps, dtype=pd, device=device)
        self.tok_embed = Embed(mcfg.vocab_size, d, **kw)
        self.dec_layers = nn.ModuleList(DecLayer(mcfg, **kw) for _ in range(mcfg.n_layers))
        self.dec_norm = RMSNorm(d, eps=mcfg.norm_eps, dtype=pd, device=device)
        self.lm_head = Dense(d, mcfg.vocab_size, scale=0.02, **kw)


def encdec_init(mcfg, *, generator: torch.Generator, device) -> EncDecModel:
    return EncDecModel(mcfg, generator=generator, device=device)


def enc_layer(lp: EncLayer, x, *, mcfg, mask=None) -> torch.Tensor:
    """One encoder layer: x + non-causal BSA(norm(x)) without RoPE, then
    + SwiGLU(norm(x))."""
    h = rmsnorm(lp.norm1, x, mcfg.norm_eps)
    x = x + attention_layer_apply(lp.attn, h, mcfg=mcfg, causal=False, mask=mask,
                                  rope=False)
    return x + swiglu(lp.ffn, rmsnorm(lp.norm2, x, mcfg.norm_eps))


def dec_layer(lp: DecLayer, x, memory, *, mcfg, positions, mem_mask=None) -> torch.Tensor:
    """One decoder layer: causal BSA at ``positions``, cross-attention to
    ``memory`` (B, L, d), SwiGLU, each on the normed residual."""
    h = rmsnorm(lp.norm1, x, mcfg.norm_eps)
    x = x + attention_layer_apply(lp.self_attn, h, mcfg=mcfg, causal=True,
                                  positions=positions)
    h = rmsnorm(lp.norm_x, x, mcfg.norm_eps)
    mkv = memory_kv(lp.cross_attn, memory, mcfg=mcfg)
    x = x + cross_attention_apply(lp.cross_attn, h, mkv, mcfg=mcfg, mem_mask=mem_mask)
    return x + swiglu(lp.ffn, rmsnorm(lp.norm2, x, mcfg.norm_eps))


def _run(fn, remat: bool, *args, **kw):
    """``fn(*args, **kw)``, under ``torch.utils.checkpoint`` when ``remat``
    and autograd records; the recompute re-enters the forward's backend,
    mesh and axis rules (``sharding.forward_context``)."""
    if not (remat and torch.is_grad_enabled()):
        return fn(*args, **kw)
    ctx = forward_context()

    def again(*a):
        with ctx():
            return fn(*a, **kw)

    return checkpoint(again, *args, use_reentrant=False)


def _frontend(p: Dense, frames) -> torch.Tensor:
    """``frontend_proj`` of the frames; where it is cut over ``model``, a
    column product whose columns are all-gathered (each rank then holds
    the whole gradient of the residual stream: the backward keeps this
    rank's columns of it)."""
    if tensor_parallel.cut_dim(p.w) is None:
        return dense(p, frames)
    return comm.gather(tensor_parallel.axis(), -1, column_dense((p,), frames)[0])


def encode(params: EncDecModel, frames, *, mcfg, mask=None) -> torch.Tensor:
    """frames: (B, S_enc, d_frontend) → memory (B, S_enc, d_model)."""
    x = _frontend(params.frontend_proj, frames.to(mcfg.cdtype()))
    for lp in params.enc_layers:
        x = _run(enc_layer, mcfg.remat, lp, x, mcfg=mcfg, mask=mask)
    return rmsnorm(params.enc_norm, x, mcfg.norm_eps)


def decode_train(params: EncDecModel, tokens, memory, *, mcfg, mem_mask=None) -> torch.Tensor:
    """Teacher-forced decoder: tokens (B, S_dec), memory (B, S_enc, d) →
    logits (B, S_dec, V) fp32 (under tensor parallelism the ranks'
    vocabulary slices gathered)."""
    logits = _decode_forward(params, tokens, memory, mcfg=mcfg, mem_mask=mem_mask)
    part = tensor_parallel.vocab_part(params.lm_head.w)
    return logits if part is None else comm.gather(part[0], -1, logits)


def _decode_forward(params: EncDecModel, tokens, memory, *, mcfg, mem_mask=None):
    """:func:`decode_train` with the logits of this rank's vocabulary slice
    under tensor parallelism."""
    x = embed(params.tok_embed, tokens, dtype=mcfg.cdtype())
    B, N, _ = x.shape
    positions = torch.arange(N, device=x.device)[None].expand(B, N)
    for lp in params.dec_layers:
        x = _run(dec_layer, mcfg.remat, lp, x, memory, mcfg=mcfg, positions=positions,
                 mem_mask=mem_mask)
    x = rmsnorm(params.dec_norm, x, mcfg.norm_eps)
    return column_dense((params.lm_head,), x)[0].float()


def encdec_loss(params: EncDecModel, batch: dict, *, mcfg):
    """batch: {frames, dec_tokens, labels[, frame_mask][, loss_mask]} →
    (loss, {"loss"})."""
    memory = encode(params, batch["frames"], mcfg=mcfg, mask=batch.get("frame_mask"))
    logits = _decode_forward(params, batch["dec_tokens"], memory, mcfg=mcfg,
                             mem_mask=batch.get("frame_mask"))
    loss = masked_mean_nll(logits, batch["labels"], batch.get("loss_mask"),
                           part=tensor_parallel.vocab_part(params.lm_head.w))
    return loss, {"loss": loss}


# ---------------------------------------------------------------------------
# Decode (serving)
# ---------------------------------------------------------------------------

@torch.no_grad()
def encdec_cache_init(params: EncDecModel, memory, *, mcfg, batch: int, max_len: int,
                      dtype=torch.bfloat16, device=None) -> list:
    """Per decoder layer: the self-attention decode cache and the memory's
    cross-attention K/V (``mem_k``, ``mem_v``) in ``dtype``."""
    caches = []
    for lp in params.dec_layers:
        mk, mv = memory_kv(lp.cross_attn, memory, mcfg=mcfg)
        caches.append({"self": attention_cache_init(mcfg, batch, max_len, dtype, device),
                       "mem_k": mk.to(dtype), "mem_v": mv.to(dtype)})
    return caches


def encdec_decode_step(params: EncDecModel, token, caches, *, mcfg, mem_mask=None,
                       layer_input=None):
    """token: (B,) int → (logits (B, V) fp32, caches).  ``layer_input(n,
    x)``, when given, returns what decoder layer n takes in place of ``x``
    (the previous layer's output): a teacher-forced check feeds it the
    forward's layer input."""
    cdt = mcfg.cdtype()
    x1 = embed(params.tok_embed, token[:, None], dtype=cdt)
    step = dense_step(caches[0]["self"], mcfg.bsa) if mcfg.attention == "bsa" else None
    new = []
    for n, (lp, pc) in enumerate(zip(params.dec_layers, caches)):
        if layer_input is not None:
            x1 = layer_input(n, x1)
        h = rmsnorm(lp.norm1, x1, mcfg.norm_eps)
        h, self_cache = attention_layer_decode(lp.self_attn, h, pc["self"], mcfg=mcfg,
                                               step=step)
        x1 = x1 + h
        h = rmsnorm(lp.norm_x, x1, mcfg.norm_eps)
        x1 = x1 + cross_attention_apply(lp.cross_attn, h,
                                        (pc["mem_k"].to(cdt), pc["mem_v"].to(cdt)),
                                        mcfg=mcfg, mem_mask=mem_mask)
        x1 = x1 + swiglu(lp.ffn, rmsnorm(lp.norm2, x1, mcfg.norm_eps))
        new.append({**pc, "self": self_cache})
    x1 = rmsnorm(params.dec_norm, x1, mcfg.norm_eps)
    return dense(params.lm_head, x1)[:, 0].float(), new
