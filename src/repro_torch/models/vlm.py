"""VLM (the llava-next family): a stubbed vision frontend and the LM backbone.

Counterpart of ``repro/models/vlm.py``.  The batch carries precomputed
patch embeddings (the anyres tiling happens upstream); the projector (a
two-layer MLP with the tanh GELU between, llava's) and the backbone
(``models/transformer.py``) are real.  The sequence is [image tokens; text
tokens]; the loss reads the text positions only.  Decoding runs on the
backbone alone from an empty cache (``models/api.py``), so the image
tokens never enter it, as in the JAX package.  Under tensor parallelism
(``distributed/tensor_parallel.py``) the projector's fc1 is a column and
fc2 a row product, the text embedding vocabulary-parallel, the backbone
split as the LM's, and the loss reads this rank's vocabulary slice of
the logits.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.layers.losses import masked_mean_nll
from repro_torch.layers.nn import Dense, embed, mlp
from repro_torch.models.transformer import LanguageModel, _lm_forward, _vocab_part, lm_apply

__all__ = ["VisionLanguageModel", "vlm_init", "vlm_apply", "vlm_loss"]


class Projector(nn.Module):
    def __init__(self, d_v: int, d: int, **kw):
        super().__init__()
        self.fc1 = Dense(d_v, d, bias=True, **kw)
        self.fc2 = Dense(d, d, bias=True, **kw)


class VisionLanguageModel(nn.Module):
    """``projector`` (``fc1``, ``fc2``) and the backbone ``lm``, named as the
    JAX pytree's."""

    def __init__(self, mcfg, *, generator: torch.Generator, device=None):
        super().__init__()
        self.mcfg = mcfg
        self.projector = Projector(mcfg.d_frontend or mcfg.d_model, mcfg.d_model,
                                   generator=generator, dtype=mcfg.pdtype(), device=device)
        self.lm = LanguageModel(mcfg, generator=generator, device=device)


def vlm_init(mcfg, *, generator: torch.Generator, device) -> VisionLanguageModel:
    return VisionLanguageModel(mcfg, generator=generator, device=device)


def _project(p: Projector, patches, cdt) -> torch.Tensor:
    """fc2(GELU(fc1(patches))), the tanh GELU in fp32 (``layers.nn.mlp``)."""
    return mlp(p, patches.to(cdt))


def _embeds(params: VisionLanguageModel, tokens, patch_embeds, cdt) -> torch.Tensor:
    """[projected image tokens; text token embeddings] (B, S_img + S_text, d)."""
    img = _project(params.projector, patch_embeds, cdt)
    return torch.cat([img, embed(params.lm.embed, tokens, dtype=cdt)], dim=1)


def vlm_apply(params: VisionLanguageModel, tokens, patch_embeds, *, mcfg) -> tuple:
    """tokens (B, S_text), patch_embeds (B, S_img, d_frontend) → (logits
    (B, S_img + S_text, V) fp32, MoE auxiliary loss)."""
    x = _embeds(params, tokens, patch_embeds, mcfg.cdtype())
    return lm_apply(params.lm, mcfg=mcfg, inputs_embeds=x)


def vlm_loss(params: VisionLanguageModel, batch: dict, *, mcfg):
    """batch: {tokens (B, S_text), patch_embeds (B, S_img, d_v), labels (B,
    S_text)} → (loss on the text positions + 0.01·aux_loss, {"loss"})."""
    x = _embeds(params, batch["tokens"], batch["patch_embeds"], mcfg.cdtype())
    logits, aux_loss = _lm_forward(params.lm, mcfg=mcfg, inputs_embeds=x)
    S_img = batch["patch_embeds"].shape[1]
    loss = masked_mean_nll(logits[:, S_img:], batch["labels"],
                           part=_vocab_part(params.lm, mcfg))
    return loss + 0.01 * aux_loss, {"loss": loss}
