"""VLM (the llava-next family): a stubbed vision frontend and the LM backbone.

Counterpart of ``repro/models/vlm.py``.  The batch carries precomputed
patch embeddings (the anyres tiling happens upstream); the projector (a
two-layer MLP with the tanh GELU between, llava's) and the backbone
(``models/transformer.py``) are real.  The sequence is [image tokens; text
tokens]; the loss reads the text positions only.  Decoding runs on the
backbone alone from an empty cache (``models/api.py``), so the image
tokens never enter it, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.layers.losses import masked_mean_nll
from repro_torch.layers.nn import Dense, dense, embed
from repro_torch.models.transformer import LanguageModel, lm_apply

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
    h = dense(p.fc1, patches.to(cdt))
    h = F.gelu(h.float(), approximate="tanh").to(cdt)
    return dense(p.fc2, h)


def vlm_apply(params: VisionLanguageModel, tokens, patch_embeds, *, mcfg) -> tuple:
    """tokens (B, S_text), patch_embeds (B, S_img, d_frontend) → (logits
    (B, S_img + S_text, V) fp32, MoE auxiliary loss)."""
    cdt = mcfg.cdtype()
    img = _project(params.projector, patch_embeds, cdt)
    txt = embed(params.lm.embed, tokens, dtype=cdt)
    return lm_apply(params.lm, mcfg=mcfg, inputs_embeds=torch.cat([img, txt], dim=1))


def vlm_loss(params: VisionLanguageModel, batch: dict, *, mcfg):
    """batch: {tokens (B, S_text), patch_embeds (B, S_img, d_v), labels (B,
    S_text)} → (loss on the text positions + 0.01·aux_loss, {"loss"})."""
    logits, aux_loss = vlm_apply(params, batch["tokens"], batch["patch_embeds"], mcfg=mcfg)
    S_img = batch["patch_embeds"].shape[1]
    loss = masked_mean_nll(logits[:, S_img:], batch["labels"])
    return loss + 0.01 * aux_loss, {"loss": loss}
