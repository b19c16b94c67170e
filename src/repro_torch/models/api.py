"""Family-dispatch API (counterpart of ``repro/models/api.py``): one
interface over the point-cloud model, the decoder-only LMs (dense, MoE,
SSM, hybrid), the VLM and the encoder-decoder:

    api = model_api(mcfg)
    model = api.init(seed)                     # on "cuda" unless device="cpu"
    loss, metrics = api.loss(model, batch)     # train step core (point cloud:
                                               # masked MSE; LM: next-token NLL)
    pred = api.forward(model, batch)           # point cloud: (B, N, out_dim);
                                               # LMs: logits (B, N, V); fp32, no grad
    batch = api.make_batch(rng, B, N)          # random tensors (tests), drawn
                                               # from rng as the JAX api draws

and, for the LMs, the decode state and steps the serving engine drives:

    caches = api.cache_init(B, max_len)                       # dense (lockstep)
    logits, caches = api.decode_step(model, token, caches)
    caches = api.paged_cache_init(B, num_blocks, page)        # paged pools
    logits, caches = api.paged_decode_step(model, token, caches, table, lengths, page)
    caches = api.cache_copy_block(caches, src, dst, page)     # copy-on-write
    caches = api.cache_reset_slot(caches, slot)               # zero mamba state

The VLM decodes on its backbone (text only, no paged decoder); the
encoder-decoder's ``cache_init(B, max_len, dtype, params=, memory=)``
takes the encoder output, whose cross-attention K/V it computes once.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.models import encdec as _ed
from repro_torch.models import pointcloud as _pc
from repro_torch.models import transformer as _tf
from repro_torch.models import vlm as _vlm

__all__ = ["ModelAPI", "model_api"]


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    mcfg: Any
    init: Callable
    loss: Callable
    forward: Callable
    make_batch: Callable
    cache_init: Callable | None = None
    decode_step: Callable | None = None
    # paged continuous-batching decode (serving/paged_cache.py owns the
    # host-side tables these consume)
    paged_cache_init: Callable | None = None
    paged_decode_step: Callable | None = None
    cache_reset_slot: Callable | None = None
    cache_copy_block: Callable | None = None
    has_recurrent_state: bool = False

    @property
    def has_decoder(self) -> bool:
        return self.decode_step is not None

    @property
    def has_paged_decoder(self) -> bool:
        return self.paged_decode_step is not None


def _generator(seed: int, device="cpu") -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _pc_api(mcfg) -> ModelAPI:
    def init(seed: int = 0, *, device="cuda") -> _pc.PointCloudModel:
        """Random weights drawn on the host from ``seed``, then moved to
        ``device`` (which must exist: no silent CPU fallback)."""
        return _pc.pc_init(mcfg, generator=_generator(seed), device=torch.device(device))

    def loss(model, batch: dict):
        return _pc.pc_loss(model, batch, mcfg=mcfg)

    @torch.no_grad()
    def forward(model, batch: dict) -> torch.Tensor:
        return _pc.pc_apply(model, batch["feats"], mcfg=mcfg, mask=batch.get("mask"),
                            offsets=batch.get("offsets"))

    def make_batch(rng: np.random.Generator, B: int, N: int, *, device="cuda") -> dict:
        feats = rng.standard_normal((B, N, mcfg.in_dim), dtype=np.float32)
        tgt = rng.standard_normal((B, N, mcfg.out_dim), dtype=np.float32)
        dev = torch.device(device)
        return {"feats": torch.from_numpy(feats).to(dev),
                "target": torch.from_numpy(tgt).to(dev),
                "mask": torch.ones((B, N), dtype=torch.bool, device=dev)}

    return ModelAPI(mcfg=mcfg, init=init, loss=loss, forward=forward,
                    make_batch=make_batch)


def _lm_api(mcfg) -> ModelAPI:
    def init(seed: int = 0, *, device="cuda") -> _tf.LanguageModel:
        """Random weights from ``seed``, drawn on ``device`` itself (1.1B
        parameters at tinyllama's size; no silent CPU fallback)."""
        dev = torch.device(device)
        return _tf.lm_init(mcfg, generator=_generator(seed, dev), device=dev)

    def loss(model, batch: dict):
        return _tf.lm_loss(model, batch, mcfg=mcfg)

    @torch.inference_mode()
    def forward(model, batch: dict) -> torch.Tensor:
        return _tf.lm_apply(model, batch["tokens"], mcfg=mcfg)[0]

    def make_batch(rng: np.random.Generator, B: int, N: int, *, device="cuda") -> dict:
        toks = torch.from_numpy(rng.integers(0, mcfg.vocab_size, (B, N),
                                             dtype=np.int32)).to(torch.device(device))
        return {"tokens": toks, "labels": toks}

    def cache_init(B, S, dtype=torch.bfloat16, *, device="cuda"):
        return _tf.lm_cache_init(mcfg, B, S, dtype, torch.device(device))

    def paged_cache_init(B, num_blocks, page, dtype=torch.bfloat16, *, device="cuda"):
        return _tf.lm_paged_cache_init(mcfg, B, num_blocks, page, dtype,
                                       torch.device(device))

    @torch.inference_mode()
    def decode_step(model, token, caches):
        return _tf.lm_decode_step(model, token, caches, mcfg=mcfg)

    @torch.inference_mode()
    def paged_decode_step(model, token, caches, table, lengths, page):
        return _tf.lm_paged_decode_step(model, token, caches, table, lengths, mcfg=mcfg,
                                        page=page)

    return ModelAPI(
        mcfg=mcfg, init=init, loss=loss, forward=forward, make_batch=make_batch,
        cache_init=cache_init, decode_step=decode_step,
        paged_cache_init=paged_cache_init, paged_decode_step=paged_decode_step,
        cache_reset_slot=lambda c, slot: _tf.lm_paged_cache_reset_slot(mcfg, c, slot),
        cache_copy_block=lambda c, src, dst, page: _tf.lm_paged_cache_copy_block(
            mcfg, c, src, dst, page=page),
        has_recurrent_state=_tf.lm_has_recurrent_state(mcfg))


def _vlm_api(mcfg) -> ModelAPI:
    dv, SI = mcfg.d_frontend, mcfg.vision_tokens

    def init(seed: int = 0, *, device="cuda") -> _vlm.VisionLanguageModel:
        dev = torch.device(device)
        return _vlm.vlm_init(mcfg, generator=_generator(seed, dev), device=dev)

    @torch.inference_mode()
    def forward(model, batch: dict) -> torch.Tensor:
        return _vlm.vlm_apply(model, batch["tokens"], batch["patch_embeds"], mcfg=mcfg)[0]

    def make_batch(rng: np.random.Generator, B: int, N: int, *, device="cuda") -> dict:
        """N positions: ``vision_tokens`` image tokens, then N − that text."""
        dev = torch.device(device)
        toks = torch.from_numpy(rng.integers(0, mcfg.vocab_size, (B, N - SI),
                                             dtype=np.int32)).to(dev)
        pe = rng.standard_normal((B, SI, dv), dtype=np.float32)
        return {"tokens": toks, "patch_embeds": torch.from_numpy(pe).to(dev, mcfg.cdtype()),
                "labels": toks}

    def cache_init(B, S, dtype=torch.bfloat16, *, device="cuda"):
        return _tf.lm_cache_init(mcfg, B, S, dtype, torch.device(device))

    @torch.inference_mode()
    def decode_step(model, token, caches):
        """Decodes on the backbone (the image tokens never enter the cache)."""
        return _tf.lm_decode_step(model.lm, token, caches, mcfg=mcfg)

    return ModelAPI(mcfg=mcfg, init=init,
                    loss=lambda model, batch: _vlm.vlm_loss(model, batch, mcfg=mcfg),
                    forward=forward, make_batch=make_batch, cache_init=cache_init,
                    decode_step=decode_step)


def _encdec_api(mcfg) -> ModelAPI:
    df = mcfg.d_frontend

    def init(seed: int = 0, *, device="cuda") -> _ed.EncDecModel:
        dev = torch.device(device)
        return _ed.encdec_init(mcfg, generator=_generator(seed, dev), device=dev)

    @torch.inference_mode()
    def forward(model, batch: dict) -> torch.Tensor:
        memory = _ed.encode(model, batch["frames"], mcfg=mcfg)
        return _ed.decode_train(model, batch["dec_tokens"], memory, mcfg=mcfg)

    def make_batch(rng: np.random.Generator, B: int, N: int, *, device="cuda") -> dict:
        """N frames and max(N / dec_ratio, 16) decoder tokens."""
        dev = torch.device(device)
        Sd = max(N // mcfg.dec_ratio, 16)
        fr = rng.standard_normal((B, N, df), dtype=np.float32)
        toks = torch.from_numpy(rng.integers(0, mcfg.vocab_size, (B, Sd),
                                             dtype=np.int32)).to(dev)
        return {"frames": torch.from_numpy(fr).to(dev, mcfg.cdtype()), "dec_tokens": toks,
                "labels": toks}

    def cache_init(B, S, dtype=torch.bfloat16, *, device="cuda", params=None, memory=None):
        """Self-attention caches of S positions and the cross-attention K/V
        of ``memory`` (B, L, d), the encoder output of ``params``."""
        if params is None or memory is None:
            raise ValueError("the encoder-decoder's cache_init needs params= and memory=")
        return _ed.encdec_cache_init(params, memory, mcfg=mcfg, batch=B, max_len=S,
                                     dtype=dtype, device=torch.device(device))

    @torch.inference_mode()
    def decode_step(model, token, caches):
        return _ed.encdec_decode_step(model, token, caches, mcfg=mcfg)

    return ModelAPI(mcfg=mcfg, init=init,
                    loss=lambda model, batch: _ed.encdec_loss(model, batch, mcfg=mcfg),
                    forward=forward, make_batch=make_batch, cache_init=cache_init,
                    decode_step=decode_step)


def model_api(mcfg) -> ModelAPI:
    if mcfg.family in ("dense", "moe", "ssm", "hybrid"):
        return _lm_api(mcfg)
    if mcfg.family == "vlm":
        return _vlm_api(mcfg)
    if mcfg.family == "audio":
        return _encdec_api(mcfg)
    if mcfg.family == "pointcloud":
        return _pc_api(mcfg)
    raise ValueError(f"unknown family {mcfg.family}")
