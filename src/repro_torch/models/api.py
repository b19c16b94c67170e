"""Family-dispatch API (counterpart of ``repro/models/api.py``).

Only the point-cloud family is ported:

    api = model_api(mcfg)
    model = api.init(seed)                     # on "cuda" unless device="cpu"
    loss, metrics = api.loss(model, batch)     # train step core (differentiable)
    pred = api.forward(model, batch)           # (B, N, out_dim) fp32, no grad
    batch = api.make_batch(rng, B, N)          # random tensors (tests)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.models import pointcloud as _pc

__all__ = ["ModelAPI", "model_api"]


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    mcfg: Any
    init: Callable
    loss: Callable
    forward: Callable
    make_batch: Callable


def _generator(seed: int) -> torch.Generator:
    g = torch.Generator()
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
        return _pc.pc_apply(model, batch["feats"], mcfg=mcfg, mask=batch.get("mask"))

    def make_batch(rng: np.random.Generator, B: int, N: int, *, device="cuda") -> dict:
        feats = rng.standard_normal((B, N, mcfg.in_dim), dtype=np.float32)
        tgt = rng.standard_normal((B, N, mcfg.out_dim), dtype=np.float32)
        dev = torch.device(device)
        return {"feats": torch.from_numpy(feats).to(dev),
                "target": torch.from_numpy(tgt).to(dev),
                "mask": torch.ones((B, N), dtype=torch.bool, device=dev)}

    return ModelAPI(mcfg=mcfg, init=init, loss=loss, forward=forward,
                    make_batch=make_batch)


def model_api(mcfg) -> ModelAPI:
    if mcfg.family == "pointcloud":
        return _pc_api(mcfg)
    raise NotImplementedError(f"family {mcfg.family!r} is not ported yet")
