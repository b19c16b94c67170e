"""Model configuration schema and registry.

Counterpart of ``repro/configs/base.py``, with the fields the point-cloud
family reads.  ``pdtype()`` / ``cdtype()`` return torch dtypes.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

import torch

from repro_torch.core.config import BSAConfig

__all__ = ["ModelConfig", "register", "get_config", "list_configs"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # only "pointcloud" is ported
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    head_dim: int = 0                # 0 ⇒ d_model // n_heads
    attention: str = "bsa"           # mechanism; only "bsa" is ported
    bsa: BSAConfig = dataclasses.field(default_factory=BSAConfig)
    norm_eps: float = 1e-5
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    in_dim: int = 0                  # per-point input features
    out_dim: int = 0                 # regression targets per point

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def scaled(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        importlib.import_module("repro_torch.configs.shapenet_bsa")
    if name not in _REGISTRY:
        raise KeyError(f"unknown config {name!r}; the port has {list_configs()}")
    return _REGISTRY[name]()


def list_configs() -> list[str]:
    importlib.import_module("repro_torch.configs.shapenet_bsa")
    return sorted(_REGISTRY)
