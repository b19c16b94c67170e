"""Model configuration schema and registry.

Counterpart of ``repro/configs/base.py``, with the fields the point-cloud
and dense causal-LM families read.  ``pdtype()`` / ``cdtype()`` return
torch dtypes.  :func:`get_config` finds a config by name in the module of
that name (``"tinyllama-1.1b"`` → ``configs/tinyllama_1_1b.py``), as the
JAX registry does; the point-cloud variants live in ``shapenet_bsa.py``.
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
    family: str                      # ported: "pointcloud", "dense"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    head_dim: int = 0                # 0 ⇒ d_model // n_heads
    vocab_size: int = 0              # LM families
    attention: str = "bsa"           # mechanism: "bsa" | "full" | "erwin"
    bsa: BSAConfig = dataclasses.field(default_factory=BSAConfig)
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True               # activation checkpointing per layer period
    opt_state_dtype: str = "float32"  # AdamW moments
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


_MODULES = ("shapenet_bsa", "tinyllama_1_1b")


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        mod = name.replace("-", "_").replace(".", "_")
        importlib.import_module(f"repro_torch.configs."
                                f"{mod if mod in _MODULES else 'shapenet_bsa'}")
    if name not in _REGISTRY:
        raise KeyError(f"unknown config {name!r}; the port has {list_configs()}")
    return _REGISTRY[name]()


def list_configs() -> list[str]:
    for mod in _MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")
    return sorted(_REGISTRY)
