"""Model configuration schema and registry.

Counterpart of ``repro/configs/base.py``, field for field.
``pdtype()`` / ``cdtype()`` return torch dtypes.  :func:`get_config` finds
a config by name in the module of that name (``"tinyllama-1.1b"`` →
``configs/tinyllama_1_1b.py``), as the JAX registry does; the point-cloud
variants live in ``shapenet_bsa.py``.  ``SHAPES`` are the four input-shape
cells and ``ARCH_IDS`` the ten assigned architectures (dense, MoE, SSM,
hybrid, VLM and encoder-decoder families), copied from JAX.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

import torch

from repro_torch.core.config import BSAConfig

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "ARCH_IDS", "register", "get_config",
           "list_configs", "list_archs"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | vlm | hybrid | audio | pointcloud
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    head_dim: int = 0                # 0 ⇒ d_model // n_heads
    vocab_size: int = 0              # LM families
    attention: str = "bsa"           # mechanism: "bsa" | "full" | "erwin" ("none": SSM)
    bsa: BSAConfig = dataclasses.field(default_factory=BSAConfig)
    rope_theta: float = 1e4
    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim
    n_shared_experts: int = 0        # fused shared expert of n_shared·moe_d_ff
    moe_period: int = 1              # MoE FFN every moe_period layers
    capacity_factor: float = 1.25
    pad_experts_to: int = 0          # inert experts the router never picks
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    attn_period: int = 0             # hybrid: one attention layer a period (0 ⇒ pure)
    # --- encoder-decoder / multimodal ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    dec_ratio: int = 8               # decoder length = frames // dec_ratio
    vision_tokens: int = 0           # VLM: image tokens ahead of the text
    d_frontend: int = 0              # width of the stubbed modality embeddings
    # --- numerics / misc ---
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True               # activation checkpointing per layer period
    # --- sharding (read by the JAX package's distributed layer only) ---
    attn_shard_mode: str = "head"    # head | sequence
    fsdp: bool = False
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


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "granite-20b", "tinyllama-1.1b", "phi4-mini-3.8b", "stablelm-1.6b",
    "qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b", "mamba2-1.3b",
    "llava-next-34b", "jamba-1.5-large-398b", "seamless-m4t-medium",
]

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


_MODULES = ("shapenet_bsa", "tinyllama_1_1b", "stablelm_1_6b", "phi4_mini_3_8b",
            "granite_20b", "qwen2_moe_a2_7b", "phi3_5_moe_42b_a6_6b", "mamba2_1_3b",
            "jamba_1_5_large_398b", "llava_next_34b", "seamless_m4t_medium")


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


def list_archs() -> list[str]:
    return list(ARCH_IDS)
