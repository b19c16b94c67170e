"""Reduced ("smoke") configs: the same family structure, tiny dimensions.

A copy of ``repro/configs/reduce.py::smoke_config`` (which imports jax
through ``repro.core``, so it is copied, not imported).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.core.config import BSAConfig

__all__ = ["SMOKE_SEQ", "SMOKE_BSA", "smoke_config"]

SMOKE_SEQ = 256

SMOKE_BSA = BSAConfig(ball_size=32, local_window=32, cmp_block=8, slc_block=8,
                      top_k=2, group_size=8, query_cmp_selection=True)


def smoke_config(mcfg: ModelConfig) -> ModelConfig:
    """Scale a config down to CPU-smoke size, keeping its structure: one
    period of the layer pattern (two layers for trivial patterns), d_model
    64, four query heads of 16 (GQA rep up to 4), d_ff 128, vocabulary 512,
    ``SMOKE_BSA``, fp32, no remat; at most 8 experts of 32, top 2, one
    shared expert, capacity factor 2; state 16 in heads of 16; 32 image
    tokens of 32; two encoder layers, frames of 32, decoder ratio 4."""
    if mcfg.attn_period:
        n_layers = mcfg.attn_period
    elif mcfg.moe and mcfg.moe_period > 1:
        n_layers = 2 * mcfg.moe_period
    else:
        n_layers = 2
    if mcfg.n_heads:
        rep = max(1, min(mcfg.n_heads // max(mcfg.n_kv_heads, 1), 4))
        n_heads = 4
        n_kv_heads = max(1, 4 // rep)
    else:
        n_heads = n_kv_heads = 0
    kw = dict(
        n_layers=n_layers,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv_heads,
        head_dim=16 if n_heads else 0,
        d_ff=128 if mcfg.d_ff else 0,
        vocab_size=512 if mcfg.vocab_size else 0,
        bsa=SMOKE_BSA,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
    )
    if mcfg.moe:
        kw.update(n_experts=min(8, mcfg.n_experts),
                  experts_per_token=min(2, mcfg.experts_per_token),
                  moe_d_ff=32,
                  n_shared_experts=min(1, mcfg.n_shared_experts),
                  capacity_factor=2.0)
    if mcfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_expand=2)
    if mcfg.family == "vlm":
        kw.update(vision_tokens=32, d_frontend=32)
    if mcfg.family == "audio":
        kw.update(n_encoder_layers=2, d_frontend=32, dec_ratio=4)
    if mcfg.family == "pointcloud":
        kw.update(in_dim=mcfg.in_dim, out_dim=mcfg.out_dim, n_layers=2)
    return dataclasses.replace(mcfg, **kw)
