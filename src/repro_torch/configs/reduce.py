"""Reduced ("smoke") configs: the same family structure, tiny dimensions.

A copy of ``repro/configs/reduce.py::smoke_config`` for the families the
port has (``repro.configs.reduce`` imports jax through ``repro.core``, so
it is copied, not imported).
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
    """Scale a config down to CPU-smoke size, keeping its structure: two
    layers, d_model 64, four query heads of 16 (GQA rep up to 4), d_ff 128,
    vocabulary 512, ``SMOKE_BSA``, fp32, no remat."""
    if mcfg.n_heads:
        rep = max(1, min(mcfg.n_heads // max(mcfg.n_kv_heads, 1), 4))
        n_heads = 4
        n_kv_heads = max(1, 4 // rep)
    else:
        n_heads = n_kv_heads = 0
    kw = dict(
        n_layers=2,
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
    if mcfg.family == "pointcloud":
        kw.update(in_dim=mcfg.in_dim, out_dim=mcfg.out_dim)
    return dataclasses.replace(mcfg, **kw)
