"""granite-20b [dense]: llama architecture, code [arXiv:2405.04324].

Counterpart of ``repro/configs/granite_20b.py``: 52 layers, d_model 6144,
48 query heads on one KV head of 128 (rep 48), SwiGLU d_ff 24,576,
vocabulary 49,152, bf16 parameters and compute, causal BSA with
``LM_BSA``.  In this repository's form (SwiGLU, untied embeddings) it has
28.17 B parameters: 56.3 GB in bf16.
"""
from repro_torch.configs.base import ModelConfig, register
from repro_torch.configs.presets import LM_BSA


@register("granite-20b")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b", family="dense", n_layers=52, d_model=6144,
        n_heads=48, n_kv_heads=1, head_dim=128, d_ff=24576, vocab_size=49152,
        attention="bsa", bsa=LM_BSA)
