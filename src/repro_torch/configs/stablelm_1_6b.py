"""stablelm-1.6b [dense]: [hf:stabilityai/stablelm-2-1_6b].

Counterpart of ``repro/configs/stablelm_1_6b.py``: 24 layers, d_model
2048, 32 query heads and 32 KV heads of 64 (no GQA: rep 1), SwiGLU d_ff
5632, vocabulary 100,352, bf16 parameters and compute, causal BSA with
``LM_BSA``.
"""
from repro_torch.configs.base import ModelConfig, register
from repro_torch.configs.presets import LM_BSA


@register("stablelm-1.6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b", family="dense", n_layers=24, d_model=2048,
        n_heads=32, n_kv_heads=32, head_dim=64, d_ff=5632, vocab_size=100352,
        attention="bsa", bsa=LM_BSA)
