"""tinyllama-1.1b [dense]: llama2-architecture small LM [arXiv:2401.02385].

Counterpart of ``repro/configs/tinyllama_1_1b.py``: 22 layers, d_model
2048, 32 query heads and 4 KV heads of 64, SwiGLU d_ff 5632, vocabulary
32000, bf16 parameters and compute, causal BSA with ``LM_BSA``.
"""
from repro_torch.configs.base import ModelConfig, register
from repro_torch.configs.presets import LM_BSA


@register("tinyllama-1.1b")
def config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b", family="dense", n_layers=22, d_model=2048,
        n_heads=32, n_kv_heads=4, head_dim=64, d_ff=5632, vocab_size=32000,
        attention="bsa", bsa=LM_BSA)
