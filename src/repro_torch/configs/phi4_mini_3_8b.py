"""phi4-mini-3.8b [dense]: RoPE, SwiGLU, GQA [arXiv:2412.08905].

Counterpart of ``repro/configs/phi4_mini_3_8b.py``: 32 layers, d_model
3072, 24 query heads on 8 KV heads of 128 (rep 3), SwiGLU d_ff 8192,
vocabulary 200,064, bf16 parameters and compute, causal BSA with
``LM_BSA``.
"""
from repro_torch.configs.base import ModelConfig, register
from repro_torch.configs.presets import LM_BSA


@register("phi4-mini-3.8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b", family="dense", n_layers=32, d_model=3072,
        n_heads=24, n_kv_heads=8, head_dim=128, d_ff=8192, vocab_size=200064,
        attention="bsa", bsa=LM_BSA)
