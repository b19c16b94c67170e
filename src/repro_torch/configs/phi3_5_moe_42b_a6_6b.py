"""phi3.5-moe-42b-a6.6b [moe]: 16 experts, top-2 [hf:microsoft/Phi-3.5-MoE-instruct].

Counterpart of ``repro/configs/phi3_5_moe_42b_a6_6b.py``: 32 layers,
d_model 4096, 32 query heads on 8 KV heads of 128 (rep 4), every FFN a
mixture of 16 SwiGLU experts of 6400 (top 2), vocabulary 32,064, bf16,
causal BSA with ``LM_BSA``.
"""
from repro_torch.configs.base import ModelConfig, register
from repro_torch.configs.presets import LM_BSA


@register("phi3.5-moe-42b-a6.6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b", family="moe", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, head_dim=128, d_ff=6400, vocab_size=32064,
        moe=True, n_experts=16, experts_per_token=2, moe_d_ff=6400,
        moe_period=1, attention="bsa", bsa=LM_BSA)
