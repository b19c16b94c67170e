"""qwen2-moe-a2.7b [moe]: 4 shared + 60 routed experts, top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B].

Counterpart of ``repro/configs/qwen2_moe_a2_7b.py``: 24 layers, d_model
2048, 16 query heads and 16 KV heads of 128, every layer's FFN a
mixture of 60 routed SwiGLU experts of 1408 (top 4; the stack padded to
64 inert experts the router never picks) beside a fused shared expert of
4 · 1408, vocabulary 151,936, bf16, causal BSA with ``LM_BSA``.
"""
from repro_torch.configs.base import ModelConfig, register
from repro_torch.configs.presets import LM_BSA


@register("qwen2-moe-a2.7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b", family="moe", n_layers=24, d_model=2048,
        n_heads=16, n_kv_heads=16, head_dim=128, d_ff=1408, vocab_size=151936,
        moe=True, n_experts=60, experts_per_token=4, moe_d_ff=1408,
        n_shared_experts=4, moe_period=1, pad_experts_to=64,
        attention="bsa", bsa=LM_BSA)
