"""jamba-1.5-large-398b [hybrid]: mamba and attention 7:1, MoE of 16 experts
top-2 every second layer [arXiv:2403.19887].

Counterpart of ``repro/configs/jamba_1_5_large_398b.py``: 72 layers in
periods of 8 (the fifth, ``P // 2``, is attention, the others mamba-2;
every second FFN a mixture of experts), d_model 8192, 64 query heads on 8
KV heads of 128, d_ff 24,576, vocabulary 65,536, bf16 with bf16 AdamW
moments, causal BSA with ``LM_BSA``.
"""
from repro_torch.configs.base import ModelConfig, register
from repro_torch.configs.presets import LM_BSA


@register("jamba-1.5-large-398b")
def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid", n_layers=72, d_model=8192,
        n_heads=64, n_kv_heads=8, head_dim=128, d_ff=24576, vocab_size=65536,
        moe=True, n_experts=16, experts_per_token=2, moe_d_ff=24576,
        moe_period=2, attn_period=8,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2,
        attention="bsa", bsa=LM_BSA, opt_state_dtype="bfloat16", fsdp=True)
