"""llava-next-34b [vlm]: anyres tiling [hf:llava-hf/llava-v1.6].

Counterpart of ``repro/configs/llava_next_34b.py``: the vision frontend is
a stub (the batch carries 512 precomputed patch embeddings of 1024), the
two-layer projector and the LM backbone are real: 60 layers, d_model
7168, 56 query heads on 8 KV heads of 128 (rep 7), SwiGLU d_ff 20,480,
vocabulary 64,000, bf16, causal BSA with ``LM_BSA``.
"""
from repro_torch.configs.base import ModelConfig, register
from repro_torch.configs.presets import LM_BSA


@register("llava-next-34b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b", family="vlm", n_layers=60, d_model=7168,
        n_heads=56, n_kv_heads=8, head_dim=128, d_ff=20480, vocab_size=64000,
        vision_tokens=512, d_frontend=1024,
        attention="bsa", bsa=LM_BSA, attn_shard_mode="sequence")
