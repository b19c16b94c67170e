"""seamless-m4t-medium [audio]: encoder-decoder, multimodal [arXiv:2308.11596].

Counterpart of ``repro/configs/seamless_m4t_medium.py``: the audio
frontend is a stub (the batch carries frame embeddings of 1024); 12
encoder layers of non-causal BSA over the frames (the paper's point-set
form on 1-D frames, no RoPE) and 12 decoder layers of causal BSA,
cross-attention and SwiGLU, d_model 1024, 16 heads of 64, d_ff 4096,
vocabulary 256,206, decoder length frames / 8, bf16, ``LM_BSA``.
"""
from repro_torch.configs.base import ModelConfig, register
from repro_torch.configs.presets import LM_BSA


@register("seamless-m4t-medium")
def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium", family="audio", n_layers=12, d_model=1024,
        n_heads=16, n_kv_heads=16, head_dim=64, d_ff=4096, vocab_size=256206,
        is_encoder_decoder=True, n_encoder_layers=12, d_frontend=1024,
        dec_ratio=8, attention="bsa", bsa=LM_BSA)
