"""mamba2-1.3b [ssm]: SSD, state-space duality [arXiv:2405.21060].

Counterpart of ``repro/configs/mamba2_1_3b.py``: 48 mamba-2 layers of
d_model 2048 (inner width 4096 in 64 heads of 64, state 128, causal
convolution of width 4), no attention and no FFN, vocabulary 50,280,
bf16.  BSA is attention-specific and does not apply: the chunked SSD is
itself sub-quadratic.
"""
from repro_torch.configs.base import ModelConfig, register


@register("mamba2-1.3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b", family="ssm", n_layers=48, d_model=2048,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, attention="none")
