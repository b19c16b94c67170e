"""Shared BSA presets (counterpart of ``repro/configs/presets.py``)."""
from repro_torch.core.config import BSAConfig

# paper Appendix A, Table 4 — point-set form
PAPER_BSA = BSAConfig(ball_size=256, cmp_block=8, slc_block=8, top_k=4,
                      group_size=8, query_cmp_selection=True, phi="mean")

# causal-LM form: NSA-scale blocks for long sequences; jnp_chunk_tokens
# bounds the reference path's temporary memory (the kernels ignore it)
LM_BSA = BSAConfig(ball_size=256, local_window=256, cmp_block=64, slc_block=64,
                   top_k=16, group_size=64, query_cmp_selection=True, phi="mean",
                   jnp_chunk_tokens=256)
