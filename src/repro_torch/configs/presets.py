"""Shared BSA presets (counterpart of ``repro/configs/presets.py``)."""
from repro_torch.core.config import BSAConfig

# paper Appendix A, Table 4 — point-set form
PAPER_BSA = BSAConfig(ball_size=256, cmp_block=8, slc_block=8, top_k=4,
                      group_size=8, query_cmp_selection=True, phi="mean")
