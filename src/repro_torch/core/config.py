"""Configuration for Ball Sparse Attention (paper Appendix A defaults).

A copy of ``repro/core/config.py::BSAConfig`` with its validation (the port
cannot import it: ``repro.core`` imports jax).  The deprecated
``use_kernels`` flag is not carried over.  ``backend`` names a backend of
``repro_torch.core.backend``: ``"reference"``, ``"kernels"`` or ``"auto"``.
"""

from __future__ import annotations

import dataclasses

__all__ = ["BSAConfig"]


@dataclasses.dataclass(frozen=True)
class BSAConfig:
    ball_size: int = 256            # m — BTA ball size (power of two)
    cmp_block: int = 8              # ℓ — compression block length (stride = ℓ)
    slc_block: int = 8              # selection block length (paper uses = ℓ)
    top_k: int = 4                  # k* — number of selected blocks
    group_size: int = 8             # g — query group for shared selection (0 ⇒ off)
    query_cmp_selection: bool = True   # Eq. 13–14: score with pooled queries
    group_compression: bool = False    # Eq. 15: pooled-query compression branch
    phi: str = "mean"               # φ pooling: "mean" | "mlp" (mlp not ported)
    gate_mode: str = "scalar"       # σ(γ_b): "scalar" (per head) | "token"
    mask_own_ball: bool = True      # §3.2: selection ignores blocks in own ball
    local_window: int = 0           # causal variant (not ported); 0 ⇒ ball_size
    force_first_block: bool = True  # causal variant (not ported)
    backend: str = "auto"           # "reference" | "kernels" | "auto" | plug-in
    backend_overrides: tuple = ()   # per-branch redirects, keys "ball"|"cmp"|"slc"
    jnp_chunk_tokens: int = 0       # reference path: query-chunk bound (0 = off)
    score_dtype: str = "float32"    # "float32" | "bfloat16"

    def __post_init__(self):
        if isinstance(self.backend_overrides, dict):
            object.__setattr__(self, "backend_overrides",
                               tuple(sorted(self.backend_overrides.items())))
        for branch, name in self.backend_overrides:
            if branch not in ("ball", "cmp", "slc"):
                raise ValueError(f"backend_overrides key {branch!r} invalid "
                                 "(must be 'ball', 'cmp' or 'slc')")
            if not isinstance(name, str):
                raise ValueError(f"backend_overrides[{branch!r}] must be a "
                                 f"backend NAME, got {type(name).__name__}")
        sd = self.score_dtype
        if not isinstance(sd, str):
            sd = str(sd).replace("torch.", "")
            object.__setattr__(self, "score_dtype", sd)
        if sd not in ("float32", "bfloat16"):
            raise ValueError(f"score_dtype {self.score_dtype!r} must be "
                             '"float32" or "bfloat16"')
        if self.ball_size & (self.ball_size - 1):
            raise ValueError("ball_size must be a power of two")
        if self.slc_block != self.cmp_block:
            raise ValueError("selection block must equal compression block "
                             "(paper setting; keeps score→block mapping trivial)")
        if self.ball_size % self.cmp_block:
            raise ValueError("cmp_block must divide ball_size")
        if self.group_size and self.ball_size % self.group_size:
            raise ValueError("group_size must divide ball_size")
        if self.group_size and self.query_cmp_selection and (
                self.group_size % self.cmp_block and self.cmp_block % self.group_size):
            raise ValueError("group_size and cmp_block must nest")
