"""Erwin-style baseline: Ball-Tree Attention with hierarchical coarsening.

Counterpart of ``repro/core/erwin.py`` (Zhdanov et al. 2025, the
comparison system of the paper's Tables 1–3): per layer, ball attention at
a layer-dependent coarsening level.  q, k and v are mean-pooled by 2^level
along the ball order, attended within balls of ``ball_size`` on the pooled
sequence (so the receptive field covers 2^level·ball_size leaf tokens), and
the output is un-pooled back to full resolution by repetition.  On the
``kernels`` backend the ball kernels (``kernels/bta.py``) run on the pooled
sequence.
"""

from __future__ import annotations

import torch

from repro_torch.core.backend import resolve_backend

__all__ = ["erwin_attention"]


def erwin_attention(q, k, v, *, ball_size: int, level: int = 0, mask=None,
                    backend=None) -> torch.Tensor:
    """BTA at coarsening ``level`` (0 = leaf balls, the paper's BTA).

    q: (B, N, Hq, D); k, v: (B, N, Hkv, D), K/V un-repeated (GQA-native);
    ``mask``: (B, N) bool or None.  For level > 0 with s = 2^level, N must
    be a multiple of s·ball_size: q, k, v are mean-pooled over s tokens in
    their own dtype (padded tokens included, as the reference does), a
    pooled token is valid iff one of its s tokens is, and the pooled
    output is repeated s times (its gradient sums over the copies).  Rows
    that ``mask`` marks padded come back zero.  ``backend`` names a backend
    (or is one), resolved by :func:`core.backend.resolve_backend`.  Returns
    (B, N, Hq, D)."""
    B, N, Hq, D = q.shape
    bk = resolve_backend(backend)
    s = 1 << level
    if s > 1:
        if N % (s * ball_size):
            raise ValueError(
                f"erwin_attention: N={N} is not a multiple of 2^level·ball_size = "
                f"{s}·{ball_size} = {s * ball_size} (level {level}): the pooled "
                "sequence must hold whole balls")

        def pool(t):
            return t.reshape(B, N // s, s, t.shape[2], D).mean(dim=2).to(t.dtype)

        mp = None if mask is None else mask.reshape(B, N // s, s).any(-1)
        outp = bk.ball(pool(q), pool(k), pool(v), mp, ball_size=ball_size)
        out = outp[:, :, None].expand(B, N // s, s, Hq, D).reshape(B, N, Hq, D)
    else:
        out = bk.ball(q, k, v, mask, ball_size=ball_size)
    if mask is not None:
        out = torch.where(mask[:, :, None, None], out, torch.zeros((), dtype=out.dtype,
                                                                   device=out.device))
    return out
