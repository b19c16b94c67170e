"""Rotary position embeddings (RoPE).

Counterpart of ``repro/layers/rope.py``: half-split rotation (the first and
second halves of the head dim form the pairs, not interleaved lanes),
computed in fp32 and returned in the input's dtype.
"""

from __future__ import annotations

import torch

__all__ = ["rope_freqs", "rope_angles", "rotate", "apply_rope"]


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), fp32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float = 10000.0):
    """(cos, sin) of the rotation angles at integer ``positions`` (…, seq),
    each (…, seq, 1, head_dim / 2) fp32: one computation serves q and k."""
    ang = positions[..., None].float() * rope_freqs(head_dim, theta, positions.device)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (…, seq, heads, head_dim) turned by (cos, sin) of :func:`rope_angles`,
    in fp32, returned in x's dtype."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (…, seq, heads, head_dim); positions: broadcastable to (…, seq),
    integer.  Returns x rotated by each position's angles, in x's dtype."""
    return rotate(x, *rope_angles(positions, x.shape[-1], theta))
