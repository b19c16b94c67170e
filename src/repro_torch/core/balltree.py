"""Ball-tree ordering and ragged batching (host-side numpy).

A copy of the parts of ``repro/core/balltree.py`` the padded serving path
uses.  The tree is built by recursive median bisection along the axis of
largest extent; the model consumes only the permutation that sorts points
into ball order, after which every contiguous chunk of ``ball_size``
points is one ball.
"""

from __future__ import annotations

import numpy as np

__all__ = ["build_balltree_permutation", "build_balltree_permutations",
           "pad_to_multiple", "bucket_length", "pack_ragged", "unpack_ragged"]


def _bisect(points: np.ndarray, idx: np.ndarray, out: list, leaf_size: int) -> None:
    """Recursively median-split ``idx`` along the longest axis until leaves
    hold at most ``leaf_size`` points; append the leaves to ``out``."""
    if idx.shape[0] <= leaf_size:
        out.append(idx)
        return
    pts = points[idx]
    extent = pts.max(axis=0) - pts.min(axis=0)
    axis = int(np.argmax(extent))
    order = np.argsort(pts[:, axis], kind="stable")
    half = idx.shape[0] // 2
    left = idx[order[: half + (idx.shape[0] % 2)]]     # odd remainder goes left
    right = idx[order[half + (idx.shape[0] % 2):]]
    _bisect(points, left, out, leaf_size)
    _bisect(points, right, out, leaf_size)


def build_balltree_permutation(points: np.ndarray, ball_size: int) -> np.ndarray:
    """``perm`` such that ``points[perm]`` is in ball order.  ``points``:
    (N, D); ``ball_size`` a power of two; N need not be a multiple of it."""
    points = np.asarray(points)
    if points.ndim != 2:
        raise ValueError(f"points must be (N, D), got {points.shape}")
    if ball_size < 1 or (ball_size & (ball_size - 1)) != 0:
        raise ValueError(f"ball_size must be a positive power of two, got {ball_size}")
    leaves: list = []
    _bisect(points, np.arange(points.shape[0], dtype=np.int64), leaves, ball_size)
    return np.concatenate(leaves)


def build_balltree_permutations(points_list, ball_size: int) -> list:
    """One independent ball-tree permutation per cloud of a ragged batch."""
    return [build_balltree_permutation(p, ball_size) for p in points_list]


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0, value: float = 0.0):
    """Pad ``x`` along ``axis`` to the next multiple; returns (padded, mask)
    with mask (padded_len,) True on real rows."""
    n = x.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    mask = np.zeros((target,), dtype=bool)
    mask[:n] = True
    if target == n:
        return x, mask
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, target - n)
    return np.pad(x, widths, constant_values=value), mask


def bucket_length(n: int, multiple: int, *, geometric: bool = True) -> int:
    """Padded length for an ``n``-point cloud: a multiple of ``multiple``,
    with the ball count rounded up to a power of two when ``geometric``."""
    if n < 1:
        raise ValueError(f"need at least one point, got n={n}")
    balls = -(-n // multiple)
    if geometric:
        balls = 1 << (balls - 1).bit_length()
    return balls * multiple


def pack_ragged(arrays, multiple: int, *, pad_to: int | None = None,
                value: float = 0.0, geometric: bool = False):
    """Stack variable-length arrays into one bucket-padded batch.  Returns
    ``(batch (B, L, ...), mask (B, L))``; inverse :func:`unpack_ragged`."""
    arrays = [np.asarray(a) for a in arrays]
    if not arrays:
        raise ValueError("pack_ragged needs at least one array")
    lengths = [a.shape[0] for a in arrays]
    if pad_to is None:
        target = bucket_length(max(lengths), multiple, geometric=geometric)
    else:
        if pad_to % multiple or pad_to < max(lengths):
            raise ValueError(f"pad_to={pad_to} must be a multiple of "
                             f"{multiple} and ≥ max sample size {max(lengths)}")
        target = pad_to
    batch = np.full((len(arrays), target) + arrays[0].shape[1:], value,
                    dtype=arrays[0].dtype)
    mask = np.zeros((len(arrays), target), dtype=bool)
    for i, (a, n) in enumerate(zip(arrays, lengths)):
        batch[i, :n] = a
        mask[i, :n] = True
    return batch, mask


def unpack_ragged(batch: np.ndarray, mask: np.ndarray) -> list:
    """Split a padded batch back into per-sample arrays (masks are
    prefix-true, as :func:`pack_ragged` makes them)."""
    batch = np.asarray(batch)
    mask = np.asarray(mask)
    return [batch[i, : int(mask[i].sum())] for i in range(batch.shape[0])]
