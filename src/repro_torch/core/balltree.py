"""Ball-tree ordering and ragged batching (host-side numpy).

A copy of ``repro/core/balltree.py``: the ball order of one cloud
(``build_balltree_permutation``, ``ball_order``, ``ball_ids``), the padded
layout (``pack_ragged``, ``ragged_ball_order``) and the packed-varlen
layout (``pack_varlen``: all samples on one axis with an ``offsets``
array).
The tree is built by recursive median bisection along the axis of largest
extent; the model consumes only the permutation that sorts points into
ball order, after which every contiguous chunk of ``ball_size`` points is
one ball.
"""

from __future__ import annotations

import numpy as np

__all__ = ["build_balltree_permutation", "build_balltree_permutations", "ball_order",
           "ball_ids", "pad_to_multiple", "bucket_length", "pack_ragged", "unpack_ragged",
           "pack_items", "pack_varlen", "unpack_varlen", "ragged_ball_order"]


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


def ball_order(points: np.ndarray, features: np.ndarray, ball_size: int):
    """Permute ``features`` (and ``points``) into ball order.  Returns
    (points_perm, features_perm, perm, inv_perm)."""
    perm = build_balltree_permutation(points, ball_size)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])
    return points[perm], features[perm], perm, inv


def ball_ids(seq_len: int, ball_size: int) -> np.ndarray:
    """The ball id of each position of a ball-ordered sequence."""
    return np.arange(seq_len) // ball_size


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


# ---------------------------------------------------------------------------
# Packed-varlen layout: one concatenated axis + offsets (the cu_seqlens idiom)
#
#   packed  (T, ...)       samples back-to-back, each padded to a multiple of
#                          ``multiple`` (the ball size), so balls, φ blocks
#                          and selection groups never straddle two samples
#   offsets (S+1,) int32   sample i owns rows [offsets[i], offsets[i+1]);
#                          every entry a multiple of ``multiple``; trailing
#                          repeats are empty segments (a static shape)
#   mask    (T,) bool      True on real rows; prefix-true in each segment
#
# Rows at or after offsets[-1] are the capacity tail, shared by no sample.
# ---------------------------------------------------------------------------

def pack_varlen(arrays, multiple: int, *, pad_to: int | None = None,
                max_samples: int | None = None, value: float = 0.0,
                geometric: bool = True):
    """Concatenate variable-length arrays into one packed axis + offsets.

    ``arrays``: (n_i, ...) arrays sharing trailing dims.  Returns
    ``(packed (T, ...), offsets (S+1,) int32, mask (T,))``.  ``pad_to``
    freezes the capacity T (a multiple of ``multiple``, ≥ the packed
    total); otherwise T is ``bucket_length(total)``.  ``max_samples`` pads
    ``offsets`` to ``(max_samples + 1,)`` by repeating the final boundary.
    Inverse: :func:`unpack_varlen`."""
    arrays = [np.asarray(a) for a in arrays]
    if not arrays:
        raise ValueError("pack_varlen needs at least one array")
    if max_samples is not None and len(arrays) > max_samples:
        raise ValueError(f"{len(arrays)} samples > max_samples={max_samples}")
    lengths = [a.shape[0] for a in arrays]
    padded = [-(-n // multiple) * multiple for n in lengths]
    total = sum(padded)
    if pad_to is None:
        cap = bucket_length(total, multiple, geometric=geometric)
    else:
        if pad_to % multiple or pad_to < total:
            raise ValueError(f"pad_to={pad_to} must be a multiple of "
                             f"{multiple} and ≥ packed total {total}")
        cap = pad_to
    n_seg = max_samples if max_samples is not None else len(arrays)
    offsets = np.zeros((n_seg + 1,), dtype=np.int32)
    offsets[1:len(arrays) + 1] = np.cumsum(padded)
    offsets[len(arrays) + 1:] = total          # trailing repeats: empty segments
    packed = np.full((cap,) + arrays[0].shape[1:], value, dtype=arrays[0].dtype)
    mask = np.zeros((cap,), dtype=bool)
    for a, n, start in zip(arrays, lengths, offsets[:len(arrays)]):
        packed[start:start + n] = a
        mask[start:start + n] = True
    return packed, offsets, mask


def unpack_varlen(packed: np.ndarray, offsets: np.ndarray,
                  mask: np.ndarray | None = None) -> list:
    """Inverse of :func:`pack_varlen`: one array per segment; with ``mask``
    each sample's padding rows are dropped.  Empty segments give empty
    arrays."""
    packed = np.asarray(packed)
    offsets = np.asarray(offsets)
    outs = []
    for i in range(offsets.shape[0] - 1):
        a, b = int(offsets[i]), int(offsets[i + 1])
        if mask is not None:
            b = a + int(np.asarray(mask[a:b]).sum())
        outs.append(packed[a:b])
    return outs


def pack_items(items: list[dict], pad_to: int | None) -> dict:
    """Stack per-sample dicts of (padded) arrays into one packed batch dict.

    Each item maps field name → (L_i, ...) array (already a ball multiple
    long, with a ``feats`` entry and a bool ``mask``).  All fields re-pad to
    ``pad_to`` (or the batch max); padding rows carry mask=False and zero
    features, which the attention masks treat as invisible keys."""
    target = pad_to or max(it["feats"].shape[0] for it in items)
    return {k: pack_ragged([it[k] for it in items], 1, pad_to=target)[0]
            for k in items[0]}


def ragged_ball_order(points_list, features_list, ball_size: int, *,
                      pad_to: int | None = None, geometric: bool = True):
    """Ball-order each cloud of a ragged batch with its own tree and pack
    them.  Returns ``(points (B, L, D), feats (B, L, F), mask (B, L),
    perms)``; ``perms`` map predictions back to each cloud's point order."""
    perms = build_balltree_permutations(points_list, ball_size)
    pts = [np.asarray(p)[perm] for p, perm in zip(points_list, perms)]
    fts = [np.asarray(f)[perm] for f, perm in zip(features_list, perms)]
    pts_b, mask = pack_ragged(pts, ball_size, pad_to=pad_to, geometric=geometric)
    fts_b, _ = pack_ragged(fts, ball_size, pad_to=pad_to, geometric=geometric)
    return pts_b, fts_b, mask, perms
