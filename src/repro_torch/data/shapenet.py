"""Synthetic ShapeNet-Car-like clouds (airflow pressure regression).

A numpy copy of the generator and the dataset in ``repro/data/shapenet.py``:
car-like bodies (superellipsoid hull + cabin + four wheel clusters,
randomised proportions) with a physically flavoured pressure field.  The
real set is 889 cars × 3586 surface points, split 700 train / 189 test;
nothing is downloaded.  Features are [xyz, n̂, 1] (in_dim = 7).
:class:`ShapeNetCarDataset` gives ball-ordered, padded samples and packed
batches for training; :func:`make_clouds` gives clouds in their original
point order for serving.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.balltree import (bucket_length, build_balltree_permutation,
                                       pack_items, pad_to_multiple)

__all__ = ["N_POINTS", "N_TRAIN", "N_TEST", "ShapeNetCarDataset", "make_cloud",
           "make_clouds"]

N_POINTS = 3586
N_TRAIN, N_TEST = 700, 189


def _superellipsoid(u, v, a, b, c, e1, e2):
    cu, su = np.cos(u), np.sin(u)
    cv, sv = np.cos(v), np.sin(v)
    sgn = lambda x: np.sign(x) * np.abs(x)
    x = a * sgn(cv) * np.abs(cv) ** (e1 - 1) * sgn(cu) * np.abs(cu) ** (e2 - 1)
    y = b * sgn(cv) * np.abs(cv) ** (e1 - 1) * sgn(su) * np.abs(su) ** (e2 - 1)
    z = c * sgn(sv) * np.abs(sv) ** (e1 - 1)
    return np.stack([x, y, z], -1)


def _make_car(rng: np.random.Generator, n: int) -> np.ndarray:
    """n surface points of a car-ish shape, length axis = x, up = z."""
    parts = []
    nb = int(n * 0.55)                                   # body
    u = rng.uniform(-np.pi, np.pi, nb)
    v = rng.uniform(-np.pi / 2, np.pi / 2, nb)
    body = _superellipsoid(u, v, a=2.0 + 0.3 * rng.uniform(), b=0.8,
                           c=0.45, e1=0.8, e2=0.9)
    body[:, 2] += 0.5
    parts.append(body)
    nc = int(n * 0.25)                                   # cabin
    u = rng.uniform(-np.pi, np.pi, nc)
    v = rng.uniform(0, np.pi / 2, nc)
    cab = _superellipsoid(u, v, a=0.9 + 0.2 * rng.uniform(), b=0.7,
                          c=0.4, e1=0.9, e2=0.9)
    cab[:, 0] -= 0.2
    cab[:, 2] += 0.95
    parts.append(cab)
    nw = n - nb - nc                                     # wheels
    per = nw // 4
    got = 0
    for sx in (-1.3, 1.15):
        for sy in (-0.75, 0.75):
            m = per if got < 3 * per else nw - 3 * per
            got += m
            th = rng.uniform(0, 2 * np.pi, m)
            wx = 0.33 * np.cos(th) + sx
            wz = 0.33 * np.sin(th) + 0.33
            wy = sy + rng.uniform(-0.08, 0.08, m)
            parts.append(np.stack([wx, wy, wz], -1))
    pts = np.concatenate(parts)[:n]
    pts += rng.normal(0, 0.005, pts.shape)
    return pts.astype(np.float32)


def _normals(pts: np.ndarray, k: int = 12) -> np.ndarray:
    """Approximate outward normals via local PCA."""
    center = pts.mean(0)
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    idx = np.argpartition(d2, k, axis=1)[:, :k]
    nrm = np.empty_like(pts)
    for i in range(pts.shape[0]):
        nb = pts[idx[i]] - pts[idx[i]].mean(0)
        _, _, vt = np.linalg.svd(nb, full_matrices=False)
        v = vt[-1]
        if np.dot(v, pts[i] - center) < 0:
            v = -v
        nrm[i] = v
    return nrm.astype(np.float32)


def _pressure(pts: np.ndarray, nrm: np.ndarray, rng) -> np.ndarray:
    """Physically flavoured pressure: stagnation + suction + wake noise."""
    v = np.array([-1.0, 0.0, 0.0], np.float32)          # flow toward −x
    ndv = nrm @ v
    cp = np.where(ndv > 0, ndv ** 2, -0.5 * ndv ** 2)   # stagnation vs suction
    cp -= 0.3 * np.clip(nrm[:, 2], 0, None) ** 2        # roof suction
    wake = (pts[:, 0] < -0.8).astype(np.float32)
    cp += wake * rng.normal(0, 0.08, pts.shape[0])
    cp += 0.02 * rng.normal(0, 1, pts.shape[0])
    return cp.astype(np.float32)[:, None]


class ShapeNetCarDataset:
    """Deterministic synthetic clone.  ``__getitem__`` → dict ready for the
    model: ball-ordered, padded features (N, 7), target (N, 1), mask (N,).

    ``n_points_range=(lo, hi)`` turns on variable-size clouds: sample i
    draws a point count in [lo, hi] from its own deterministic rng.
    ``batches()`` pads every sample of a batch to one shared length
    (``pad_to`` or the batch max) with per-sample masks."""

    def __init__(self, split: str = "train", ball_size: int = 256,
                 n_points: int = N_POINTS, seed: int = 1234,
                 normalize: bool = True,
                 n_points_range: tuple[int, int] | None = None):
        if split not in ("train", "test"):
            raise ValueError(f"split must be 'train' or 'test', got {split!r}")
        self.split = split
        self.ball_size = ball_size
        self.n_points = n_points
        self.n_points_range = n_points_range
        self.seed = seed
        self.offset = 0 if split == "train" else N_TRAIN
        self.length = N_TRAIN if split == "train" else N_TEST
        self.normalize = normalize

    def __len__(self):
        return self.length

    @property
    def max_padded_len(self) -> int:
        """Upper bound on any sample's padded length (a ``pad_to`` that
        freezes the batch shape)."""
        hi = self.n_points_range[1] if self.n_points_range else self.n_points
        return bucket_length(hi, self.ball_size, geometric=False)

    def _sample_n(self, rng: np.random.Generator) -> int:
        if self.n_points_range is None:
            return self.n_points
        lo, hi = self.n_points_range
        return int(rng.integers(lo, hi + 1))

    def __getitem__(self, i: int) -> dict:
        rng = np.random.default_rng(self.seed + self.offset + i)
        pts = _make_car(rng, self._sample_n(rng))
        nrm = _normals(pts)
        p = _pressure(pts, nrm, rng)
        if self.normalize:
            p = (p - 0.02) / 0.25
        perm = build_balltree_permutation(pts, self.ball_size)
        pts, nrm, p = pts[perm], nrm[perm], p[perm]
        feats = np.concatenate([pts, nrm, np.ones((pts.shape[0], 1), np.float32)], -1)
        feats, mask = pad_to_multiple(feats, self.ball_size)
        p, _ = pad_to_multiple(p, self.ball_size)
        return {"feats": feats, "target": p, "mask": mask}

    def batches(self, batch_size: int, *, shuffle=True, seed=0, epochs=None,
                pad_to: int | None = None):
        """Yield packed numpy batches {feats (B, L, 7), target (B, L, 1),
        mask (B, L)}; L is ``pad_to`` if given, else the batch's longest
        sample (already a ball multiple)."""
        rng = np.random.default_rng(seed)
        epoch = 0
        while epochs is None or epoch < epochs:
            order = rng.permutation(self.length) if shuffle else np.arange(self.length)
            for s in range(0, self.length - batch_size + 1, batch_size):
                items = [self[int(j)] for j in order[s:s + batch_size]]
                yield pack_items(items, pad_to)
            epoch += 1


def make_cloud(seed: int, n: int) -> dict:
    """One synthetic car in its original point order: ``points`` (n, 3),
    ``feats`` (n, 7) = [xyz, n̂, 1], ``target`` (n, 1) normalised pressure."""
    rng = np.random.default_rng(seed)
    pts = _make_car(rng, n)
    nrm = _normals(pts)
    p = (_pressure(pts, nrm, rng) - 0.02) / 0.25
    feats = np.concatenate([pts, nrm, np.ones((n, 1), np.float32)], -1)
    return {"points": pts, "feats": feats, "target": p}


def make_clouds(count: int, n_points_range: tuple[int, int], seed: int) -> list:
    """``count`` clouds, each with its own point count drawn in
    ``n_points_range`` (inclusive) from ``seed``."""
    lo, hi = n_points_range
    sizes = np.random.default_rng(seed).integers(lo, hi + 1, count)
    return [make_cloud(seed + 1 + i, int(n)) for i, n in enumerate(sizes)]
