"""Synthetic Elasticity benchmark proxy (Li et al. 2021): 972-point meshes of
a plate with a random void, stress-field regression.

A numpy copy of ``repro/data/elasticity.py``: the paper's Table 2 sizes
(972 points → padded to 1024 = 4 balls of 256), features [x, y, 0, cx, cy,
rx] (in_dim = 6).  ``n_points_range=(lo, hi)`` gives every mesh its own
point count, and ``batches()`` packs mixed-size meshes into one padded
batch with a mask, as ``data/shapenet.py`` does.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.balltree import (bucket_length, build_balltree_permutation,
                                       pack_items, pad_to_multiple)

__all__ = ["N_POINTS", "ElasticityDataset"]

N_POINTS = 972


class ElasticityDataset:
    def __init__(self, split="train", ball_size: int = 256, seed: int = 77,
                 n_points: int = N_POINTS,
                 n_points_range: tuple[int, int] | None = None):
        self.length = 1000 if split == "train" else 200
        self.offset = 0 if split == "train" else 1000
        self.ball_size = ball_size
        self.seed = seed
        self.n_points = n_points
        self.n_points_range = n_points_range

    def __len__(self):
        return self.length

    @property
    def max_padded_len(self) -> int:
        """Static batch length for ``batches(pad_to=...)``."""
        hi = self.n_points_range[1] if self.n_points_range else self.n_points
        return bucket_length(hi, self.ball_size, geometric=False)

    def __getitem__(self, i: int) -> dict:
        rng = np.random.default_rng(self.seed + self.offset + i)
        # unit plate with an elliptic void; points on a jittered grid
        if self.n_points_range is None:
            n = self.n_points
        else:
            n = int(rng.integers(self.n_points_range[0], self.n_points_range[1] + 1))
        pts = rng.uniform(0, 1, (int(n * 1.6), 2)).astype(np.float32)
        cx, cy = rng.uniform(0.3, 0.7, 2)
        rx, ry = rng.uniform(0.08, 0.22, 2)
        keep = (((pts[:, 0] - cx) / rx) ** 2 + ((pts[:, 1] - cy) / ry) ** 2) > 1.0
        pts = pts[keep][:n]
        while pts.shape[0] < n:  # top-up
            extra = rng.uniform(0, 1, (n, 2)).astype(np.float32)
            keep = (((extra[:, 0] - cx) / rx) ** 2 + ((extra[:, 1] - cy) / ry) ** 2) > 1.0
            pts = np.concatenate([pts, extra[keep]])[:n]
        # stress proxy: concentration around the void (Kirsch-like decay)
        d = np.sqrt(((pts[:, 0] - cx) / rx) ** 2 + ((pts[:, 1] - cy) / ry) ** 2)
        stress = (1.0 + 1.5 / np.maximum(d, 1.0) ** 2 *
                  (1.0 + np.cos(2 * np.arctan2(pts[:, 1] - cy, pts[:, 0] - cx))))
        stress = stress.astype(np.float32)[:, None]
        p3 = np.concatenate([pts, np.zeros((n, 1), np.float32)], -1)
        perm = build_balltree_permutation(p3, self.ball_size)
        pts, stress = pts[perm], stress[perm]
        feats = np.concatenate(
            [pts, np.zeros((n, 1), np.float32),
             np.broadcast_to([cx, cy, rx], (n, 3)).astype(np.float32)], -1)
        feats, mask = pad_to_multiple(feats, self.ball_size)
        stress, _ = pad_to_multiple(stress, self.ball_size)
        return {"feats": feats, "target": stress, "mask": mask}

    def batches(self, batch_size: int, *, shuffle=True, seed=0, epochs=None,
                pad_to: int | None = None):
        """Yield packed numpy batches {feats (B, L, 6), target (B, L, 1),
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
