"""Synthetic ShapeNet-Car-like clouds (airflow pressure regression).

A numpy copy of the generator in ``repro/data/shapenet.py``: car-like
bodies (superellipsoid hull + cabin + four wheel clusters, randomised
proportions) with a physically flavoured pressure field.  The real set is
889 cars × 3586 surface points; nothing is downloaded.  Features are
[xyz, n̂, 1] (in_dim = 7).
"""

from __future__ import annotations

import numpy as np

__all__ = ["N_POINTS", "make_cloud", "make_clouds"]

N_POINTS = 3586


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
