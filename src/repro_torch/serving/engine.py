"""Batched inference over ragged point clouds (the point-cloud family).

Counterpart of ``repro/serving/engine.py::GeometryEngine``: per-cloud
ball-tree permutation on the host → pack → one forward on the model's
device → unpack and inverse-permute.  Two batch layouts:

* ``"packed"`` (the default for BSA, as in the JAX package): the clouds
  concatenated on one axis with a host ``offsets`` array
  (``balltree.pack_varlen``); no dummy slots and no padding to the largest
  cloud, so the forward's work follows Σnᵢ and not B·max nᵢ.
* ``"padded"``: one (B, L, ·) batch with per-sample masks.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from repro_torch.core.backend import use_backend
from repro_torch.core.balltree import (bucket_length, build_balltree_permutations,
                                       pack_ragged, pack_varlen, unpack_ragged,
                                       unpack_varlen)

__all__ = ["GeometryEngine"]


class GeometryEngine:
    """Serve (points, feats) clouds of any sizes, in request order, grouped
    into batches of ``batch_slots``.

    ``layout`` is ``"packed"`` or ``"padded"``; None picks ``"packed"`` for
    BSA models.  ``pad_to`` freezes the batch shape: the total packed
    capacity in the packed layout, the per-slot padded length in the padded
    one; otherwise each batch pads to a geometric bucket (of the packed
    total, resp. of its largest cloud).  A short final batch repeats the last
    offset (packed) or is filled with fully-masked dummy slots (padded), for
    which every branch returns exact zeros.  ``backend`` forces an attention
    backend by name for the engine's forwards (None = the model config's).
    The forward runs on the device of ``model``'s parameters; packed
    ``offsets`` stay on the host.
    """

    def __init__(self, api, model, *, batch_slots: int = 8,
                 pad_to: int | None = None, backend: str | None = None,
                 layout: str | None = None):
        if layout is None:
            layout = "packed" if api.mcfg.attention == "bsa" else "padded"
        if layout not in ("packed", "padded"):
            raise ValueError(f"layout must be 'packed' or 'padded', got {layout!r}")
        self.api = api
        self.model = model
        self.batch_slots = batch_slots
        self.pad_to = pad_to
        self.backend = backend
        self.layout = layout
        self.ball_size = api.mcfg.bsa.ball_size
        self.device = next(model.parameters()).device
        self.clouds_served = 0
        self.points_served = 0
        self.predict_time = 0.0

    @torch.no_grad()
    def predict(self, clouds) -> list[np.ndarray]:
        """clouds: ``(points (n_i, d), feats (n_i, in_dim))`` pairs or dicts
        with those keys.  Returns one (n_i, out_dim) array per cloud, rows
        in the caller's original point order.  Runs under no-grad."""
        clouds = [(c["points"], c["feats"]) if isinstance(c, dict) else c
                  for c in clouds]
        results: list[np.ndarray] = []
        t0 = time.perf_counter()
        for s in range(0, len(clouds), self.batch_slots):
            results.extend(self._predict_batch(clouds[s:s + self.batch_slots]))
        self.predict_time += time.perf_counter() - t0
        self.clouds_served += len(clouds)
        self.points_served += sum(int(np.asarray(p).shape[0]) for p, _ in clouds)
        return results

    def pack_batch(self, chunk):
        """Ball-order and pack up to ``batch_slots`` (points, feats) clouds:
        returns (batch, mask as numpy, per-cloud permutations).  The batch
        holds "feats" (B, L, in_dim) and "mask" (B, L) on the model's device
        (B = 1 in the packed layout) and, packed, "offsets" (batch_slots + 1,)
        int32 on the host."""
        pts_list = [np.asarray(p) for p, _ in chunk]
        fts_list = [np.asarray(f, np.float32) for _, f in chunk]
        perms = build_balltree_permutations(pts_list, self.ball_size)
        ordered = [f[perm] for f, perm in zip(fts_list, perms)]
        if self.layout == "packed":
            feats, offsets, mask = pack_varlen(ordered, self.ball_size, pad_to=self.pad_to,
                                               max_samples=self.batch_slots)
            batch = {"feats": torch.from_numpy(feats[None]).to(self.device),
                     "mask": torch.from_numpy(mask[None]).to(self.device),
                     "offsets": torch.from_numpy(offsets)}
            return batch, mask[None], perms
        target = self.pad_to or bucket_length(
            max(f.shape[0] for f in ordered), self.ball_size)
        pad_slots = self.batch_slots - len(chunk)
        if pad_slots > 0:
            ordered += [np.zeros((1, ordered[0].shape[1]), np.float32)] * pad_slots
        feats, mask = pack_ragged(ordered, self.ball_size, pad_to=target)
        if pad_slots > 0:
            mask[len(chunk):] = False
        batch = {"feats": torch.from_numpy(feats).to(self.device),
                 "mask": torch.from_numpy(mask).to(self.device)}
        return batch, mask, perms

    def _predict_batch(self, chunk) -> list[np.ndarray]:
        batch, mask, perms = self.pack_batch(chunk)
        scope = use_backend(self.backend) if self.backend else contextlib.nullcontext()
        with scope:
            pred = self.api.forward(self.model, batch)
        if self.layout == "packed":
            per_cloud = unpack_varlen(pred[0].cpu().numpy(),
                                      batch["offsets"].numpy()[:len(chunk) + 1], mask[0])
        else:
            per_cloud = unpack_ragged(pred.cpu().numpy(), mask)[:len(chunk)]
        out = []
        for rows, perm in zip(per_cloud, perms):
            unperm = np.empty_like(rows)
            unperm[perm] = rows                    # ball order → original order
            out.append(unperm)
        return out

    @property
    def points_per_second(self) -> float:
        return self.points_served / max(self.predict_time, 1e-9)
