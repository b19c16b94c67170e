#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA card (written for an H100) and the CUDA toolkit; it
imports nothing of JAX and nothing of the JAX package.  Phases:

1. set-up: the card's name and power limit, the kernels' build (one nvcc
   per CUDA source, all at once), TF32 off for every fp32 product;
2. kernels: each CUDA kernel against its plain PyTorch version on the card,
   in fp32 and bf16 and, for flash, in its causal modes too (fp32); with
   the median time of kernel, plain version and (where one exists) the
   library call, and the least time the H100 could take for the same work.
   The four padded forward kernels run at the shapes serving
   ``shapenet-bsa`` gives them (8 slots of 3840 points, sample 0 padded
   from a 3586-point cloud, the others 2800–3586 points, 8 heads of 32);
   the five padded backward kernels at the shapes one train step gives them
   (8 train clouds of 3586 points padded to 3840), with the upstream
   gradient zero on padded query rows as the combine gives it; the
   selection backward on each layer's own top-k picks in the model's first
   train step (mode ``topk``, the main path's traffic) and on uniform
   random picks.  The three packed-varlen kernels: ``varlen_fwd`` at the
   shapes packed serving gives the compression branch (the first 8 serving
   clouds packed to a capacity of 30,720 rows, queries against the 3840
   pooled keys, ``k_offsets = offsets / 8``), ``varlen_dq`` and
   ``varlen_dkv`` at the packed train batch's;
3. serve, padded then packed: ``shapenet-bsa`` at full width (18 layers,
   random weights from a seed) serves 16 synthetic clouds of 2800–3586
   points through ``GeometryEngine(batch_slots=8)``, ``layout="padded"``
   with ``pad_to=3840`` and ``layout="packed"`` with ``pad_to=30720`` (the
   same capacity), each after a warm-up batch; each forward kernel of the
   layout's path must have launched 18 times per batch (and no other
   kernel), the outputs must be finite with one row per point, and on one
   batch every layer of the kernel path must match the ``reference``
   backend given the same layer input (``reference_check``); the packed
   and padded outputs are compared (information: top-k near-ties may
   flip);
4. train, padded then packed: ``shapenet-bsa`` at full width and depth
   (18 layers, fp32) takes one warm-up step and then five timed steps of
   ``make_train_step`` (masked MSE, backward, clipping at 1.0, AdamW at lr
   1e-3 with warm-up and cosine decay over 300 steps, weight decay 0.01),
   padded on batches of 8 ShapeNet-Car train clouds padded to 3840, packed
   on batches of 8 train clouds of 2800–3586 points packed to 30,720 rows
   with their offsets on the host; loss and every gradient must be finite,
   each kernel of the layout's path must have launched 18 times per step
   (and no other kernel), and on one batch every layer's parameter and
   input gradients on the kernel path must match the ``reference``
   backend's given the same layer input and upstream gradient, within 1e-4
   of each tensor's largest value (``train_reference_check``).

Nothing is cut: every path runs at full width and depth.  Any failed check
exits non-zero before the result lines.  On success the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.backend import use_backend  # noqa: E402
from repro_torch.core.balltree import pack_varlen  # noqa: E402
from repro_torch.data.shapenet import N_POINTS, ShapeNetCarDataset, make_clouds  # noqa: E402
from repro_torch.kernels import _build, bta, epilogue, flash, selection, varlen  # noqa: E402
from repro_torch.kernels.common import COUNTERS, reset_counters, row_delta  # noqa: E402
from repro_torch.kernels.occupancy import (ranges_live_map, tile_seg_ranges,  # noqa: E402
                                           varlen_maps)
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.layers.nn import dense, rmsnorm  # noqa: E402
from repro_torch.models.api import model_api  # noqa: E402
from repro_torch.models.pointcloud import pc_layer  # noqa: E402
from repro_torch.numerics import NEG_INF  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.serving.engine import GeometryEngine  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s, fp32
# outside the tensor cores, bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 4e-2}
SEL_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 6e-2}
GRAD_REL_TOL = 1e-4          # train_reference_check, relative to each tensor's max
TRAIN_STEPS = 5

# the kernels, their sources and the TPU kernels they replace
KERNELS = {
    "bta_fwd": ("src/repro_torch/csrc/bta_fwd.cu", "src/repro/kernels/bta.py:57"),
    "flash_fwd": ("src/repro_torch/csrc/flash_fwd.cu", "src/repro/kernels/flash.py:87"),
    "selection_fwd": ("src/repro_torch/csrc/selection_fwd.cu",
                      "src/repro/kernels/selection.py:53"),
    "epilogue_fwd": ("src/repro_torch/csrc/epilogue_fwd.cu",
                     "src/repro/kernels/epilogue.py:36"),
    "bta_bwd": ("src/repro_torch/csrc/bta_bwd.cu", "src/repro/kernels/bta.py:90"),
    "flash_dq": ("src/repro_torch/csrc/flash_bwd.cu", "src/repro/kernels/flash.py:141"),
    "flash_dkv": ("src/repro_torch/csrc/flash_bwd.cu", "src/repro/kernels/flash.py:183"),
    "selection_bwd": ("src/repro_torch/csrc/selection_bwd.cu",
                      "src/repro/kernels/selection.py:103"),
    "epilogue_bwd": ("src/repro_torch/csrc/epilogue_bwd.cu",
                     "src/repro/kernels/epilogue.py:43"),
    "varlen_fwd": ("src/repro_torch/csrc/varlen_fwd.cu", "src/repro/kernels/varlen.py:67"),
    "varlen_dq": ("src/repro_torch/csrc/varlen_bwd.cu", "src/repro/kernels/varlen.py:117"),
    "varlen_dkv": ("src/repro_torch/csrc/varlen_bwd.cu", "src/repro/kernels/varlen.py:154"),
}
# the kernels each path runs (every other kernel must stay at 0 launches there)
PATHS = {"serve_padded": ("bta_fwd", "flash_fwd", "selection_fwd", "epilogue_fwd"),
         "serve_packed": ("bta_fwd", "varlen_fwd", "selection_fwd", "epilogue_fwd")}
PATHS["train_padded"] = PATHS["serve_padded"] + (
    "bta_bwd", "flash_dq", "flash_dkv", "selection_bwd", "epilogue_bwd")
PATHS["train_packed"] = PATHS["serve_packed"] + (
    "bta_bwd", "varlen_dq", "varlen_dkv", "selection_bwd", "epilogue_bwd")

# the slice's shapes: shapenet-bsa served 8 clouds at a time, padded to 3840
B, N, H, D = 8, 3840, 8, 32
BALL, ELL, KSTAR, GROUP = 256, 8, 4, 8
NB = N // ELL
REAL_POINTS = N_POINTS                  # sample 0: a full ShapeNet-Car cloud
CAPACITY = B * N                        # packed rows: the padded batch's 8 × 3840


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, warmup: int = 3, reps: int = 15) -> float:
    """Median of per-call CUDA-event times after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_err(got, want, rows=None, tol_table=TOL) -> tuple[float, bool]:
    """(max |got − want| over finite comparisons, within tolerance?)"""
    errs, ok = [], True
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        if rows is not None:
            g, w = g[rows], w[rows]
        if not torch.isfinite(g).all():
            return float("nan"), False
        d = (g - w).abs()
        tol = tol_table[got[0].dtype] * (1 + w.abs())
        ok = ok and bool((d <= tol).all())
        errs.append(float(d.max()))
    return max(errs), ok


def slice_mask(dev) -> torch.Tensor:
    """(B, N) bool: sample 0 is a 3586-point cloud padded to 3840; the others
    are 2800–3586-point clouds, as serving gets them."""
    g = torch.Generator().manual_seed(11)
    sizes = torch.randint(2800, REAL_POINTS + 1, (B,), generator=g)
    sizes[0] = REAL_POINTS
    return (torch.arange(N)[None, :] < sizes[:, None]).to(dev)


def rand(shape, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def recorder(results: list):
    def record(name, mode, dtype, err, ok, k_ms, p_ms, b_ms, b_by, lib_ms):
        row = {"name": name, "mode": mode, "dtype": str(dtype).replace("torch.", ""),
               "max_abs_err": err, "within_tol": ok, "kernel_ms": k_ms,
               "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": lib_ms}
        print(json.dumps(row), flush=True)
        results.append(row)
        check(ok, f"{name} [{mode}, {row['dtype']}] disagrees with its plain "
                  f"version: max abs err {err}")
    return record


def library_bwd_ms(fn, leaves) -> float:
    """Backward time of one library call: median (forward + backward) minus
    median forward."""
    out = fn()
    g = torch.randn_like(out)

    def fwd_bwd():
        for t in leaves:
            t.grad = None
        fn().backward(g)
    with torch.no_grad():
        f_ms = median_ms(fn)
    return median_ms(fwd_bwd) - f_ms


def kernel_phase(dev) -> list[dict]:
    mask = slice_mask(dev)
    key_bias = torch.where(mask, 0.0, NEG_INF).float()
    blk_valid = mask.reshape(B, NB, ELL).any(-1)
    blk_bias = torch.where(blk_valid, 0.0, NEG_INF).float()
    results = []
    record = recorder(results)

    for dtype in (torch.float32, torch.bfloat16):
        es = torch.tensor([], dtype=dtype).element_size()
        # ---- bta: (B·H, 1, N, D) against its ball's keys
        q = rand((B * H, 1, N, D), dtype, dev, 1)
        k = rand((B * H, N, D), dtype, dev, 2)
        v = rand((B * H, N, D), dtype, dev, 3)
        kw = dict(ball_size=BALL, n_heads=H)
        got = bta.ball_attention_fwd(q, k, v, key_bias, **kw)
        want = bta.ball_attention_fwd_plain(q, k, v, key_bias, **kw)
        torch.cuda.synchronize()
        err, ok = max_err(got, want)
        live_balls = int(mask.reshape(B, N // BALL, BALL).any(-1).sum()) * H
        nbytes = 4 * q.numel() * es + 4 * B * N + 4 * B * (N // BALL) + 4 * q.numel() // D
        b_ms, b_by = bound(nbytes, 4.0 * BALL * BALL * D * live_balls, dtype)
        qs, ks, vs = (t.reshape(B, H, N // BALL, BALL, D).transpose(1, 2)
                      .reshape(B * (N // BALL), H, BALL, D).contiguous() for t in (q, k, v))
        bmask = mask.reshape(B * (N // BALL), 1, 1, BALL)
        record("bta_fwd", "ball", dtype, err, ok,
               median_ms(lambda: bta.ball_attention_fwd(q, k, v, key_bias, **kw)),
               median_ms(lambda: bta.ball_attention_fwd_plain(q, k, v, key_bias, **kw),
                         reps=5),
               b_ms, b_by,
               median_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                                attn_mask=bmask)))

        # ---- flash: N queries against L = N/ℓ pooled keys
        k = rand((B * H, NB, D), dtype, dev, 4)
        v = rand((B * H, NB, D), dtype, dev, 5)
        modes = [("key_bias", {}, mask)]
        if dtype == torch.float32:
            modes += [("causal", {"causal": True}, None),
                      ("block_causal", {"block_causal": True, "ell": ELL}, None)]
        for mode, mkw, q_valid in modes:
            kw = dict(n_heads=H, **mkw)
            got = flash.flash_attention_fwd(q, k, v, blk_bias, q_valid, **kw)
            want = flash.flash_attention_fwd_plain(q, k, v, blk_bias, q_valid, **kw)
            torch.cuda.synchronize()
            rows = None
            if q_valid is not None:      # rows of padding queries are unspecified
                rows = q_valid.repeat_interleave(H, 0)[:, None, :]
            err, ok = max_err(got, want, rows)
            vis = flash.visible_keys(N, NB, causal=mkw.get("causal", False),
                                     block_causal=mkw.get("block_causal", False),
                                     ell=ELL, device=dev)
            pairs = blk_valid[:, None, :].expand(B, N, NB)
            if vis is not None:
                pairs = pairs & vis[None]
            if q_valid is not None:
                pairs = pairs & q_valid[:, :, None]
            flops = 4.0 * D * H * float(pairs.sum())
            nbytes = (2 * q.numel() + 2 * k.numel()) * es + 4 * B * NB + B * N \
                + 4 * q.numel() // D
            b_ms, b_by = bound(nbytes, flops, dtype)
            lib_ms = None
            if mode == "key_bias":
                qs = q.reshape(B, H, N, D)
                ks, vs = k.reshape(B, H, NB, D), v.reshape(B, H, NB, D)
                fmask = blk_valid[:, None, None, :]
                lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=fmask))
            record("flash_fwd", mode, dtype, err, ok,
                   median_ms(lambda: flash.flash_attention_fwd(q, k, v, blk_bias,
                                                               q_valid, **kw)),
                   median_ms(lambda: flash.flash_attention_fwd_plain(
                       q, k, v, blk_bias, q_valid, **kw), reps=5),
                   b_ms, b_by, lib_ms)

        # ---- selection: G = NB groups of g·rep = 8 rows, k* blocks of ℓ keys
        M = GROUP * 1
        qg = rand((B, H, NB, M, D), dtype, dev, 6)
        kb = rand((B, H, NB, ELL, D), dtype, dev, 7)
        vb = rand((B, H, NB, ELL, D), dtype, dev, 8)
        g = torch.Generator(device=dev).manual_seed(9)
        idx = torch.randint(0, NB, (B, H, NB, KSTAR), generator=g, device=dev)
        idx = torch.where(blk_valid[:, None, :, None], idx, -1)   # dead groups
        idx = torch.where(blk_valid[:, None, None, :].expand(B, H, NB, NB)
                          .gather(3, idx.clamp(min=0)), idx, -1).int().contiguous()
        tok_bias = key_bias.reshape(B, NB, ELL).contiguous()
        got = selection.selection_attention_fwd(qg, kb, vb, idx, tok_bias)
        want = selection.selection_attention_fwd_plain(qg, kb, vb, idx, tok_bias)
        torch.cuda.synchronize()
        err, ok = max_err(got, want)
        valid_sel = int((idx >= 0).sum())
        used = torch.zeros(B, H, NB, dtype=torch.bool, device=dev)
        used.scatter_(2, idx.clamp(min=0).reshape(B, H, -1).long(),
                      (idx >= 0).reshape(B, H, -1))
        nbytes = (2 * qg.numel() + 2 * int(used.sum()) * ELL * D) * es \
            + 4 * idx.numel() + 4 * tok_bias.numel() + 4 * qg.numel() // D
        b_ms, b_by = bound(nbytes, 4.0 * M * ELL * D * valid_sel, dtype)
        record("selection_fwd", "groups", dtype, err, ok,
               median_ms(lambda: selection.selection_attention_fwd(qg, kb, vb, idx,
                                                                   tok_bias)),
               median_ms(lambda: selection.selection_attention_fwd_plain(
                   qg, kb, vb, idx, tok_bias), reps=5),
               b_ms, b_by, None)

        # ---- epilogue: R = B·N·H rows of D
        R = B * N * H
        os_ = [rand((R, D), dtype, dev, 10 + i) for i in range(3)]
        gs = [torch.sigmoid(rand((R,), torch.float32, dev, 20 + i)) for i in range(3)]
        m = mask[:, :, None].expand(B, N, H).reshape(R).float()
        got = epilogue.gated_combine_fwd(*os_, *gs, m)
        want = epilogue.gated_combine_fwd_plain(*os_, *gs, m)
        torch.cuda.synchronize()
        err, ok = max_err((got,), (want,))
        b_ms, b_by = bound(4 * R * D * es + 4 * 4 * R, 6.0 * R * D, torch.float32)
        record("epilogue_fwd", "rows", dtype, err, ok,
               median_ms(lambda: epilogue.gated_combine_fwd(*os_, *gs, m)),
               median_ms(lambda: epilogue.gated_combine_fwd_plain(*os_, *gs, m), reps=5),
               b_ms, b_by, None)
    return results


def selection_picks(dev, batch) -> list[torch.Tensor]:
    """Each layer's selections, as the selection kernel gets them (B, Hkv,
    G, k*), in the kernel path's forward of ``shapenet-bsa`` (weights from
    seed 0, as the train phase starts) on ``batch``."""
    cfg = get_config("shapenet-bsa")
    api = model_api(cfg)
    model = api.init(seed=0, device=dev)
    apply, picks = selection.SelectionAttentionFn.apply, []

    def spy(qg, kb, vb, idx, tok_bias):
        picks.append(idx.clone())
        return apply(qg, kb, vb, idx, tok_bias)

    with mock.patch.object(selection.SelectionAttentionFn, "apply", spy), \
            use_backend("kernels"):
        api.forward(model, batch)
    check(len(picks) == cfg.n_layers, f"{len(picks)} selection calls in "
                                      f"{cfg.n_layers} layers")
    return picks


def backward_kernel_phase(dev, batch) -> list[dict]:
    """The five backward kernels against their plain versions at the shapes
    one train step gives them; each gets the forward kernel's (o, lse), an
    upstream gradient dO that is zero on padded query rows, and
    δ = rowsum(dO·O).  ``batch`` is the train phase's first batch: the
    selection rows use the model's own picks on it."""
    picks = selection_picks(dev, batch)
    mask = batch["mask"]
    check(mask.shape == (B, N) and bool((mask.sum(1) == REAL_POINTS).all()),
          "train batch: 8 clouds of 3586 points padded to 3840")
    key_bias = torch.where(mask, 0.0, NEG_INF).float()
    blk_valid = mask.reshape(B, NB, ELL).any(-1)
    blk_bias = torch.where(blk_valid, 0.0, NEG_INF).float()
    row_ok = mask.repeat_interleave(H, 0)[:, None, :, None]      # (B·H, 1, N, 1)
    results = []
    record = recorder(results)

    def upstream(o, seed):                     # o: (B·H, 1, N, D)
        do = rand(o.shape, o.dtype, dev, seed)
        return torch.where(row_ok, do, torch.zeros_like(do))

    for dtype in (torch.float32, torch.bfloat16):
        es = torch.tensor([], dtype=dtype).element_size()
        # ---- bta: (B·H, 1, N, D), one ball of 256 keys per query row
        q = rand((B * H, 1, N, D), dtype, dev, 31)
        k = rand((B * H, N, D), dtype, dev, 32)
        v = rand((B * H, N, D), dtype, dev, 33)
        kw = dict(ball_size=BALL, n_heads=H)
        o, lse = bta.ball_attention_fwd(q, k, v, key_bias, **kw)
        do = upstream(o, 34)
        args = (q, k, v, key_bias, do, lse, row_delta(do, o))
        got = bta.ball_attention_bwd(*args, **kw)
        want = bta.ball_attention_bwd_plain(*args, **kw)
        torch.cuda.synchronize()
        err, ok = max_err(got, want)
        live_balls = int(mask.reshape(B, N // BALL, BALL).any(-1).sum()) * H
        nbytes = 7 * q.numel() * es + 2 * 4 * q.numel() // D + 4 * B * N \
            + 4 * B * (N // BALL)
        b_ms, b_by = bound(nbytes, 10.0 * BALL * BALL * D * live_balls, dtype)
        qs, ks, vs = (t.reshape(B, H, N // BALL, BALL, D).transpose(1, 2)
                      .reshape(B * (N // BALL), H, BALL, D).contiguous()
                      .requires_grad_(True) for t in (q, k, v))
        bmask = mask.reshape(B * (N // BALL), 1, 1, BALL)
        record("bta_bwd", "ball", dtype, err, ok,
               median_ms(lambda: bta.ball_attention_bwd(*args, **kw)),
               median_ms(lambda: bta.ball_attention_bwd_plain(*args, **kw), reps=5),
               b_ms, b_by,
               library_bwd_ms(lambda: F.scaled_dot_product_attention(
                   qs, ks, vs, attn_mask=bmask), (qs, ks, vs)))

        # ---- flash: N queries against L = N/ℓ pooled keys; the q_valid skip
        # in key-bias mode (the path's mode), the causal modes in fp32
        modes = [("key_bias", {}, mask, NB)]
        if dtype == torch.float32:
            modes += [("causal", {"causal": True}, None, N),
                      ("block_causal", {"block_causal": True, "ell": ELL}, None, NB)]
        for mode, mkw, q_valid, L in modes:
            kf = rand((B * H, L, D), dtype, dev, 35)
            vf = rand((B * H, L, D), dtype, dev, 36)
            kb_ = blk_bias if L == NB else key_bias
            kw = dict(n_heads=H, **mkw)
            o, lse = flash.flash_attention_fwd(q, kf, vf, kb_, q_valid, **kw)
            do = upstream(o, 37)
            args = (q, kf, vf, kb_, do, lse, row_delta(do, o))
            dq = flash.flash_attention_dq(*args, **kw)
            dkv = flash.flash_attention_dkv(*args, **kw)
            want = flash.flash_attention_bwd_plain(*args, **kw)
            torch.cuda.synchronize()
            vis = flash.visible_keys(N, L, causal=mkw.get("causal", False),
                                     block_causal=mkw.get("block_causal", False),
                                     ell=ELL, device=dev)
            pairs = (kb_ > NEG_INF / 2)[:, None, :].expand(B, N, L)
            if vis is not None:
                pairs = pairs & vis[None]
            pairs = pairs & mask[:, :, None]
            n_pairs = H * float(pairs.sum())
            side = 2 * 4 * q.numel() // D + 4 * B * L
            p_ms = median_ms(lambda: flash.flash_attention_bwd_plain(*args, **kw), reps=5)
            lib_ms = None
            if mode == "key_bias":
                qs = q.reshape(B, H, N, D).clone().requires_grad_(True)
                ks, vs = (t.reshape(B, H, L, D).clone().requires_grad_(True)
                          for t in (kf, vf))
                fmask = blk_valid[:, None, None, :]
                lib_ms = library_bwd_ms(lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=fmask), (qs, ks, vs))
            err, ok = max_err((dq,), want[:1])
            b_ms, b_by = bound((3 * q.numel() + 2 * kf.numel()) * es + side,
                               6.0 * D * n_pairs, dtype)
            record("flash_dq", mode, dtype, err, ok,
                   median_ms(lambda: flash.flash_attention_dq(*args, **kw)), p_ms,
                   b_ms, b_by, lib_ms)
            err, ok = max_err(dkv, want[1:])
            b_ms, b_by = bound((2 * q.numel() + 4 * kf.numel()) * es + side,
                               8.0 * D * n_pairs, dtype)
            record("flash_dkv", mode, dtype, err, ok,
                   median_ms(lambda: flash.flash_attention_dkv(*args, **kw)), p_ms,
                   b_ms, b_by, lib_ms)

        # ---- selection: G = NB groups of g·rep = 8 rows, k* blocks of ℓ keys.
        # "topk": each layer's picks in the model's first train step (many
        # groups pick the same blocks, so their atomic adds meet), one call
        # per layer, times and bounds the mean over the layers; "random":
        # uniform picks; dead groups pick nothing in both
        M = GROUP * 1
        qg = rand((B, H, NB, M, D), dtype, dev, 38)
        kb = rand((B, H, NB, ELL, D), dtype, dev, 39)
        vb = rand((B, H, NB, ELL, D), dtype, dev, 40)
        g = torch.Generator(device=dev).manual_seed(41)
        idx = torch.randint(0, NB, (B, H, NB, KSTAR), generator=g, device=dev)
        idx = torch.where(blk_valid[:, None, :, None], idx, -1)
        idx = torch.where(blk_valid[:, None, None, :].expand(B, H, NB, NB)
                          .gather(3, idx.clamp(min=0)), idx, -1).int().contiguous()
        tok_bias = key_bias.reshape(B, NB, ELL).contiguous()
        do = rand((B, H, NB, M, D), dtype, dev, 42)
        do = torch.where(mask.reshape(B, 1, NB, M, 1), do, torch.zeros_like(do))
        for mode, idxs in (("topk", picks), ("random", [idx])):
            errs, oks, k_ms, p_ms, b_ms = [], [], [], [], []
            for idx in idxs:
                o, lse = selection.selection_attention_fwd(qg, kb, vb, idx, tok_bias)
                args = (qg, kb, vb, idx, tok_bias, do, lse, row_delta(do, o))
                got = selection.selection_attention_bwd(*args)
                want = selection.selection_attention_bwd_plain(*args)
                torch.cuda.synchronize()
                err, ok = max_err(got, want, tol_table=SEL_BWD_TOL)
                errs.append(err)
                oks.append(ok)
                valid_sel = int((idx >= 0).sum())
                used = torch.zeros(B, H, NB, dtype=torch.bool, device=dev)
                used.scatter_(2, idx.clamp(min=0).reshape(B, H, -1).long(),
                              (idx >= 0).reshape(B, H, -1))
                nbytes = (3 * qg.numel() + 2 * int(used.sum()) * ELL * D) * es \
                    + 4 * 2 * kb.numel() + 4 * idx.numel() + 4 * tok_bias.numel() \
                    + 2 * 4 * qg.numel() // D
                b_ms.append(bound(nbytes, 10.0 * M * ELL * D * valid_sel, dtype))
                k_ms.append(median_ms(lambda: selection.selection_attention_bwd(*args)))
                p_ms.append(median_ms(lambda: selection.selection_attention_bwd_plain(*args),
                                      reps=5))
            record("selection_bwd", mode, dtype,
                   max(errs) if all(math.isfinite(e) for e in errs) else math.nan, all(oks),
                   statistics.fmean(k_ms), statistics.fmean(p_ms),
                   statistics.fmean(t for t, _ in b_ms), b_ms[0][1], None)

        # ---- epilogue: R = B·N·H rows of D
        R = B * N * H
        os_ = [rand((R, D), dtype, dev, 43 + i) for i in range(3)]
        gs = [torch.sigmoid(rand((R,), torch.float32, dev, 46 + i)) for i in range(3)]
        m = mask[:, :, None].expand(B, N, H).reshape(R).float()
        do = rand((R, D), dtype, dev, 49)
        args = (*os_, *gs, m, do)
        got = epilogue.gated_combine_bwd(*args)
        want = epilogue.gated_combine_bwd_plain(*args)
        torch.cuda.synchronize()
        err, ok = max_err(got, want)
        b_ms, b_by = bound(7 * R * D * es + 7 * 4 * R, 10.0 * R * D, torch.float32)
        record("epilogue_bwd", "rows", dtype, err, ok,
               median_ms(lambda: epilogue.gated_combine_bwd(*args)),
               median_ms(lambda: epilogue.gated_combine_bwd_plain(*args), reps=5),
               b_ms, b_by, None)
    return results


def same_segment_pairs(offsets, mask) -> int:
    """(valid row, valid pooled key) pairs of one segment, summed over the
    segments: the varlen kernels' work for one head on this data."""
    blk = mask.reshape(-1, ELL).any(-1)
    return sum(int(mask[a:b].sum()) * int(blk[a // ELL:b // ELL].sum())
               for a, b in zip(offsets[:-1], offsets[1:]))


def varlen_case(dev, offsets, mask, dtype, seed):
    """The compression branch's varlen call on a packed batch: T rows
    against L = T/ℓ pooled keys, the block validity as key bias, the maps
    of ``q_offsets = offsets`` and ``k_offsets = offsets / ℓ``."""
    T = mask.shape[0]
    L = T // ELL
    maps = varlen_maps(offsets, offsets // ELL, T, L, dev)
    blk = torch.from_numpy(mask.reshape(L, ELL).any(-1)).to(dev)
    args = (rand((H, 1, T, D), dtype, dev, seed), rand((H, L, D), dtype, dev, seed + 1),
            rand((H, L, D), dtype, dev, seed + 2),
            torch.where(blk, 0.0, NEG_INF).float()[None], maps.qseg[None],
            maps.kseg[None], maps.q_bounds, maps.k_bounds)
    dense_mask = (maps.qseg[:, None] == maps.kseg[None, :]) & blk[None, :]   # (T, L)
    return args, dense_mask


def varlen_kernel_phase(dev, serve_offsets, serve_mask, train_batch) -> list[dict]:
    """The three varlen kernels against their plain versions: the forward at
    packed serving's shapes, the backward at the packed train batch's, with
    an upstream gradient that is zero on padded query rows."""
    results = []
    record = recorder(results)
    T = CAPACITY
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.tensor([], dtype=dtype).element_size()
        # ---- forward: the first 8 serving clouds packed to 30,720 rows
        args, dense = varlen_case(dev, serve_offsets, serve_mask, dtype, 60)
        q, k, v = args[:3]
        got = varlen.flash_attention_varlen_fwd(*args)
        want = varlen.flash_attention_varlen_fwd_plain(*args[:6])
        torch.cuda.synchronize()
        err, ok = max_err(got, want)
        pairs = H * same_segment_pairs(serve_offsets, serve_mask)
        nbytes = (2 * q.numel() + 2 * k.numel()) * es + 4 * 3 * k.shape[1] + 4 * T \
            + 4 * q.numel() // D
        b_ms, b_by = bound(nbytes, 4.0 * D * pairs, dtype)
        qs, ks, vs = q.reshape(1, H, T, D), k[None], v[None]
        record("varlen_fwd", "packed_serve", dtype, err, ok,
               median_ms(lambda: varlen.flash_attention_varlen_fwd(*args)),
               median_ms(lambda: varlen.flash_attention_varlen_fwd_plain(*args[:6]), reps=5),
               b_ms, b_by,
               median_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                                attn_mask=dense)))
        if dtype == torch.float32:
            qrng, krng = tile_seg_ranges(args[4][0], 128), tile_seg_ranges(args[5][0], 64)
            live = ranges_live_map(qrng, krng)
            print(json.dumps({"varlen_live_tiles": {
                "query_tiles_of_128": live.shape[0], "key_tiles_of_64": live.shape[1],
                "live": int(live.sum()), "total": live.numel(),
                "same_segment_pairs_per_head": pairs // H,
                "dense_pairs_per_head": T * k.shape[1]}}), flush=True)

        # ---- backward: the packed train batch (8 clouds of 2800–3586 points)
        offsets = train_batch["offsets"].numpy()
        mask = train_batch["mask"][0].cpu().numpy()
        args, dense = varlen_case(dev, offsets, mask, dtype, 70)
        q, k, v = args[:3]
        o, lse = varlen.flash_attention_varlen_fwd(*args)
        do = rand(o.shape, dtype, dev, 73)
        row_ok = torch.from_numpy(mask).to(dev)[None, None, :, None]
        do = torch.where(row_ok, do, torch.zeros_like(do))
        rest = (do, lse, row_delta(do, o))
        dq = varlen.flash_attention_varlen_dq(*args, *rest)
        dkv = varlen.flash_attention_varlen_dkv(*args, *rest)
        want = varlen.flash_attention_varlen_bwd_plain(*args[:6], *rest)
        torch.cuda.synchronize()
        pairs = H * same_segment_pairs(offsets, mask)
        side = 2 * 4 * q.numel() // D + 4 * 3 * k.shape[1] + 4 * T
        p_ms = median_ms(lambda: varlen.flash_attention_varlen_bwd_plain(*args[:6], *rest),
                         reps=5)
        qs = q.reshape(1, H, T, D).clone().requires_grad_(True)
        ks, vs = (t[None].clone().requires_grad_(True) for t in (k, v))
        lib_ms = library_bwd_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=dense), (qs, ks, vs))
        err, ok = max_err((dq,), want[:1])
        b_ms, b_by = bound((3 * q.numel() + 2 * k.numel()) * es + side, 6.0 * D * pairs,
                           dtype)
        record("varlen_dq", "packed_train", dtype, err, ok,
               median_ms(lambda: varlen.flash_attention_varlen_dq(*args, *rest)), p_ms,
               b_ms, b_by, lib_ms)
        err, ok = max_err(dkv, want[1:])
        b_ms, b_by = bound((2 * q.numel() + 4 * k.numel()) * es + side, 8.0 * D * pairs,
                           dtype)
        record("varlen_dkv", "packed_train", dtype, err, ok,
               median_ms(lambda: varlen.flash_attention_varlen_dkv(*args, *rest)), p_ms,
               b_ms, b_by, lib_ms)
    return results


def check_launches(launches: dict, path: str, per_kernel: int) -> None:
    """Every kernel of ``path`` launched ``per_kernel`` times, every other
    kernel never."""
    for name, n in launches.items():
        want = per_kernel if name in PATHS[path] else 0
        check(n == want, f"{name} launched {n} times on {path}, expected {want}")


def serve_phase(dev, api, model, clouds, layout: str) -> tuple[dict, list]:
    """Serve ``clouds`` in batches of 8 through ``GeometryEngine`` in
    ``layout`` at the capacity of 8 × 3840 rows."""
    cfg = api.mcfg
    pad_to = N if layout == "padded" else CAPACITY

    def engine(backend=None):
        return GeometryEngine(api, model, batch_slots=8, pad_to=pad_to, layout=layout,
                              backend=backend)

    engine().predict(clouds[:8])                        # warm-up batch
    torch.cuda.synchronize()
    eng = engine()
    reset_counters()                                    # just before the main path
    outs, latency = [], []
    for s in range(0, len(clouds), 8):
        t0 = time.perf_counter()
        outs += eng.predict(clouds[s:s + 8])
        torch.cuda.synchronize()
        latency.append((time.perf_counter() - t0) * 1e3)
    launches = {name: c.n for name, c in COUNTERS.items()}  # just after it
    batches = len(latency)
    stats = {"layout": layout, "pad_to": pad_to, "clouds_served": eng.clouds_served,
             "points_served": eng.points_served,
             "points_per_second": eng.points_per_second, "batch_latency_ms": latency,
             "launches": launches}
    print(json.dumps({"serve": stats}), flush=True)
    check_launches(launches, f"serve_{layout}", cfg.n_layers * batches)
    for out, c in zip(outs, clouds):
        check(out.shape == (c["points"].shape[0], 1), f"output shape {out.shape}")
        check(bool(torch.isfinite(torch.from_numpy(out)).all()), "non-finite output")

    stats["reference_check"] = reference_check(
        engine(), model, cfg, clouds[:8], outs[:8],
        engine(backend="reference").predict(clouds[:8]))
    profile_batch(engine(), clouds[:8])
    return stats, outs


def compare_layouts(clouds, padded, packed) -> dict:
    """The packed and padded engines' outputs for the same clouds: reported,
    not held (a top-k near-tie may pick another block in one of them)."""
    diff = [np.abs(a - b) for a, b in zip(packed, padded)]
    beyond = [int((d > 1e-3 * (1 + np.abs(b))).sum()) for d, b in zip(diff, padded)]
    stats = {"max_abs_diff": float(max(d.max() for d in diff)),
             "points_beyond_1e-3": sum(beyond),
             "clouds_with_points_beyond_1e-3": sum(1 for n in beyond if n),
             "points": sum(c["points"].shape[0] for c in clouds)}
    print(json.dumps({"packed_vs_padded": stats}), flush=True)
    return stats


def train_batches(dev) -> list[dict]:
    """1 + ``TRAIN_STEPS`` batches of 8 ShapeNet-Car train clouds (seed 0
    order), padded to 3840, on the card."""
    t0 = time.perf_counter()
    ds = ShapeNetCarDataset("train")
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
               for _, b in zip(range(TRAIN_STEPS + 1), ds.batches(B, seed=0, pad_to=N))]
    print(f"# made {len(batches) * B} train clouds in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return batches


def packed_train_batches(dev) -> list[dict]:
    """1 + ``TRAIN_STEPS`` packed batches of 8 ShapeNet-Car train clouds of
    2800–3586 points (seed 0 order): each item's feats, target and mask
    (already ball multiples long) packed to ``CAPACITY`` rows; feats,
    target and mask (1, T, ·) on the card, offsets (9,) on the host."""
    t0 = time.perf_counter()
    ds = ShapeNetCarDataset("train", n_points_range=(2800, REAL_POINTS))
    order = np.random.default_rng(0).permutation(len(ds))
    batches = []
    for s in range(0, (TRAIN_STEPS + 1) * B, B):
        items = [ds[int(j)] for j in order[s:s + B]]
        b = {}
        for key in ("feats", "target", "mask"):
            rows, offsets, _ = pack_varlen([it[key] for it in items], BALL, pad_to=CAPACITY,
                                           max_samples=B)
            b[key] = torch.from_numpy(rows[None]).to(dev)
        b["offsets"] = torch.from_numpy(offsets)
        batches.append(b)
    print(f"# made {len(batches) * B} packed train clouds in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return batches


def train_phase(dev, batches, layout: str) -> dict:
    cfg = get_config("shapenet-bsa")
    api = model_api(cfg)
    model = api.init(seed=0, device=dev)
    opt_state = adamw_init(dict(model.named_parameters()))
    step = make_train_step(api, base_lr=1e-3, weight_decay=0.01, total_steps=300,
                           warmup_steps=30)                 # paper App. A settings
    model, opt_state, _ = step(model, opt_state, batches[0])      # warm-up step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()                                    # just before the main path
    metrics, step_ms = [], []
    for batch in batches[1:]:
        t0 = time.perf_counter()
        model, opt_state, out = step(model, opt_state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(out)
    launches = {name: c.n for name, c in COUNTERS.items()}  # just after it
    points = sum(int(b["mask"].sum()) for b in batches[1:])
    stats = {"layout": layout, "steps": TRAIN_STEPS, "batch": B,
             "pad_to": N if layout == "padded" else CAPACITY, "points": points,
             "loss": [float(m["loss"]) for m in metrics],
             "grad_norm": [float(m["grad_norm"]) for m in metrics],
             "lr": [m["lr"] for m in metrics], "step_ms": step_ms,
             "median_step_ms": statistics.median(step_ms),
             "trained_points_per_second": points / (sum(step_ms) / 1e3),
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
             "launches": launches}
    print(json.dumps({"train": stats}), flush=True)
    check(all(math.isfinite(x) for x in stats["loss"] + stats["grad_norm"]),
          "non-finite loss or gradient norm")
    check(all(bool(torch.isfinite(p.grad).all()) for p in model.parameters()
              if p.grad is not None), "non-finite gradient")   # φ_q only feeds top-k
    check_launches(launches, f"train_{layout}", cfg.n_layers * TRAIN_STEPS)
    stats["reference_check"] = train_reference_check(model, cfg, batches[1])
    profile_train_step(step, model, opt_state, batches[1], layout)
    return stats


def train_reference_check(model, cfg, batch) -> dict:
    """Hold each layer's gradients on the kernel path to the ``reference``
    backend's, given the same layer input and the same upstream gradient.

    The kernel path runs forward with a cut between layers, the loss's
    gradient is carried down layer by layer through the kernel path's own
    backward, and at every layer the reference backend differentiates the
    same layer at the same input against the same upstream gradient.  The
    selections agree: both backends score blocks with the same plain code.

    Each gradient tensor of each layer (its input's and every parameter's)
    is held by max|kernel − reference| / max|reference| ≤ ``GRAD_REL_TOL``:
    the loss is a mean over ~29k outputs, so the gradients are far below 1
    and an absolute limit would let a wrong one through."""
    mask, offsets = batch["mask"], batch.get("offsets")
    eps = cfg.norm_eps
    xs, ys = [], []
    h = dense(model.embed, batch["feats"]).detach()
    with use_backend("kernels"):
        for lp in model.layers:
            x = h.detach().requires_grad_(True)
            h = pc_layer(lp, x, mcfg=cfg, mask=mask, offsets=offsets)
            xs.append(x)
            ys.append(h)
    top = h.detach().requires_grad_(True)
    pred = dense(model.head, rmsnorm(model.final_norm, top, eps)).float()
    err = torch.where(mask[..., None], (pred - batch["target"]) ** 2, 0.0)
    gy, = torch.autograd.grad(err.sum() / (mask.sum() * cfg.out_dim), top)
    rows, elements = [], 0
    for i in reversed(range(len(model.layers))):
        lp = model.layers[i]
        names = [n for n, p in lp.named_parameters() if p.requires_grad]
        wrt = [xs[i]] + [p for _, p in lp.named_parameters() if p.requires_grad]
        gk = torch.autograd.grad(ys[i], wrt, gy, allow_unused=True)
        with use_backend("reference"):
            yr = pc_layer(lp, xs[i], mcfg=cfg, mask=mask, offsets=offsets)
        gr = torch.autograd.grad(yr, wrt, gy, allow_unused=True)
        for name, a, b in zip(["input"] + names, gk, gr):
            check((a is None) == (b is None), f"layer {i} {name}: gradient on one side only")
            if a is None:
                continue
            check(bool(torch.isfinite(a).all()), f"layer {i} {name}: non-finite gradient")
            diff, ref = float((a - b).abs().max()), float(b.abs().max())
            rel = diff / ref if ref > 0 else (0.0 if diff == 0 else math.inf)
            rows.append({"layer": i, "name": name, "max_abs_diff": diff,
                         "ref_max_abs": ref, "rel": rel})
            elements += a.numel()
        gy = gk[0]
    worst = max(rows, key=lambda r: r["rel"])
    smallest = min(rows, key=lambda r: r["ref_max_abs"])
    stats = {"layout": "padded" if offsets is None else "packed",
             "rel_tol": GRAD_REL_TOL, "worst": worst, "smallest_ref": smallest,
             "max_abs_diff": max(r["max_abs_diff"] for r in rows),
             "input_grad_ref_max_abs": [r["ref_max_abs"] for r in reversed(rows)
                                        if r["name"] == "input"],
             "tensors_compared": len(rows), "grad_elements_compared": elements,
             "layers": len(model.layers)}
    print(json.dumps({"train_reference_check": stats}), flush=True)
    beyond = [f"layer {r['layer']} {r['name']} ({r['rel']:.2e})" for r in rows
              if not r["rel"] <= GRAD_REL_TOL]
    check(not beyond, f"kernel-path gradients vs reference backend beyond "
                      f"{GRAD_REL_TOL} of their largest value: {', '.join(beyond[:8])}")
    return stats


def profile_train_step(step, model, opt_state, batch, layout: str) -> None:
    """Where one train step spends device time (torch.profiler): kernel time
    on the card, each ported kernel's share, the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(model, opt_state, batch)
        torch.cuda.synchronize()
    print(json.dumps({"train_profile": {"layout": layout, **device_summary(prof)}}),
          flush=True)


def device_summary(prof) -> dict:
    """Device time by kernel: only events that ran on the card (CPU-side ops,
    autograd nodes included, carry their kernels' time too and are left
    out)."""
    from torch.autograd import DeviceType
    kernels = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    ported = {}
    for name, ms, _ in kernels:
        hit = re.search(r"(" + "|".join(KERNELS) + r")_kernel<", name)
        if hit:
            ported[hit.group(1)] = ported.get(hit.group(1), 0.0) + ms
    top = sorted(kernels, key=lambda r: -r[1])[:12]
    return {"device_kernel_ms": sum(ms for _, ms, _ in kernels), "ported_kernels_ms": ported,
            "topk_ms": sum(ms for n, ms, _ in kernels if "topk" in n.lower()),
            "top_device_kernels": [{"name": n[:90], "ms": t, "calls": c} for n, t, c in top]}


def profile_batch(eng, clouds) -> None:
    """Where one served batch spends device time (torch.profiler): the sum
    of kernel time on the card, each ported kernel's share, and the top
    kernels by device time.  The profiled batch's wall time is not a
    latency (the profiler's own start-up is in it)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.predict(clouds)
        torch.cuda.synchronize()
    print(json.dumps({"profile": {"layout": eng.layout, **device_summary(prof)}}),
          flush=True)


def reference_check(eng, model, cfg, clouds, served, free_ref) -> dict:
    """Hold the kernel path to the ``reference`` backend on one served batch.

    The check is per layer: along the kernel path's own trajectory, every
    layer's kernel-path output must match the reference backend's output
    for the same layer input within 1e-3 on every real point.  Top-k
    selection is discontinuous in its scores, so two free-running paths
    whose logits differ by ~1e-7 may pick different blocks for a group
    whose k-th and (k+1)-th scores nearly tie, and the difference then
    grows through the later layers; the free-running comparison (kernel
    engine vs reference engine, end to end) is therefore reported, with
    the layer where the two trajectories first part, not required."""
    batch, _, _ = eng.pack_batch([(c["points"], c["feats"]) for c in clouds])
    mask, offsets = batch["mask"], batch.get("offsets")
    step_worst, step_beyond, parted = 0.0, 0, []
    with torch.no_grad():
        xk = xr = dense(model.embed, batch["feats"])
        for i, lp in enumerate(model.layers):
            with use_backend("kernels"):
                yk = pc_layer(lp, xk, mcfg=cfg, mask=mask, offsets=offsets)
            with use_backend("reference"):
                want = pc_layer(lp, xk, mcfg=cfg, mask=mask, offsets=offsets)  # same input
                yr = pc_layer(lp, xr, mcfg=cfg, mask=mask, offsets=offsets)    # free-running
            d = (yk - want).abs()[mask]
            step_worst = max(step_worst, float(d.max()))
            step_beyond += int((d > 1e-3 * (1 + want.abs()[mask])).any(-1).sum())
            far = (yk - yr).abs()[mask] > 1e-3 * (1 + yr.abs()[mask])
            parted.append(int(far.any(-1).sum()))
            xk, xr = yk, yr
    end_diff = [abs(g - w) for g, w in zip(served, free_ref)]
    stats = {"layout": eng.layout, "per_layer_max_abs_diff": step_worst,
             "per_layer_points_beyond_1e-3": step_beyond, "layers": len(model.layers),
             "points_compared": int(mask.sum()),
             "free_running_points_apart_per_layer": parted,
             "free_running_output_max_abs_diff": float(max(d.max() for d in end_diff)),
             "free_running_output_points_beyond_1e-3": int(sum(
                 (d > 1e-3 * (1 + abs(w))).sum() for d, w in zip(end_diff, free_ref)))}
    print(json.dumps({"reference_check": stats}), flush=True)
    check(step_beyond == 0, f"kernel path vs reference backend: {step_beyond} "
                            f"points beyond 1e-3 in some layer (max {step_worst})")
    return stats


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script runs on the GPU only",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = smi_line()
    print(f"# card: {smi}", flush=True)
    print(f"# torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    info = _build.last_build
    verb = "built" if info["built"] else "found built"
    print(f"# kernels {verb} in {info['seconds']:.1f} s -> {info['path']}", flush=True)
    for line in info["log"].splitlines():
        if re.search(r"registers|spill|error", line):
            print("# ptxas " + line.strip(), flush=True)

    batches = train_batches(dev)
    packed_batches = packed_train_batches(dev)
    t0 = time.perf_counter()
    clouds = make_clouds(16, (2800, REAL_POINTS), seed=2024)
    print(f"# made 16 clouds in {time.perf_counter() - t0:.1f} s", flush=True)
    _, serve_offsets, serve_mask = pack_varlen(
        [np.zeros((c["points"].shape[0], 1), np.float32) for c in clouds[:8]], BALL,
        pad_to=CAPACITY, max_samples=B)
    rows = (kernel_phase(dev) + backward_kernel_phase(dev, batches[0])
            + varlen_kernel_phase(dev, serve_offsets, serve_mask, packed_batches[0]))

    api = model_api(get_config("shapenet-bsa"))
    model = api.init(seed=0, device=dev)
    paths = {}
    paths["serve_padded"], padded_outs = serve_phase(dev, api, model, clouds, "padded")
    paths["serve_packed"], packed_outs = serve_phase(dev, api, model, clouds, "packed")
    compare_layouts(clouds, padded_outs, packed_outs)
    del model
    paths["train_padded"] = train_phase(dev, batches, "padded")
    paths["train_packed"] = train_phase(dev, packed_batches, "packed")

    summary = []
    for name, (src, replaces) in KERNELS.items():
        # the main path's mode (fp32, key-bias flash); launches of this slice's
        # train path for the kernels it runs (of the padded one for the others),
        # and of every path
        row = next(r for r in rows if r["name"] == name and r["dtype"] == "float32")
        by_path = {p: st["launches"][name] for p, st in paths.items()}
        main_path = "train_packed" if name in PATHS["train_packed"] else "train_padded"
        summary.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": by_path[main_path],
                        "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                        "launches_by_path": by_path})
    print(json.dumps({"kernels": summary}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
