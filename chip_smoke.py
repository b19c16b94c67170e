#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA card (written for an H100) and the CUDA toolkit; it
imports nothing of JAX and nothing of the JAX package.  Three phases:

1. set-up: the card's name and power limit, the kernels' build (one nvcc
   per CUDA source, all at once), TF32 off for every fp32 product;
2. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the shapes that serving ``shapenet-bsa`` gives it (8 slots of 3840
   points, sample 0 padded from a 3586-point cloud, 8 heads of 32), in fp32
   and bf16 and, for flash, in its causal modes too; with the median time
   of kernel, plain version and (where one exists) the library call, and
   the least time the H100 could take for the same work;
3. serve: ``shapenet-bsa`` at full width (18 layers, random weights from a
   seed) serves 16 synthetic clouds of 2800–3586 points through
   ``GeometryEngine(layout="padded", batch_slots=8, pad_to=3840)`` after a
   warm-up batch; every kernel must have launched 18 times per batch, the
   outputs must be finite with one row per point, and on one batch every
   layer of the kernel path must match the ``reference`` backend given the
   same layer input (see ``reference_check``).

Any failed check exits non-zero before the result lines.  On success the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.backend import use_backend  # noqa: E402
from repro_torch.data.shapenet import N_POINTS, make_clouds  # noqa: E402
from repro_torch.kernels import _build, bta, epilogue, flash, selection  # noqa: E402
from repro_torch.kernels.common import COUNTERS, reset_counters  # noqa: E402
from repro_torch.layers.nn import dense  # noqa: E402
from repro_torch.models.api import model_api  # noqa: E402
from repro_torch.models.pointcloud import pc_layer  # noqa: E402
from repro_torch.numerics import NEG_INF  # noqa: E402
from repro_torch.serving.engine import GeometryEngine  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s, fp32
# outside the tensor cores, bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 4e-2}

# the slice's shapes: shapenet-bsa served 8 clouds at a time, padded to 3840
B, N, H, D = 8, 3840, 8, 32
BALL, ELL, KSTAR, GROUP = 256, 8, 4, 8
NB = N // ELL
REAL_POINTS = N_POINTS                  # sample 0: a full ShapeNet-Car cloud


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


def max_err(got, want, rows=None) -> tuple[float, bool]:
    """(max |got − want| over finite comparisons, within tolerance?)"""
    errs, ok = [], True
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        if rows is not None:
            g, w = g[rows], w[rows]
        if not torch.isfinite(g).all():
            return float("nan"), False
        d = (g - w).abs()
        tol = TOL[got[0].dtype] * (1 + w.abs())
        ok = ok and bool((d <= tol).all())
        errs.append(float(d.max()))
    return max(errs), ok


def slice_mask(dev) -> torch.Tensor:
    """(B, N) bool: sample 0 is a 3586-point cloud padded to 3840; the others
    are 2800–3586-point clouds."""
    g = torch.Generator().manual_seed(11)
    sizes = torch.randint(2800, REAL_POINTS + 1, (B,), generator=g)
    sizes[0] = REAL_POINTS
    return (torch.arange(N)[None, :] < sizes[:, None]).to(dev)


def rand(shape, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def kernel_phase(dev) -> list[dict]:
    mask = slice_mask(dev)
    key_bias = torch.where(mask, 0.0, NEG_INF).float()
    blk_valid = mask.reshape(B, NB, ELL).any(-1)
    blk_bias = torch.where(blk_valid, 0.0, NEG_INF).float()
    results = []

    def record(name, mode, dtype, err, ok, k_ms, p_ms, b_ms, b_by, lib_ms):
        row = {"name": name, "mode": mode, "dtype": str(dtype).replace("torch.", ""),
               "max_abs_err": err, "within_tol": ok, "kernel_ms": k_ms,
               "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": lib_ms}
        print(json.dumps(row), flush=True)
        results.append(row)
        check(ok, f"{name} [{mode}, {row['dtype']}] disagrees with its plain "
                  f"version: max abs err {err}")

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


def serve_phase(dev) -> tuple[dict, dict]:
    cfg = get_config("shapenet-bsa")
    api = model_api(cfg)
    model = api.init(seed=0, device=dev)
    t0 = time.perf_counter()
    clouds = make_clouds(16, (2800, REAL_POINTS), seed=2024)
    print(f"# made 16 clouds in {time.perf_counter() - t0:.1f} s", flush=True)

    def engine(backend=None):
        return GeometryEngine(api, model, batch_slots=8, pad_to=N, layout="padded",
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
    stats = {"clouds_served": eng.clouds_served, "points_served": eng.points_served,
             "points_per_second": eng.points_per_second, "batch_latency_ms": latency,
             "launches": launches}
    print(json.dumps({"serve": stats}), flush=True)
    for name, n in launches.items():
        check(n == cfg.n_layers * batches,
              f"{name} launched {n} times, expected {cfg.n_layers} x {batches}")
    for out, c in zip(outs, clouds):
        check(out.shape == (c["points"].shape[0], 1), f"output shape {out.shape}")
        check(bool(torch.isfinite(torch.from_numpy(out)).all()), "non-finite output")

    ref_stats = reference_check(api, model, cfg, clouds[:8], outs[:8],
                                engine(backend="reference").predict(clouds[:8]))
    profile_batch(engine(), clouds[:8])
    return stats, ref_stats


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
    kernels = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_time_total > 0 and not e.key.startswith(("aten::", "cuda"))]
    ported = {}
    for name, ms, _ in kernels:
        hit = re.search(r"(bta|flash|selection|epilogue)_fwd_kernel<", name)
        if hit:
            key = hit.group(1) + "_fwd"
            ported[key] = ported.get(key, 0.0) + ms
    top = sorted(kernels, key=lambda r: -r[1])[:10]
    print(json.dumps({"profile": {
        "device_kernel_ms": sum(ms for _, ms, _ in kernels), "ported_kernels_ms": ported,
        "top_device_kernels": [{"name": n[:90], "ms": t, "calls": c} for n, t, c in top]}}),
        flush=True)


def reference_check(api, model, cfg, clouds, served, free_ref) -> dict:
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
    eng = GeometryEngine(api, model, batch_slots=8, pad_to=N, layout="padded")
    batch, _, _ = eng.pack_batch([(c["points"], c["feats"]) for c in clouds])
    mask = batch["mask"]
    step_worst, step_beyond, parted = 0.0, 0, []
    with torch.no_grad():
        xk = xr = dense(model.embed, batch["feats"])
        for i, lp in enumerate(model.layers):
            with use_backend("kernels"):
                yk = pc_layer(lp, xk, mcfg=cfg, mask=mask)
            with use_backend("reference"):
                want = pc_layer(lp, xk, mcfg=cfg, mask=mask)      # same input
                yr = pc_layer(lp, xr, mcfg=cfg, mask=mask)        # free-running
            d = (yk - want).abs()[mask]
            step_worst = max(step_worst, float(d.max()))
            step_beyond += int((d > 1e-3 * (1 + want.abs()[mask])).any(-1).sum())
            far = (yk - yr).abs()[mask] > 1e-3 * (1 + yr.abs()[mask])
            parted.append(int(far.any(-1).sum()))
            xk, xr = yk, yr
    end_diff = [abs(g - w) for g, w in zip(served, free_ref)]
    stats = {"per_layer_max_abs_diff": step_worst, "per_layer_points_beyond_1e-3":
             step_beyond, "layers": len(model.layers),
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

    rows = kernel_phase(dev)
    serve, _ = serve_phase(dev)

    sources = {"bta_fwd": ("src/repro_torch/csrc/bta_fwd.cu", "src/repro/kernels/bta.py:57"),
               "flash_fwd": ("src/repro_torch/csrc/flash_fwd.cu",
                             "src/repro/kernels/flash.py:87"),
               "selection_fwd": ("src/repro_torch/csrc/selection_fwd.cu",
                                 "src/repro/kernels/selection.py:53"),
               "epilogue_fwd": ("src/repro_torch/csrc/epilogue_fwd.cu",
                                "src/repro/kernels/epilogue.py:36")}
    summary = []
    for name, (src, replaces) in sources.items():
        # the main path's mode: fp32, key-bias flash
        row = next(r for r in rows if r["name"] == name and r["dtype"] == "float32")
        summary.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": serve["launches"][name],
                        "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
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
