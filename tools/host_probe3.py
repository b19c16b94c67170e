"""Call time (CUDA events around one call, synchronised each time, as
chip_smoke.median_ms) of the epilogue's layer call and its pieces at
shapenet's and the prefill's shapes (python3 tools/host_probe3.py)."""
import sys
import json
import statistics
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
import torch  # noqa: E402

from repro_torch.kernels import _build, epilogue, ops  # noqa: E402


def median_ms(fn, warmup=5, reps=60):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts)


def host_us(fn, reps=60):
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e6)
    return statistics.median(ts)


def direct(outs, gates, mask):
    """ops.gated_combine without the autograd op (no graph is needed)."""
    B, N, H, D = outs[0].shape
    R = B * N * H
    return epilogue.gated_combine_fwd(*(o.reshape(R, D) for o in outs),
                                      *(g.view(g.shape[0] * g.shape[1], H) for g in gates),
                                      None if mask is None else mask.reshape(B * N)
                                      ).view(B, N, H, D)


dev = torch.device("cuda")
_build.load()
for name, shape, masked in (("tiny", (1, 128, 8, 32), True), ("shapenet", (8, 3840, 8, 32), True),
                            ("prefill", (1, 32768, 32, 64), False)):
    B, N, H, D = shape
    R = B * N * H
    dt = torch.float32 if name != "prefill" else torch.bfloat16
    outs = [torch.randn(shape, device=dev).to(dt) for _ in range(3)]
    gates = [torch.rand(H, device=dev)[None, None, :, None] for _ in range(3)]
    mask = torch.ones(B, N, dtype=torch.bool, device=dev) if masked else None
    os_ = [o.view(R, D) for o in outs]
    gs = [g.view(1, H) for g in gates]
    m = None if mask is None else mask.view(B * N)
    row = {"shape": name}
    for mode in ("grad", "inference"):
        ctx = torch.inference_mode() if mode == "inference" else torch.enable_grad()
        with ctx:
            for tag, fn in (("wrapper", lambda: epilogue.gated_combine_fwd(*os_, *gs, m)),
                            ("apply", lambda: epilogue.GatedCombineFn.apply(*os_, *gs, m)),
                            ("ops", lambda: ops.gated_combine(outs, gates, mask)),
                            ("direct", lambda: direct(outs, gates, mask))):
                row[f"{mode}_{tag}_ms"] = median_ms(fn)
                row[f"{mode}_{tag}_host_us"] = host_us(fn)
    print(json.dumps(row), flush=True)
