"""Host time of candidate trims of the pair-gather and epilogue wrappers
(python3 tools/host_probe2.py on the card; JSON lines)."""
import sys
import time
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
import torch  # noqa: E402

from repro_torch.kernels import _build, epilogue, paged  # noqa: E402


def per_call_us(fn, n=5000):
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return min(best)


dev = torch.device("cuda")
_build.load()
pool = [torch.randn(4096, 4, 64, device=dev) for _ in range(2)]
rows = torch.randint(0, 4096, (8, 64), device=dev, dtype=torch.int32)
shape = (2, *rows.shape, 4, 64)
both = torch.empty(shape, device=dev)
r = {
    "empty_device_obj": per_call_us(lambda: torch.empty(shape, dtype=pool[0].dtype,
                                                         device=pool[0].device)),
    "new_empty": per_call_us(lambda: pool[0].new_empty(shape)),
    "index_views": per_call_us(lambda: (both[0], both[1])),
    "unbind": per_call_us(lambda: both.unbind(0)),
    "select": per_call_us(lambda: (both.select(0, 0), both.select(0, 1))),
    "pair_wrapper": per_call_us(lambda: paged.paged_gather_pair(*pool, rows)),
    "single_wrapper": per_call_us(lambda: paged.paged_gather(pool[0], rows)),
    "index_select": per_call_us(lambda: torch.index_select(pool[0], 0, rows.reshape(-1))),
}
print(json.dumps(r), flush=True)
B, N, H, D = 1, 128, 8, 32
R = B * N * H
os_ = [torch.randn(R, D, device=dev) for _ in range(3)]
gs = [torch.rand(1, H, device=dev) for _ in range(3)]
m = torch.ones(B * N, dtype=torch.bool, device=dev)
e = {
    "fwd_takes": per_call_us(lambda: epilogue._fwd_takes(*os_, *gs, m)),
    "empty_like": per_call_us(lambda: torch.empty_like(os_[0])),
    "new_empty": per_call_us(lambda: os_[0].new_empty(os_[0].shape)),
    "shape_attr": per_call_us(lambda: os_[0].shape),
    "dtype_attr": per_call_us(lambda: os_[0].dtype),
    "is_cuda": per_call_us(lambda: os_[0].is_cuda),
    "get_device": per_call_us(lambda: os_[0].get_device()),
    "is_contiguous": per_call_us(lambda: os_[0].is_contiguous()),
    "stride0": per_call_us(lambda: gs[0].stride(0)),
    "wrapper": per_call_us(lambda: epilogue.gated_combine_fwd(*os_, *gs, m)),
}
print(json.dumps(e), flush=True)
