"""Host time of the epilogue and pair-gather calls, piece by piece.

    python3 tools/host_probe.py      (on the card; prints JSON lines)

Each piece is timed over many calls with perf_counter and no synchronise,
at a small shape, so the card never holds the host back: the numbers are
the host's work per call.  A no-op C function with the same argument list
separates ctypes' own cost from the CUDA launch.
"""
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
import torch  # noqa: E402

from repro_torch.kernels import _build, epilogue, ops, paged  # noqa: E402

N_CALLS = 3000


def per_call_us(fn, n=N_CALLS):
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


(ROOT / "build").mkdir(exist_ok=True)
src = ROOT / "build" / "noop.c"
src.write_text("int noop17(void* a, void* b, void* c, void* d, void* e, void* f, void* g,"
               " void* h, int i, int j, int k, int l, int m, int n, int o, int p, void* q)"
               " { return 0; }\n"
               "int noop10(void* a, void* b, void* c, void* d, void* e, int i, int j, int k,"
               " int l, void* q) { return 0; }\n")
lib_path = ROOT / "build" / "libnoop.so"
subprocess.run(["gcc", "-O2", "-shared", "-fPIC", "-o", str(lib_path), str(src)], check=True)
noop = ctypes.CDLL(str(lib_path))
noop.noop17.argtypes = _build.SIGNATURES["epilogue_fwd"]
noop.noop17.restype = ctypes.c_int
noop.noop10.argtypes = _build.SIGNATURES["paged_gather_pair"]
noop.noop10.restype = ctypes.c_int
raw17 = ctypes.CDLL(str(lib_path)).noop17            # no argtypes: ints pass as C ints
raw17.restype = ctypes.c_int

dev = torch.device("cuda")
_build.load()
out = {}
# ---- epilogue at a small shape: 1,024 rows of 32 fp32, H 8, the mask
B, N, H, D = 1, 128, 8, 32
R = B * N * H
outs = [torch.randn(B, N, H, D, device=dev) for _ in range(3)]
gates = [torch.rand(H, device=dev)[None, None, :, None] for _ in range(3)]
mask = torch.ones(B, N, dtype=torch.bool, device=dev)
os_ = [o.view(R, D) for o in outs]
gs = [g.view(1, H) for g in gates]
m = mask.view(B * N)
res = torch.empty_like(os_[0])
stream = torch._C._cuda_getCurrentRawStream(0)
args = (*(t.data_ptr() for t in (*os_, *gs, m, res)), R, D, H, 0, 0, 0, 0, 8, stream)
fn = _build._entry["epilogue_fwd"]
pre = [t(v) for t, v in zip(_build.SIGNATURES["epilogue_fwd"], args)]   # converted once
out["epilogue"] = {
    "fwd_takes": per_call_us(lambda: epilogue._fwd_takes(*os_, *gs, m)),
    "empty_like": per_call_us(lambda: torch.empty_like(os_[0])),
    "plan": per_call_us(lambda: epilogue.epilogue_plan(D, torch.float32, True)),
    "data_ptr_x8": per_call_us(lambda: [t.data_ptr() for t in (*os_, *gs, m, res)]),
    "raw_stream": per_call_us(lambda: torch._C._cuda_getCurrentRawStream(0)),
    "ctypes_noop_argtypes": per_call_us(lambda: noop.noop17(*args)),
    "ctypes_noop_raw": per_call_us(lambda: raw17(*pre)),
    "ctypes_launch": per_call_us(lambda: fn(*args)),
    "build_launch": per_call_us(lambda: _build.launch("epilogue_fwd", *args)),
    "wrapper": per_call_us(lambda: epilogue.gated_combine_fwd(*os_, *gs, m)),
    "fn_apply_no_grad": per_call_us(
        lambda: epilogue.GatedCombineFn.apply(*os_, *gs, m)),
    "ops_inference": None,
    "ops_grad": per_call_us(lambda: ops.gated_combine(outs, gates, mask)),
}
with torch.inference_mode():
    out["epilogue"]["ops_inference"] = per_call_us(lambda: ops.gated_combine(outs, gates, mask))
print(json.dumps(out["epilogue"]), flush=True)

# ---- pair gather: 512 window rows of 4 x 64 fp32
pool = [torch.randn(4096, 4, 64, device=dev) for _ in range(2)]
rows = torch.randint(0, 4096, (8, 64), device=dev, dtype=torch.int32)
both = torch.empty((2, 8, 64, 4, 64), device=dev)
M, rb = rows.numel(), 4 * 64 * 4
gargs = (pool[0].data_ptr(), pool[1].data_ptr(), rows.data_ptr(), both.data_ptr(),
         both.data_ptr() + M * rb, 4096, M, rb, 0, stream)
gfn = _build._entry["paged_gather_pair"]
flat = rows.reshape(-1)
out["gather"] = {
    "kernel_takes": per_call_us(lambda: paged._kernel_takes(pool[0], rows)),
    "empty": per_call_us(lambda: torch.empty((2, 8, 64, 4, 64), device=dev)),
    "ctypes_noop_argtypes": per_call_us(lambda: noop.noop10(*gargs)),
    "ctypes_launch": per_call_us(lambda: gfn(*gargs)),
    "wrapper": per_call_us(lambda: paged.paged_gather_pair(*pool, rows)),
    "single_wrapper": per_call_us(lambda: paged.paged_gather(pool[0], rows)),
    "index_select": per_call_us(lambda: torch.index_select(pool[0], 0, flat)),
    "unbind_views": per_call_us(lambda: (both[0], both[1])),
}
print(json.dumps(out["gather"]), flush=True)
