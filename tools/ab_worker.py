"""Parent-against-change measurements of the port's kernels on one card.

    python3 tools/ab_worker.py TREE TAG OUT.json [--hashes] [--sections LIST]

TREE is a checkout (its src/ is imported first, its own kernels built into
TREE/build/kernels).  ``--sections`` (a comma list, default every one):

- ``ball``: ``bta_fwd`` / ``bta_bwd`` at seamless's encoder balls (16
  heads of 64, 4,096 frames, balls of 256, bf16), llava's heads (56 / 8 of
  128, bf16; a tree whose kernels refuse D 128 records the refusal),
  seamless's heads in balls of 32 (bf16) and shapenet's padded train batch
  (8 × 8 heads of 32, 3,840 rows, fp32): a call's time, its device time
  from the profiler and the outputs' digest;
- ``seamless``: seamless-m4t-medium at full width and depth, one warm-up
  and two timed train steps on 4,096 frames, then a profiled step
  (``device_summary``: the device time by kernel kind, ``by_category_ms``);
- ``epilogue``: the layer's epilogue call (``ops.gated_combine``) and the
  bare kernel call at the PERF.md shapes;
- ``gather``: the decode step's gathers as the tree makes them (the pair
  call, or two single-pool calls before it), ``index_select`` beside them;
- ``decode``: 100 steps of tinyllama's paged decode at 22 layers.

``--hashes`` adds the tree's own output_hashes and this repository's
path_hashes run on the tree's package.
"""
import importlib.util
import json
import sys
import time
from pathlib import Path

TREE = Path(sys.argv[1]).resolve()
TAG, OUT = sys.argv[2], sys.argv[3]
sys.path.insert(0, str(TREE / "src"))
import hashlib  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch  # noqa: E402,F401
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import nsa_causal  # noqa: E402
from repro_torch.kernels import _build, epilogue, ops, paged  # noqa: E402
from repro_torch.kernels.common import COUNTERS, reset_counters  # noqa: E402

assert Path(repro_torch.__file__).resolve().is_relative_to(TREE), repro_torch.__file__
HERE = Path(__file__).resolve().parents[1]


def load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = load(HERE / "chip_smoke.py", "cs_change")          # timing helpers, path_hashes
dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
_build.load()
if _build.last_build["built"]:
    Path(OUT + ".ptxas.log").write_text(_build.last_build["log"])
new_api = "paged_gather_pair" in _build.SIGNATURES
res = {"tag": TAG, "tree": str(TREE), "new_api": new_api, "card": cs.smi_line(),
       "epilogue": [], "gather": [], "ball": []}
ALL = ("ball", "seamless", "epilogue", "gather", "decode")
SECTIONS = (sys.argv[sys.argv.index("--sections") + 1].split(",") if "--sections" in sys.argv
            else ALL)
assert set(SECTIONS) <= set(ALL), SECTIONS


def digest(*ts):
    m = hashlib.sha256()
    for t in ts:
        m.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return m.hexdigest()[:16]


def ball_rows():
    """bta_fwd / bta_bwd at the shapes of the ball section, in the tree's
    own path for each."""
    from repro_torch.kernels import bta
    from repro_torch.kernels.common import row_delta
    shapenet = cs.slice_mask(dev)
    cases = {"seamless": (16, 1, 64, 256, 4096, torch.bfloat16, None),
             "llava_d128": (8, 7, 128, 256, 4096, torch.bfloat16, None),
             "rows_ball32": (16, 1, 64, 32, 4096, torch.bfloat16, None),
             "shapenet": (cs.B * cs.H, 1, cs.D, cs.BALL, cs.N, torch.float32, shapenet)}
    for name, (bh, rep, d, m, n, dtype, mask) in cases.items():
        nh = bh if mask is None else cs.H
        valid = torch.ones(1, n, dtype=torch.bool, device=dev) if mask is None else mask
        kb = torch.where(valid, 0.0, -1e30).float()
        q = cs.rand((bh, rep, n, d), dtype, dev, 200)
        k, v = (cs.rand((bh, n, d), dtype, dev, s) for s in (201, 202))
        kw = dict(ball_size=m, n_heads=nh)
        row = {"case": name, "dtype": str(dtype)[6:]}
        try:
            o, lse = bta.ball_attention_fwd(q, k, v, kb, **kw)
        except (ValueError, RuntimeError) as e:
            row["refused"] = str(e)[:160]
            res["ball"].append(row)
            print(json.dumps(row), flush=True)
            continue
        do = cs.rand(o.shape, dtype, dev, 203)
        args = (q, k, v, kb, do, lse, row_delta(do, o))
        fwd = lambda: bta.ball_attention_fwd(q, k, v, kb, **kw)  # noqa: E731
        bwd = lambda: bta.ball_attention_bwd(*args, **kw)  # noqa: E731
        row.update(fwd_ms=cs.median_ms(fwd, reps=50), fwd_device_ms=cs.device_ms(
                       fwd, "bta_fwd")[0], fwd_digest=digest(o, lse),
                   bwd_ms=cs.median_ms(bwd, reps=50), bwd_device_ms=cs.device_ms(
                       bwd, "bta_bwd")[0], bwd_digest=digest(*bwd()))
        res["ball"].append(row)
        print(json.dumps(row), flush=True)
        del q, k, v, o, lse, do, args
        torch.cuda.empty_cache()


def seamless_step():
    """seamless-m4t-medium's train step at full width and depth: 1 warm-up,
    2 timed steps on 4,096 frames, then a profiled one."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init
    api, model = cs.family_init(dev, get_config(cs.SEAMLESS))
    cfg = api.mcfg
    batches = [api.make_batch(np.random.default_rng(s), 1, cs.FAMILY_N, device=dev)
               for s in range(3)]
    opt = adamw_init(dict(model.named_parameters()),
                     state_dtype=getattr(torch, cfg.opt_state_dtype))
    step = make_train_step(api, base_lr=1e-3, weight_decay=0.01, total_steps=300,
                           warmup_steps=30)
    model, opt, _ = step(model, opt, batches[0])
    torch.cuda.synchronize()
    ms, losses = [], []
    for batch in batches[1:]:
        t0 = time.perf_counter()
        model, opt, m = step(model, opt, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(model, opt, batches[1])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    summary = cs.device_summary(prof)
    res["seamless"] = {"step_ms": ms, "loss": losses, "profiled_wall_ms": wall,
                       "device_busy_share": summary["device_kernel_ms"] / wall, **summary}
    print(json.dumps({"seamless": res["seamless"]}), flush=True)
    del model, opt
    torch.cuda.empty_cache()


if "ball" in SECTIONS:
    ball_rows()
if "seamless" in SECTIONS:
    seamless_step()

SHAPES = {"shapenet": ((8, 3840, 8, 32), torch.float32, True),
          "shapenet_bf16": ((8, 3840, 8, 32), torch.bfloat16, True),
          "lm_prefill": ((1, 32768, 32, 64), torch.bfloat16, False),
          "d128_bf16": ((1, 4096, 24, 128), torch.bfloat16, False),
          "d128_fp32": ((1, 4096, 24, 128), torch.float32, False),
          "rep1": ((1, 4096, 32, 64), torch.bfloat16, False),
          "rep48": ((1, 4096, 48, 128), torch.bfloat16, False)}
for name, (shape, dtype, masked) in SHAPES.items() if "epilogue" in SECTIONS else ():
    Bx, Nx, Hx, Dx = shape
    R = Bx * Nx * Hx
    outs = [cs.rand(shape, dtype, dev, 10 + i) for i in range(3)]
    leaves = [torch.sigmoid(cs.rand((Hx,), torch.float32, dev, 13 + i)) for i in range(3)]
    gates = [g[None, None, :, None] for g in leaves]
    mask = cs.slice_mask(dev) if masked else None
    layer = lambda: ops.gated_combine(outs, gates, mask)  # noqa: E731
    if new_api:
        m = None if mask is None else mask.reshape(-1)
        kargs = ([o.view(R, Dx) for o in outs] + [g[None] for g in leaves] + [m])
    else:
        m = (torch.ones(R, device=dev) if mask is None
             else mask[:, :, None].expand(Bx, Nx, Hx).reshape(R).float())
        kargs = ([o.view(R, Dx) for o in outs]
                 + [g.expand(Bx * Nx, Hx).reshape(R).contiguous() for g in leaves] + [m])
    kern = lambda: epilogue.gated_combine_fwd(*kargs)  # noqa: E731
    with torch.inference_mode():
        out = layer()
        ks = cs.device_trace(layer, 20)
        row = {"shape": name, "dtype": str(dtype)[6:], "R": R, "D": Dx,
               "layer_ms": cs.median_ms(layer, reps=50),
               "layer_device_ms": cs.per_call_ms(ks, 20),
               "layer_kernels": sorted(e.key[:60] for e in ks),
               "kernel_ms": cs.median_ms(kern, reps=50),
               "kernel_device_ms": cs.device_ms(kern, "epilogue_fwd")[0]}
        row["digest"] = hashlib.sha256(out.contiguous().view(torch.uint8).cpu().numpy()
                                       .tobytes()).hexdigest()[:16]
    res["epilogue"].append(row)
    print(json.dumps(row), flush=True)
    del outs, kargs, out
    torch.cuda.empty_cache()

for dtype in (torch.float32, torch.bfloat16) if "gather" in SECTIONS else ():
    R = cs.decode_rows(dev)[-1]
    n_pages = cs.MAX_LEN // cs.PAGE
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.permutation(cs.SLOTS * n_pages).reshape(cs.SLOTS, n_pages)).to(dev)
    lengths = torch.from_numpy(rng.integers(1100, 1601, cs.SLOTS)).to(dev)
    st = nsa_causal.paged_step(table, lengths, cfg=get_config(cs.LM).bsa, page=cs.PAGE)
    k_pool, v_pool = (cs.rand((R, cs.LM_HKV, cs.LM_D), dtype, dev, s) for s in (1, 2))
    for mode, rows in (("window_i32", st.win_rows), ("window_i64", st.win_rows.long()),
                       ("crow_i64", st.crow), ("cmp_rows_i32", st.cmp_rows),
                       ("brows_i32", st.brows)):
        if new_api:
            call = lambda: paged.paged_gather_pair(k_pool, v_pool, rows)  # noqa: E731
        else:
            call = lambda: (paged.paged_gather(k_pool, rows),  # noqa: E731
                            paged.paged_gather(v_pool, rows))
        flat = rows.reshape(-1)
        one = lambda: torch.index_select(k_pool, 0, flat)  # noqa: E731
        two = lambda: (torch.index_select(k_pool, 0, flat),  # noqa: E731
                       torch.index_select(v_pool, 0, flat))
        ks = cs.device_trace(call, 20)
        row = {"rows": mode, "dtype": str(dtype)[6:], "n": rows.numel(),
               "pair_ms": cs.median_ms(call, reps=100),
               "pair_device_ms": cs.per_call_ms(ks, 20),
               "pair_kernels": sorted(e.key[:50] for e in ks),
               "index_select_ms": cs.median_ms(one, reps=100),
               "index_select_pair_ms": cs.median_ms(two, reps=100)}
        res["gather"].append(row)
        print(json.dumps(row), flush=True)



def decode_steps():
    """tinyllama's paged decode at 22 layers: the first 100 steps of the
    dense LMs' schedule through api.paged_decode_step."""
    from repro_torch.models.api import model_api
    api = model_api(get_config(cs.LM))
    model = api.init(seed=0, device=dev)
    tables, lengths, num_blocks, n_pad = cs.decode_schedule(dev)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, api.mcfg.vocab_size, (2, n_pad), dtype=np.int32)).to(dev)
    slot = torch.arange(2, device=dev)
    caches = api.paged_cache_init(2, num_blocks, cs.PAGE, api.mcfg.cdtype(), device=dev)
    with torch.inference_mode():
        for t in range(10):                                  # warm-up
            api.paged_decode_step(model, tokens[slot, lengths[t]], caches, tables[t],
                                  lengths[t], cs.PAGE)
        caches = api.paged_cache_init(2, num_blocks, cs.PAGE, api.mcfg.cdtype(), device=dev)
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        logits = []
        for t in range(100):
            lg, caches = api.paged_decode_step(model, tokens[slot, lengths[t]], caches,
                                               tables[t], lengths[t], cs.PAGE)
            logits.append(lg)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    res["decode"] = {"ms_per_step": sec * 10, "launches": {k: c.n for k, c in COUNTERS.items()
                                                           if c.n},
                     "logits_digest": digest(*logits)}
    print(json.dumps(res["decode"]), flush=True)
    del model, caches
    torch.cuda.empty_cache()


if "decode" in SECTIONS:
    decode_steps()

if "--hashes" in sys.argv:
    own = load(TREE / "chip_smoke.py", "cs_own")
    res["output_hashes"] = own.output_hashes(dev)
    res["path_hashes"] = cs.path_hashes(dev)
    print(json.dumps({"output_hashes": res["output_hashes"], "path_hashes": res["path_hashes"]}),
          flush=True)
Path(OUT).write_text(json.dumps(res, indent=1))
