"""Build the kernels, then hold ``bta_fwd`` / ``bta_bwd`` to their plain
versions on one card: seamless's encoder balls (16 heads of 64, 4,096
frames, balls of 256, bf16) and llava's heads (56 / 8 of 128) with their
call and device times; a ball with 2 valid keys, a dead ball and (with
``live`` forced to 1) walked all-masked rows at D 16-128 and rep 1 / 2 / 4;
a ball of 512; a bf16 ball of 32 (the rows path).  Each backward runs
twice and must give equal bits.  Prints the ptxas registers and spills of
the ball kernels, one JSON line a case and ``{"ok": ...}`` last.

    python3 tools/bta_probe.py        # from the repository root, on the card
"""
import json
import re
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, bta  # noqa: E402
from repro_torch.kernels.common import row_delta  # noqa: E402


def case(dev, BH, nh, rep, N, D, m, valid, seed, dt=torch.bfloat16):
    q = cs.rand((BH, rep, N, D), dt, dev, seed)
    k = cs.rand((BH, N, D), dt, dev, seed + 1)
    v = cs.rand((BH, N, D), dt, dev, seed + 2)
    kb = torch.where(valid, 0.0, -1e30).float()
    return q, k, v, kb, dict(ball_size=m, n_heads=nh)


def run(dev, name, q, k, v, kb, kw, live=None, timing=False):
    plan = bta.bta_plan(kw["ball_size"], q.shape[-1], q.shape[1], q.dtype)
    o, lse = bta.ball_attention_fwd(q, k, v, kb, live=live, **kw)
    torch.cuda.synchronize()
    err_f, ok_f = cs.max_err((o, lse), bta.ball_attention_fwd_plain(q, k, v, kb, **kw))
    do = cs.rand(o.shape, q.dtype, dev, 99)
    args = (q, k, v, kb, do, lse, row_delta(do, o))
    g1 = bta.ball_attention_bwd(*args, live=live, **kw)
    g2 = bta.ball_attention_bwd(*args, live=live, **kw)
    torch.cuda.synchronize()
    err_b, ok_b = cs.rel_err(g1, bta.ball_attention_bwd_plain(*args, **kw))
    same = all(torch.equal(a, b) for a, b in zip(g1, g2))
    row = dict(case=name, path=plan.path, fwd_err=err_f, fwd_ok=ok_f, bwd_err=err_b,
               bwd_ok=ok_b, bits_equal=same)
    if timing:
        row.update(fwd_ms=cs.median_ms(lambda: bta.ball_attention_fwd(q, k, v, kb, **kw)),
                   fwd_dev=cs.device_ms(lambda: bta.ball_attention_fwd(q, k, v, kb, **kw),
                                        "bta_fwd")[0],
                   bwd_ms=cs.median_ms(lambda: bta.ball_attention_bwd(*args, **kw)),
                   bwd_dev=cs.device_ms(lambda: bta.ball_attention_bwd(*args, **kw),
                                        "bta_bwd")[0])
    print(json.dumps(row), flush=True)
    return ok_f and ok_b and same


def main():
    dev = torch.device("cuda")
    print(cs.smi_line(), flush=True)
    t0 = time.time()
    _build.load()
    print(f"# built in {time.time() - t0:.1f} s", flush=True)
    log = _build.last_build["log"]
    cur = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1) if "bta_" in m.group(1) else None
        elif cur and re.search(r"registers|spill", line):
            print("# ptxas", cur[:60], line.strip(), flush=True)
    print(json.dumps({"ptxas": [r for r in cs.ptxas_table(log) if r["kernel"].startswith("bta")]}))
    ok = True
    # seamless's encoder: 16 heads of 64, N 4096, balls of 256, every frame valid
    valid = torch.ones(1, 4096, dtype=torch.bool, device=dev)
    ok &= run(dev, "seamless", *case(dev, 16, 16, 1, 4096, 64, 256, valid, 1), timing=True)
    # llava's heads: 56 / 8 of 128 (rep 7)
    ok &= run(dev, "d128_rep7", *case(dev, 8, 8, 7, 4096, 128, 256, valid, 2), timing=True)
    # edges: 2 samples, ball 1 with 2 valid keys, ball 2 dead, a hole in sample 1
    ev = torch.ones(2, 768, dtype=torch.bool, device=dev)
    ev[0, 258:] = False
    ev[1, 5:40] = False
    for D in (16, 32, 64, 128):
        for rep in (1, 2, 4):
            c = case(dev, 4, 2, rep, 768, D, 256, ev, 10 + D + rep)
            live = bta._live(c[3], 256)
            ok &= run(dev, f"edges_d{D}_rep{rep}", *c)
            ok &= run(dev, f"edges_forced_d{D}_rep{rep}", *c, live=torch.ones_like(live))
    ev5 = torch.ones(2, 1536, dtype=torch.bool, device=dev)
    ev5[0, 600:] = False
    ok &= run(dev, "ball512_d64_rep2", *case(dev, 4, 2, 2, 1536, 64, 512, ev5, 7))
    ok &= run(dev, "ball32_rows_d64", *case(dev, 4, 2, 2, 768, 64, 32, ev, 8))
    print(json.dumps({"ok": bool(ok)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
