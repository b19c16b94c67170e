"""Summary of tools/ab_worker.py's four runs (parent, change, change,
parent): python3 tools/ab_summary.py [DIR] (default build/ab)."""
import json
import sys
from pathlib import Path

DIR = Path(sys.argv[1] if len(sys.argv) > 1 else "build/ab")
runs = {t: json.loads((DIR / f"ab_{t}.json").read_text())
        for t in ("parent1", "change1", "change2", "parent2")
        if (DIR / f"ab_{t}.json").exists()}
print("card", next(iter(runs.values()))["card"])
order = list(runs)
for i, row in enumerate(next(iter(runs.values())).get("ball", [])):
    vals = {t: runs[t]["ball"][i] for t in order}
    print("ball", row["case"], row["dtype"], " | ".join(
        f"{t}: refused" if "refused" in v else
        f"{t}: fwd {v['fwd_ms']:.4f} (dev {v['fwd_device_ms']}) bwd {v['bwd_ms']:.4f} "
        f"(dev {v['bwd_device_ms']})" for t, v in vals.items()),
        "fwd digests equal:", len({v.get("fwd_digest") for v in vals.values()}) == 1,
        "bwd digests equal:", len({v.get("bwd_digest") for v in vals.values()}) == 1)
for t in order:
    if "seamless" in runs[t]:
        sm = runs[t]["seamless"]
        print("seamless", t, json.dumps({k: sm[k] for k in (
            "step_ms", "profiled_wall_ms", "device_kernel_ms", "device_busy_share",
            "by_category_ms", "ported_kernels_ms")}))
for i, row in enumerate(next(iter(runs.values()))["epilogue"]):
    vals = {t: runs[t]["epilogue"][i] for t in order}
    print("epi", row["shape"], row["dtype"],
          " | ".join(f"{t}: layer {v['layer_ms']:.4f} (dev {v['layer_device_ms']:.4f}, "
                     f"{len(v['layer_kernels'])} k) kern {v['kernel_ms']:.4f} "
                     f"dev {v['kernel_device_ms']}" for t, v in vals.items()),
          "digests equal:", len({v["digest"] for v in vals.values()}) == 1)
for i, row in enumerate(next(iter(runs.values()))["gather"]):
    vals = {t: runs[t]["gather"][i] for t in order}
    print("gather", row["rows"], row["dtype"], row["n"],
          " | ".join(f"{t}: {v['pair_ms']:.4f} (dev {v['pair_device_ms']:.5f}, "
                     f"{len(v['pair_kernels'])} k) isel {v['index_select_ms']:.4f} "
                     f"isel2 {v['index_select_pair_ms']:.4f}" for t, v in vals.items()))
for t in order:
    if "decode" in runs[t]:
        print("decode", t, json.dumps(runs[t]["decode"]))
hp = [t for t in order if "output_hashes" in runs[t]]
if len(hp) >= 2:
    a, b = runs[hp[0]], runs[hp[1]]
    for grp, rows in a["output_hashes"].items():
        if grp == "paths":
            continue
        other = b["output_hashes"].get(grp, {})
        diff = {k: (v, other.get(k)) for k, v in rows.items() if k in other and other[k] != v}
        print("hashes", grp, "differ:" if diff else "equal", diff if diff else
              sorted(k for k in rows if k in other))
    print("path_hashes", hp[0], a["path_hashes"], hp[1], b["path_hashes"],
          "equal" if a["path_hashes"] == b["path_hashes"] else "DIFFER")
