"""Build the kernels and run only ``chip_smoke.py``'s sharded phase.

    python3 tools/sharded_probe.py [case ...]   # on a machine with one CUDA card

The inputs are made as ``chip_smoke.py`` makes them (the padded and a
packed batch of 8 ShapeNet-Car train clouds, 8 clouds to serve, the LM's
requests); the phase then spawns its ranks on the card, for every case of
``SHARDED_P`` or the cases named.  Exits 1 if a check fails.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":                  # the ranks are spawned: they import this file
    print("# card:", cs.smi_line(), flush=True)
    print("# torch", torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    cs._build.load()
    print(f"# build {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    cs.TRAIN_STEPS = cs.DP_STEPS            # the train batches the phase reads
    batches = cs.train_batches(dev)
    packed = cs.packed_train_batches(dev)[0]
    clouds = cs.make_clouds(8, (2800, cs.REAL_POINTS), seed=2024)
    (ROOT / "build" / "sharded").mkdir(parents=True, exist_ok=True)
    cs.sharded_inputs(ROOT / "build" / "sharded" / "inputs.pt", batches, packed, clouds,
                      cs.get_config(cs.LM).vocab_size)
    del batches, packed
    if len(sys.argv) > 1:                   # run only the cases named
        cs.SHARDED_P = {c: cs.SHARDED_P[c] for c in sys.argv[1:]}
    paths = {}
    try:
        cs.sharded_phase(paths)
    except cs.CheckFailed as e:
        print("FAILED:", e, flush=True)
        sys.exit(1)
    print(json.dumps({k: v["launches"] for k, v in paths.items()}), flush=True)
