"""How far a mamba step's fp32 gradients lie from a float64 evaluation of
the same step, on the CPU.

    PYTHONPATH=src python tools/mamba_fp64_grads.py [--arch mamba2-1.3b] [--tokens 128]

The smoke config of ``--arch`` (seed-0 weights, a seeded batch of one
sequence) runs the port's loss and backward once in fp32 and once with
the same weights in float64 (``chip_smoke.float64_grads``: the model's
fp32 casts, its zero state and ``layers.nn``'s widening product kept in
float64).  Prints each gradient's largest difference over its largest
float64 value (floored at 1e-3 of the step's largest), the worst last:
the rounding a fp32 hold of that gradient cannot get below, whatever
computes it.
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path[:0] = [str(Path(__file__).resolve().parents[1])]

from chip_smoke import _grad_rels, float64_grads  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.reduce import smoke_config  # noqa: E402
from repro_torch.models.api import model_api  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--tokens", type=int, default=128)
    args = ap.parse_args(argv)
    cfg = smoke_config(get_config(args.arch))
    api = model_api(cfg)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, args.tokens), dtype=np.int32))
    batch = {"tokens": toks, "labels": toks}
    model = api.init(0, device="cpu")
    api.loss(model, batch)[0].backward()
    got = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}   # φ_q: none
    want = float64_grads(api, batch, "cpu")
    rel = _grad_rels(got, want, 1e-3)
    print(f"{cfg.name} smoke, {args.tokens} tokens: fp32 gradients against float64")
    for name in sorted(rel, key=rel.get)[-8:]:
        print(f"  {name:40s} {rel[name]:.3e}")


if __name__ == "__main__":
    main()
