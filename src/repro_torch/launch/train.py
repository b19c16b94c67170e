"""Training launcher (counterpart of ``repro/launch/train.py``).

    python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 100 \
        --batch 2 --seq 4096
    python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke --device cpu \
        --steps 2                                    # reduced config, CPU-sized

A plain loop of ``make_train_step`` (loss, backward, global-norm clipping
at 1.0, AdamW with weight decay 0.01, lr ``--lr`` with linear warm-up over a
twentieth of the steps and cosine decay, as the JAX launcher's
``TrainerConfig``) over ``lm_batches`` (seed 0) for the LM families, or
over ShapeNet-Car batches for the point-cloud family.  Weights come from
seed 0; the AdamW moments are kept in the config's ``opt_state_dtype``.
It runs on ``cuda`` unless ``--device cpu`` is given; there is no fallback
from one to the other.  The JAX launcher's ``Trainer`` (watchdog,
checkpoints) is not ported yet (ROADMAP queue 1 item 4), nor its
``--backend`` switch (item 2), mesh and ``--distributed`` (item 6).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.reduce import smoke_config
from repro_torch.data import ShapeNetCarDataset, lm_batches
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train_shapenet import to_device
from repro_torch.models.api import model_api
from repro_torch.optim import adamw_init


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    mcfg = get_config(args.arch)
    if args.smoke:
        mcfg = smoke_config(mcfg)
    device = torch.device(args.device)
    api = model_api(mcfg)
    model = api.init(0, device=device)
    opt_state = adamw_init(dict(model.named_parameters()),
                           state_dtype=getattr(torch, mcfg.opt_state_dtype))
    step = make_train_step(api, base_lr=args.lr, weight_decay=0.01,
                           total_steps=args.steps, warmup_steps=max(args.steps // 20, 1))
    if mcfg.family == "pointcloud":
        data = ShapeNetCarDataset("train", ball_size=mcfg.bsa.ball_size).batches(
            args.batch, seed=0)
    else:
        data = lm_batches(vocab_size=mcfg.vocab_size, batch_size=args.batch,
                          seq_len=args.seq, seed=0)
    t0 = time.perf_counter()
    loss = float("nan")
    for i, batch in zip(range(args.steps), data):
        model, opt_state, out = step(model, opt_state, to_device(batch, device))
        loss = float(out["loss"])
        print(f"step {i + 1:4d}  loss {loss:.5f}  grad_norm {float(out['grad_norm']):.4f}"
              f"  lr {out['lr']:.2e}", flush=True)
    print(f"done: {args.steps} steps of {args.arch}, wall "
          f"{time.perf_counter() - t0:.1f}s on {args.device}")
    return loss


if __name__ == "__main__":
    main()
