"""Train the paper's BSA model on the synthetic ShapeNet-Car task.

    python -m repro_torch.launch.train_shapenet --steps 300
    python -m repro_torch.launch.train_shapenet --device cpu --layers 1 --steps 2

The port's analogue of ``examples/train_shapenet.py``: the paper's settings
(AdamW, lr 1e-3 with linear warm-up and cosine decay, weight decay 0.01,
global-norm clipping at 1.0), batches of ``--batch`` cars padded to 3840
points (15 balls of 256), weights and batch order from seed 0.  It prints
the loss of every step and, at the end, the test MSE over 8 batches of 8
cars, as ``examples/train_shapenet.py`` does.  It runs on ``cuda`` unless
``--device cpu`` is given; there is no fallback from one to the other.  No
trainer, watchdog or checkpoint yet.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.shapenet import ShapeNetCarDataset
from repro_torch.launch.steps import make_train_step
from repro_torch.models.api import model_api
from repro_torch.optim import adamw_init


def to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def evaluate(api, model, ds, *, device, n_batches: int = 8, batch_size: int = 8) -> float:
    """Mean over ``n_batches`` test batches of the masked MSE."""
    mse = []
    for i, batch in enumerate(ds.batches(batch_size, shuffle=False, epochs=1)):
        if i >= n_batches:
            break
        batch = to_device(batch, device)
        pred = api.forward(model, batch)
        m = batch["mask"][..., None]
        mse.append(float((((pred - batch["target"]) ** 2) * m).sum() / m.sum()))
    return sum(mse) / max(len(mse), 1)


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="shapenet-bsa")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--layers", type=int, default=0, help="override (0 = config)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    mcfg = get_config(args.arch)
    if args.layers:
        mcfg = mcfg.scaled(n_layers=args.layers)
    device = torch.device(args.device)
    api = model_api(mcfg)
    model = api.init(0, device=device)
    opt_state = adamw_init(dict(model.named_parameters()))
    step = make_train_step(api, base_lr=1e-3, weight_decay=0.01,       # paper App. A
                           total_steps=args.steps,
                           warmup_steps=min(50, args.steps // 10))
    train_ds = ShapeNetCarDataset("train", ball_size=mcfg.bsa.ball_size)
    test_ds = ShapeNetCarDataset("test", ball_size=mcfg.bsa.ball_size)
    t0 = time.perf_counter()
    for i, batch in zip(range(args.steps), train_ds.batches(args.batch, seed=0)):
        model, opt_state, out = step(model, opt_state, to_device(batch, device))
        print(f"step {i + 1:4d}  loss {float(out['loss']):.5f}  "
              f"grad_norm {float(out['grad_norm']):.4f}  lr {out['lr']:.2e}", flush=True)
    wall = time.perf_counter() - t0
    mse = evaluate(api, model, test_ds, device=device)
    print(f"\n[{args.arch}] test MSE after {args.steps} steps: {mse:.4f}")
    print(f"train wall time {wall:.1f}s on {args.device}")
    return mse


if __name__ == "__main__":
    main()
