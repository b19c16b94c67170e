"""Train the paper's point-cloud models on the synthetic ShapeNet-Car task,
or on Elasticity.

    python -m repro_torch.launch.train_shapenet --steps 300
    python -m repro_torch.launch.train_shapenet --arch shapenet-full --steps 300
    python -m repro_torch.launch.train_shapenet --arch elasticity-bsa --steps 300
    python -m repro_torch.launch.train_shapenet --var-points 2800 3586 --ckpt ckpts
    python -m repro_torch.launch.train_shapenet --device cpu --layers 1 --steps 2

The port's analogue of ``examples/train_shapenet.py``: ``runtime.Trainer``
with the paper's settings (AdamW, lr 1e-3 with linear warm-up and cosine
decay, weight decay 0.01, global-norm clipping at 1.0), batches of
``--batch`` cars padded to 3840 points (15 balls of 256), weights and batch
order from seed 0.  Any variant of Table 3 trains (``shapenet-bsa``,
``-no-group``, ``-group-cmp``, ``shapenet-full``; ``shapenet-erwin``
raises at 3840 points, as the reference does: its levels 1 and 2 need a
multiple of 512 and 1024).  An ``elasticity-*`` arch trains on
``ElasticityDataset`` (972-point plates padded to 1024), as
``benchmarks/common.py`` chooses.  ``--var-points LO HI`` draws every
sample's point count from [LO, HI]: each batch is padded to the dataset's
``max_padded_len`` with per-sample masks (the masked padded path, not the
packed one), and so is every test batch.  ``--ckpt DIR`` checkpoints every
500 steps and at the last (the last 3 kept) and on SIGTERM, and resumes
from the newest one there.  ``--backend`` names the attention backend
(``reference | kernels | auto`` or a registered name) in the config;
``$REPRO_TORCH_ATTENTION_BACKEND`` beats it.  It prints the loss of every
twentieth step and of the last and, at the end, the test MSE over 8
batches of 8 samples, as ``examples/train_shapenet.py`` does.  It runs on
``cuda`` unless ``--device cpu`` is given; there is no fallback from one
to the other.
"""

from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import get_config
from repro_torch.data import ElasticityDataset, ShapeNetCarDataset
from repro_torch.models.api import model_api
from repro_torch.runtime import Trainer, TrainerConfig
from repro_torch.runtime.trainer import to_device


def evaluate(api, model, ds, *, device, n_batches: int = 8, batch_size: int = 8,
             pad_to: int | None = None) -> float:
    """Mean over ``n_batches`` test batches (padded to ``pad_to``, or each
    batch's longest sample) of the masked MSE."""
    mse = []
    for i, batch in enumerate(ds.batches(batch_size, shuffle=False, epochs=1,
                                         pad_to=pad_to)):
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
    ap.add_argument("--ckpt", default=None, help="checkpoint directory (resumes from it)")
    ap.add_argument("--backend", default=None,
                    help="attention backend: reference | kernels | auto | any "
                         "registered name (default: config)")
    ap.add_argument("--var-points", type=int, nargs=2, metavar=("LO", "HI"), default=None,
                    help="per-sample point counts drawn from [LO, HI]; batches padded "
                         "to the largest and masked")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    mcfg = get_config(args.arch)
    if args.layers:
        mcfg = mcfg.scaled(n_layers=args.layers)
    if args.backend:
        mcfg = mcfg.scaled(bsa=dataclasses.replace(mcfg.bsa, backend=args.backend))
    api = model_api(mcfg)
    dataset = ElasticityDataset if args.arch.startswith("elasticity") else ShapeNetCarDataset
    nrange = tuple(args.var_points) if args.var_points else None
    train_ds = dataset("train", ball_size=mcfg.bsa.ball_size, n_points_range=nrange)
    test_ds = dataset("test", ball_size=mcfg.bsa.ball_size, n_points_range=nrange)
    # one padded length for every mixed-size batch
    pad_to = train_ds.max_padded_len if nrange else None
    cfg = TrainerConfig(base_lr=1e-3, weight_decay=0.01,       # paper App. A
                        total_steps=args.steps, warmup_steps=min(50, args.steps // 10),
                        ckpt_dir=args.ckpt, log_every=20)
    trainer = Trainer(api, cfg, device=args.device)
    model, _ = trainer.fit(train_ds.batches(args.batch, seed=0, pad_to=pad_to),
                           steps=args.steps)
    mse = evaluate(api, model, test_ds, device=trainer.device, pad_to=pad_to)
    print(f"\n[{args.arch}] test MSE after {args.steps} steps: {mse:.4f}")
    print(f"train wall time {trainer.wall_time:.1f}s on {args.device}, stragglers "
          f"{len(trainer.watchdog.straggler_events)}")
    return mse


if __name__ == "__main__":
    main()
