"""Training launcher (counterpart of ``repro/launch/train.py``).

    python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 100 \
        --batch 2 --seq 4096 --ckpt /path/to/ckpts
    python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke --device cpu \
        --steps 2                                    # reduced config, CPU-sized

``runtime.Trainer`` over ``lm_batches`` (seed 0) for the decoder-only LM
families (dense, MoE, SSM, hybrid), or over ShapeNet-Car batches for the
point-cloud family: ``make_train_step``
(loss, backward, global-norm clipping at 1.0, AdamW with weight decay
0.01, lr ``--lr`` with linear warm-up over a twentieth of the steps and
cosine decay), weights from seed 0, the AdamW moments in the config's
``opt_state_dtype``.  ``--ckpt DIR`` saves a checkpoint every 500 steps
and at the last (the last 3 kept) and on SIGTERM, and resumes from the
newest one there (``Trainer.maybe_restore``): the LM's batches then
start after the last batch it trained on (its ``data_state``).
``--backend`` names the attention backend (``reference | kernels | auto``
or a registered name) in the config; ``$REPRO_TORCH_ATTENTION_BACKEND``
beats it.  It runs on ``cuda`` unless ``--device cpu`` is given; there is
no fallback from one to the other.  The VLM and encoder-decoder
configs are refused: their batches carry patch or frame embeddings that
token batches lack (train them with ``launch.steps.make_train_step`` on
``api.make_batch`` batches).

Across ranks, one process a card under torchrun::

    torchrun --nproc_per_node=<cards> -m repro_torch.launch.train \
        --arch shapenet-bsa --mesh 2x2 --distributed

``--distributed`` joins the process group from torchrun's environment
(NCCL for ``cuda``, each rank on card ``LOCAL_RANK``; gloo for ``--device
cpu``), and ``--mesh 2x2`` lays the ranks out as ``("data", "model")``
(``4`` alone: ``("data",)``) for ``runtime.Trainer(mesh=...)``.  Every
rank draws the same batches and trains on its slice of them; the ranks of
``model`` split the compute Megatron's way (each its attention heads,
FFN columns, vocabulary slice and experts, holding only its parts of
those weights: ``distributed/tensor_parallel.py``).  ``--mesh`` without a
process group is an error.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.configs.reduce import smoke_config
from repro_torch.data import ShapeNetCarDataset, lm_batches
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.api import model_api
from repro_torch.runtime import Trainer, TrainerConfig


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--backend", default=None,
                    help="attention backend: reference | kernels | auto | any "
                         "registered name (default: config)")
    ap.add_argument("--ckpt", default=None, help="checkpoint directory (resumes from it)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default="",
                    help="e.g. 2x4 → (data=2, model=4): the batch split over data, "
                         "each rank of model computing its heads, FFN columns, "
                         "vocabulary slice and experts with its parts of those weights")
    ap.add_argument("--distributed", action="store_true",
                    help="join the process group from torchrun's environment")
    args = ap.parse_args(argv)

    mcfg = get_config(args.arch)
    if mcfg.family in ("vlm", "audio"):
        ap.error(f"--arch {args.arch}: the {mcfg.family} family trains on patch / frame "
                 "embeddings, which the launcher's token batches lack")
    if args.smoke:
        mcfg = smoke_config(mcfg)
    if args.backend:
        mcfg = mcfg.scaled(bsa=dataclasses.replace(mcfg.bsa, backend=args.backend))
    api = model_api(mcfg)
    if args.distributed:
        if args.device.startswith("cuda"):
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if args.device.startswith("cuda") else "gloo")
    mesh = None
    if args.mesh:
        if not (dist.is_available() and dist.is_initialized()):
            ap.error("--mesh needs a process group: run under torchrun with --distributed "
                     "(torchrun --nproc_per_node=<cards> -m repro_torch.launch.train "
                     "--mesh ... --distributed)")
        dims = tuple(int(x) for x in args.mesh.split("x"))
        mesh = make_mesh(dims, ("data", "model")[:len(dims)])

    cfg = TrainerConfig(base_lr=args.lr, total_steps=args.steps,
                        warmup_steps=max(args.steps // 20, 1),
                        ckpt_dir=args.ckpt, log_every=max(args.steps // 20, 1))
    trainer = Trainer(api, cfg, mesh=mesh, device=args.device)

    model, opt_state = trainer.init_state()
    model, opt_state, step0 = trainer.maybe_restore(model, opt_state)
    if mcfg.family == "pointcloud":
        data = ShapeNetCarDataset("train", ball_size=mcfg.bsa.ball_size).batches(
            args.batch, seed=0)
    else:                            # the batch after the checkpoint's last one
        state = trainer.data_state
        data = lm_batches(vocab_size=mcfg.vocab_size, batch_size=args.batch,
                          seq_len=args.seq, seed=0,
                          start_step=state["step"] + 1 if state else 0)
    trainer.fit(data, steps=args.steps, model=model, opt_state=opt_state, start_step=step0)
    loss = trainer.metrics_history[-1]["loss"]
    if args.distributed:
        dist.destroy_process_group()
    if trainer.is_writer:
        where = f"{args.device}, mesh {mesh.shape}" if mesh is not None else args.device
        print(f"done: {args.steps} steps of {args.arch}, wall {trainer.wall_time:.1f}s on "
              f"{where}, stragglers {len(trainer.watchdog.straggler_events)}")
    return loss


if __name__ == "__main__":
    main()
