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
``api.make_batch`` batches).  The JAX launcher's ``--mesh`` and
``--distributed`` wait for the distributed layer (ROADMAP queue 1 item 3).
"""

from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import get_config
from repro_torch.configs.reduce import smoke_config
from repro_torch.data import ShapeNetCarDataset, lm_batches
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
    cfg = TrainerConfig(base_lr=args.lr, total_steps=args.steps,
                        warmup_steps=max(args.steps // 20, 1),
                        ckpt_dir=args.ckpt, log_every=max(args.steps // 20, 1))
    trainer = Trainer(api, cfg, device=args.device)

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
    print(f"done: {args.steps} steps of {args.arch}, wall {trainer.wall_time:.1f}s on "
          f"{args.device}, stragglers {len(trainer.watchdog.straggler_events)}")
    return loss


if __name__ == "__main__":
    main()
