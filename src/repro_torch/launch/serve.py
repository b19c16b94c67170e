"""Serving launcher: greedy or temperature decode through ``ServingEngine``.

Counterpart of ``repro/launch/serve.py``.  Lockstep generation on random
prompts:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --slots 4 --tokens 64

``--paged`` serves ragged requests by continuous batching over the paged KV
cache (retiring finished slots and admitting queued ones mid-flight):

    PYTHONPATH=src python -m repro_torch.launch.serve --paged --requests 16 --tokens 32

``--smoke`` shrinks the config to its smoke size (two layers, d_model 64)
and ``--device cpu`` runs on the CPU (the kernels' plain versions); the
default device is the card.  Weights are random, from seed 0.  ``--smoke``
without ``--paged`` is the analogue of ``examples/serve_lm.py``: random
prompts, greedy ``generate``, and the printed shape, first slot and
tokens/s.  ``--arch`` takes every decoder-only LM (dense, MoE, SSM,
hybrid: a mamba layer's state is zeroed when its slot takes a request, and
prefix reuse is off for it) and, in lockstep only, the VLM (decoding on its
backbone); a family without a paged decoder is refused with ``--paged``,
and the encoder-decoder always (its decode needs the encoder's memory).
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.reduce import smoke_config
from repro_torch.models.api import model_api
from repro_torch.serving.engine import ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None,
                    help="attention backend: reference | kernels | auto (default: config)")
    ap.add_argument("--paged", action="store_true",
                    help="continuous batching over the paged KV cache")
    ap.add_argument("--requests", type=int, default=8,
                    help="(--paged) number of ragged requests to serve")
    ap.add_argument("--page", type=int, default=None,
                    help="(--paged) tokens per KV block (default: lcm of the local "
                         "window and the compression block)")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="(--paged) KV pool size in blocks")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="(--paged) disable cross-request prefix reuse")
    args = ap.parse_args(argv)

    mcfg = get_config(args.arch)
    if mcfg.is_encoder_decoder:
        ap.error(f"--arch {args.arch}: the encoder-decoder's decode needs the encoder's "
                 "memory (api.cache_init(params=, memory=)); serve a decoder-only LM")
    if args.smoke:
        mcfg = smoke_config(mcfg)
    if args.backend:
        mcfg = mcfg.scaled(bsa=dataclasses.replace(mcfg.bsa, backend=args.backend))
    api = model_api(mcfg)
    if args.paged and not api.has_paged_decoder:
        ap.error(f"--arch {args.arch}: family {mcfg.family!r} has no paged decode path")
    model = api.init(0, device=args.device)
    rng = np.random.default_rng(0)
    if args.paged:
        eng = ServingEngine(api, model, batch_slots=args.slots, max_len=args.max_len,
                            temperature=args.temperature, paged=True, page=args.page,
                            num_blocks=args.num_blocks,
                            prefix_cache=not args.no_prefix_cache)
        lens = rng.integers(args.prompt_len // 2, args.prompt_len + 1, args.requests)
        prompts = [rng.integers(0, mcfg.vocab_size, n, dtype=np.int32) for n in lens]
        out = eng.serve(prompts, max_new_tokens=args.tokens)
        print(f"served {len(out)} requests in {eng.serve_steps} steps "
              f"(prompt lens {lens.min()}..{lens.max()}) on {torch.device(args.device)}, "
              f"throughput {eng.tokens_per_second:.1f} tok/s, prefix blocks reused "
              f"{eng.kv.blocks_reused}, cow copies {eng.kv.cow_copies}")
        return out
    eng = ServingEngine(api, model, batch_slots=args.slots, max_len=args.max_len,
                        temperature=args.temperature)
    prompts = rng.integers(0, mcfg.vocab_size, (args.slots, args.prompt_len),
                           dtype=np.int32)
    out = eng.generate(prompts, args.tokens)
    print(f"generated {out.shape} on {torch.device(args.device)}, throughput "
          f"{eng.tokens_per_second:.1f} tok/s ({args.slots} slots)")
    print("first slot:", out[0].tolist())
    return out


if __name__ == "__main__":
    main()
