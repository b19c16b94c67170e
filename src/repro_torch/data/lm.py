"""Synthetic LM token pipeline (a copy of ``repro/data/lm.py``, numpy only,
so the same seed gives the same tokens): Zipf-distributed tokens with
short-range Markov structure (so the loss measurably decreases),
deterministic and restartable; the iterator state is a (seed, step) pair."""

from __future__ import annotations

import numpy as np

__all__ = ["lm_batches"]


def lm_batches(*, vocab_size: int, batch_size: int, seq_len: int, seed: int = 0,
               start_step: int = 0):
    """Yields {tokens, labels} with labels = next-token shift (numpy int32),
    and ``_state`` = {seed, step}."""
    step = start_step
    while True:
        rng = np.random.default_rng((seed, step))
        z = rng.zipf(1.3, (batch_size, seq_len + 1)).astype(np.int64)
        toks = (z % (vocab_size - 2)) + 1
        # inject deterministic bigram structure: even positions repeat
        toks[:, 2::2] = toks[:, 1:-1:2]
        toks = toks.astype(np.int32)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:],
               "_state": {"seed": seed, "step": step}}
        step += 1
