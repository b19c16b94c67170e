"""The port's encoder-decoder (seamless-m4t) and the non-BSA decode caches
against the JAX package, on the CPU.

* seamless-m4t at its smoke size: loss and every gradient, without and
  with a frame mask (non-causal BSA encoder, causal BSA decoder,
  cross-attention with the frame mask as key validity), and the
  teacher-forced logits;
* ``encdec_decode_step`` over ``cache_init(params=, memory=)``: the memory
  K/V computed once, the decode step for step against JAX's, and its first
  steps against ``decode_train``'s logits;
* the dense and paged decode of the full-attention and Erwin mechanisms
  (their plain ``sdpa`` over the cache) in a smoke LM stack against JAX's.

Same weights on both sides (``convert.params_from_jax``), inputs from
numpy; fp32, tolerance 1e-3 of each value and of each tensor's largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as j_ed
from repro.models import transformer as j_tf
from repro_torch.core.backend import use_backend
from repro_torch.models import encdec as t_ed
from repro_torch.models.api import model_api
from torch_family_util import (assert_close, assert_loss_and_grads_match, batches,
                               loss_and_grads, assert_trees_close, smoke_pair)

ARCH = "seamless-m4t-medium"


def test_encdec_loss_and_grads_match_jax():
    jcfg, jp, tcfg, model = assert_loss_and_grads_match(ARCH, 2, 128)
    assert tcfg.dec_ratio == 4 and len(model.enc_layers) == 2 and len(model.dec_layers) == 2
    jb, tb = batches(jcfg, tcfg, 2, 128, seed=1)
    assert tb["dec_tokens"].shape == (2, 32)
    want = j_ed.decode_train(jp, jb["dec_tokens"], j_ed.encode(jp, jb["frames"], mcfg=jcfg),
                             mcfg=jcfg)
    with use_backend("kernels"):
        got = model_api(tcfg).forward(model, tb)
    assert_close(got, want, "decode_train logits")


def test_encdec_frame_mask_matches_jax():
    """Frames past each sample's length masked: the encoder's BSA and the
    cross-attention's key validity, loss and every gradient."""
    jcfg, jp, tcfg, model = smoke_pair(ARCH)
    jb, tb = batches(jcfg, tcfg, 2, 128, seed=2)
    mask = np.arange(128)[None] < np.array([[128], [80]])
    jb = {**jb, "frame_mask": jnp.asarray(mask)}
    tb = {**tb, "frame_mask": torch.from_numpy(mask)}
    (jl, _, jg), (tl, _, tg) = loss_and_grads(jcfg, jp, tcfg, model, jb, tb)
    assert_close(tl, jl, "loss")
    assert_trees_close(tg, jg)


def test_encdec_decode_step_matches_jax_and_decode_train():
    jcfg, jp, tcfg, model = smoke_pair(ARCH)
    api = model_api(tcfg)
    B, frames, steps, max_len = 2, 128, 10, 64
    jb, tb = batches(jcfg, tcfg, B, frames, seed=3)
    toks = np.asarray(jb["dec_tokens"])                    # (B, 32): decode the first 10
    jmem = j_ed.encode(jp, jb["frames"], mcfg=jcfg)
    with use_backend("kernels"), torch.no_grad():
        tmem = t_ed.encode(model, tb["frames"], mcfg=tcfg)
        assert_close(tmem, jmem, "memory")
        tc = api.cache_init(B, max_len, torch.float32, device="cpu", params=model,
                            memory=tmem)
        teacher = t_ed.decode_train(model, torch.from_numpy(toks), tmem, mcfg=tcfg)
    with pytest.raises(ValueError, match="params= and memory="):
        api.cache_init(B, max_len, torch.float32, device="cpu")
    jc = j_ed.encdec_cache_init(jp, jmem, mcfg=jcfg, batch=B, max_len=max_len,
                                dtype=jnp.float32)
    assert len(tc) == tcfg.n_layers
    for i, c in enumerate(tc):
        assert_close(c["mem_k"], jc["mem_k"][i], f"mem_k {i}")
        assert_close(c["mem_v"], jc["mem_v"][i], f"mem_v {i}")
    jstep = jax.jit(lambda p, tok, c: j_ed.encdec_decode_step(p, tok, c, mcfg=jcfg))
    with use_backend("kernels"):
        for t in range(steps):
            want, jc = jstep(jp, jnp.asarray(toks[:, t]), jc)
            got, tc = api.decode_step(model, torch.from_numpy(toks[:, t]), tc)
            assert_close(got, want, f"step {t}")
            assert_close(got, teacher[:, t], f"decode ≡ decode_train at {t}")


@pytest.mark.parametrize("attention", ["full", "erwin"])
def test_non_bsa_decode_matches_jax(attention):
    """A smoke tinyllama stack on the full-attention / Erwin mechanism: the
    dense cache (``attention_cache_init`` without BSA: K, V and a length)
    and the paged pools (K, V only), each step against JAX's."""
    jcfg, jp, tcfg, model = smoke_pair("tinyllama-1.1b", attention=attention)
    api = model_api(tcfg)
    assert not hasattr(model.layers[0].pos0.attn, "bsa")
    B, steps, max_len, page = 2, 8, 64, 32
    toks = np.random.default_rng(4).integers(0, tcfg.vocab_size, (steps, B)).astype(np.int32)
    n_pages = max_len // page
    table = np.arange(B * n_pages, dtype=np.int32).reshape(B, n_pages)[::-1].copy()
    jc = j_tf.lm_cache_init(jcfg, B, max_len, jnp.float32)
    tc = api.cache_init(B, max_len, torch.float32, device="cpu")
    assert sorted(tc[0]["pos0"]) == sorted(jc["pos0"]) == ["k", "length", "v"]
    jpc = j_tf.lm_paged_cache_init(jcfg, B, B * n_pages, page, jnp.float32)
    tpc = api.paged_cache_init(B, B * n_pages, page, torch.float32, device="cpu")
    assert sorted(tpc[0]["pos0"]) == sorted(jpc["pos0"]) == ["k", "v"]
    jdense = jax.jit(lambda p, tok, c: j_tf.lm_decode_step(p, tok, c, mcfg=jcfg))
    jpaged = jax.jit(lambda p, tok, c, tb, ln: j_tf.lm_paged_decode_step(
        p, tok, c, tb, ln, mcfg=jcfg, page=page))
    lens = np.array([0, 3], np.int32)                 # slot 1 three positions ahead
    with use_backend("kernels"):
        for t in range(steps):
            want, jc = jdense(jp, jnp.asarray(toks[t]), jc)
            got, tc = api.decode_step(model, torch.from_numpy(toks[t]), tc)
            assert_close(got, want, f"dense step {t}")
            want, jpc = jpaged(jp, jnp.asarray(toks[t]), jpc, jnp.asarray(table),
                               jnp.asarray(lens + t))
            got, tpc = api.paged_decode_step(model, torch.from_numpy(toks[t]), tpc,
                                             torch.from_numpy(table),
                                             torch.from_numpy(lens + t).long(), page)
            assert_close(got, want, f"paged step {t}")
