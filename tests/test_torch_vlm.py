"""The port's VLM (llava-next) against the JAX package, on the CPU.

* llava-next at its smoke size: the batch (32 image tokens first, then the
  text) drawn alike from numpy, the forward's logits, the loss on the text
  positions only and every gradient, the projector's tanh GELU;
* the decode runs on the backbone from an empty cache, text only, as
  JAX's does, step for step against JAX's; the VLM has no paged decoder.

Same weights on both sides (``convert.params_from_jax``, the backbone's
stack under ``lm.layers``), inputs from numpy; fp32, tolerance 1e-3 of
each value and of each tensor's largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import transformer as j_tf
from repro.models import vlm as j_vlm
from repro_torch.convert import params_to_jax
from repro_torch.core.backend import use_backend
from repro_torch.layers.losses import masked_mean_nll
from repro_torch.models import vlm as t_vlm
from repro_torch.models.api import model_api
from torch_family_util import (assert_close, assert_loss_and_grads_match, batches, flat,
                               smoke_pair)

ARCH = "llava-next-34b"


def test_vlm_loss_and_grads_match_jax():
    jcfg, jp, tcfg, model = assert_loss_and_grads_match(ARCH, 2, 96)
    assert tcfg.vision_tokens == 32 and tcfg.n_heads // tcfg.n_kv_heads == 4
    assert sorted(flat(params_to_jax(model))) == sorted(flat(jp))
    assert "lm.layers.pos0.attn.wq.w" in flat(jp)


def test_vlm_forward_and_text_only_loss():
    jcfg, jp, tcfg, model = smoke_pair(ARCH)
    jb, tb = batches(jcfg, tcfg, 2, 96, seed=1)
    assert tb["tokens"].shape == (2, 64) and tb["patch_embeds"].shape == (2, 32, 32)
    want, _ = j_vlm.vlm_apply(jp, jb["tokens"], jb["patch_embeds"], mcfg=jcfg)
    with use_backend("kernels"):
        got = model_api(tcfg).forward(model, tb)
        loss, metrics = model_api(tcfg).loss(model, tb)
    assert got.shape == (2, 96, tcfg.vocab_size)
    assert_close(got, want, "logits")
    text = masked_mean_nll(got[:, 32:], tb["labels"])        # the image positions unread
    assert_close(metrics["loss"], text, "text-only loss")
    assert_close(loss, text, "no MoE: no auxiliary term")


def test_vlm_decodes_on_the_backbone_like_jax():
    jcfg, jp, tcfg, model = smoke_pair(ARCH)
    api = model_api(tcfg)
    assert api.has_decoder and not api.has_paged_decoder
    B, steps, max_len = 2, 8, 64
    toks = np.random.default_rng(4).integers(0, tcfg.vocab_size, (steps, B)).astype(np.int32)
    jc = j_tf.lm_cache_init(jcfg, B, max_len, jnp.float32)
    tc = api.cache_init(B, max_len, torch.float32, device="cpu")
    jstep = jax.jit(lambda p, tok, c: j_tf.lm_decode_step(p["lm"], tok, c, mcfg=jcfg))
    with use_backend("kernels"):
        for t in range(steps):
            want, jc = jstep(jp, jnp.asarray(toks[t]), jc)
            got, tc = api.decode_step(model, torch.from_numpy(toks[t]), tc)
            assert_close(got, want, f"step {t}")


def test_projector_is_the_tanh_gelu_mlp():
    jcfg, jp, tcfg, model = smoke_pair(ARCH)
    pe = np.random.default_rng(2).standard_normal((2, 32, 32)).astype(np.float32)
    want = j_vlm._project(jp["projector"], jnp.asarray(pe), jnp.float32)
    with torch.no_grad():
        got = t_vlm._project(model.projector, torch.from_numpy(pe), torch.float32)
    assert_close(got, want, "projector")
