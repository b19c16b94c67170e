"""The port's mamba-2 mixer and the SSM / hybrid LMs against the JAX package,
on the CPU.

* the chunked SSD (``mamba2_apply``) at 256 tokens (two chunks of 128):
  output and every gradient against JAX's, finite gradients (the log-space
  mask), and the one-token decode (``mamba2_decode``) equal to the forward
  position by position, and to JAX's decode;
* the layer pattern of every config equals JAX's ``layer_spec`` (jamba's
  period: mamba with attention fifth, MoE every second layer);
* mamba2 and jamba at their smoke size: loss and every gradient, and the
  dense and paged decode with ``cache_reset_slot`` on a reused slot,
  step for step against JAX's; the serving engine on mamba2 with slot
  reuse against lockstep decode.

Same weights on both sides (``convert.params_from_jax``), inputs from
numpy; fp32, tolerance 1e-3 of each value and of each tensor's largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs.reduce import smoke_config as j_smoke_config
from repro.models import mamba2 as j_mamba
from repro.models import transformer as j_tf
from repro_torch.configs import get_config
from repro_torch.configs.reduce import smoke_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core.backend import use_backend
from repro_torch.models import mamba2 as t_mamba
from repro_torch.models import transformer as t_tf
from repro_torch.models.api import model_api
from repro_torch.serving.engine import ServingEngine
from torch_family_util import (assert_close, assert_loss_and_grads_match,
                               assert_trees_close, smoke_pair)


def _mamba_pair():
    jcfg = j_smoke_config(j_get_config("mamba2-1.3b"))
    tcfg = smoke_config(get_config("mamba2-1.3b"))
    jp = jax.tree.map(np.asarray, j_mamba.mamba2_init(jax.random.PRNGKey(7), jcfg,
                                                      param_dtype=jnp.float32))
    # dt_bias and conv_b away from their zero init, so they enter the check
    rng = np.random.default_rng(8)
    jp["dt_bias"] = rng.standard_normal(jp["dt_bias"].shape).astype(np.float32)
    jp["conv_b"] = 0.1 * rng.standard_normal(jp["conv_b"].shape).astype(np.float32)
    tp = params_from_jax(jp, t_mamba.mamba2_init(tcfg, generator=torch.Generator()))
    return jcfg, jp, tcfg, tp


def test_ssd_matches_jax_at_256_tokens():
    jcfg, jp, tcfg, tp = _mamba_pair()
    S = 256
    assert S // t_mamba.CHUNK == 2
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, S, tcfg.d_model)).astype(np.float32)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    (jy, (jgp, jgx)) = (j_mamba.mamba2_apply(jp, jnp.asarray(x), jcfg),
                        jax.grad(lambda p, xx: jnp.sum(j_mamba.mamba2_apply(p, xx, jcfg) * gy),
                                 argnums=(0, 1))(jp, jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    ty = t_mamba.mamba2_apply(tp, xt, tcfg)
    (ty * torch.from_numpy(gy)).sum().backward()
    assert_close(ty, jy, "y")
    assert_close(xt.grad, jgx, "dx")
    got = params_to_jax(tp, grads=True)
    assert all(np.isfinite(a).all() for a in got.values() if not isinstance(a, dict))
    assert_trees_close(got, jgp)


def test_mamba2_decode_equals_forward_and_jax():
    jcfg, jp, tcfg, tp = _mamba_pair()
    B, S = 2, 40
    x = np.random.default_rng(6).standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    with torch.no_grad():
        fwd = t_mamba.mamba2_apply(tp, torch.from_numpy(x), tcfg)
        cache = t_mamba.mamba2_cache_init(tcfg, B, torch.float32)
    jcache = j_mamba.mamba2_cache_init(jcfg, B, jnp.float32)
    jstep = jax.jit(lambda c, x1: j_mamba.mamba2_decode(jp, x1, c, jcfg))
    for s in range(S):
        with torch.no_grad():
            got, cache = t_mamba.mamba2_decode(tp, torch.from_numpy(x[:, s:s + 1]), cache,
                                               tcfg)
        want, jcache = jstep(jcache, jnp.asarray(x[:, s:s + 1]))
        assert_close(got, fwd[:, s:s + 1], f"decode ≡ forward at {s}")
        assert_close(got, want, f"decode vs JAX at {s}")
    assert_close(cache["h"], jcache["h"], "state")
    assert_close(cache["conv"], jcache["conv"], "conv window")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_layer_spec_matches_jax(arch):
    tcfg, jcfg = get_config(arch), j_get_config(arch)
    if tcfg.is_encoder_decoder:
        return                                   # no decoder-only stack
    assert t_tf.layer_spec(tcfg) == j_tf.layer_spec(jcfg)
    assert t_tf.layer_spec(smoke_config(tcfg)) == j_tf.layer_spec(j_smoke_config(jcfg))
    assert t_tf.n_periods(tcfg) == j_tf.n_periods(jcfg)
    assert t_tf.lm_has_recurrent_state(tcfg) == j_tf.lm_has_recurrent_state(jcfg)


def test_jamba_period_layer_order():
    spec = t_tf.layer_spec(get_config("jamba-1.5-large-398b"))
    assert [m for m, _ in spec] == ["mamba"] * 4 + ["attn"] + ["mamba"] * 3
    assert [f for _, f in spec] == ["dense", "moe"] * 4
    model = model_api(smoke_config(get_config("jamba-1.5-large-398b"))).init(0, device="cpu")
    period = model.layers[0]
    assert [hasattr(lp, "attn") for lp in period.positions()] == [m == "attn"
                                                                  for m, _ in spec]
    assert [hasattr(lp, "moe") for lp in period.positions()] == [f == "moe" for _, f in spec]


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b"])
def test_ssm_lm_loss_and_grads_match_jax(arch):
    assert_loss_and_grads_match(arch, 2, 128)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b"])
def test_decode_with_slot_reset_matches_jax(arch):
    """Dense decode, and paged decode over two slots where slot 1 takes a
    second request after ``cache_reset_slot`` (JAX's ``_reset_slot``), step
    for step against JAX's."""
    jcfg, jp, tcfg, model = smoke_pair(arch)
    api = model_api(tcfg)
    B, steps, max_len, page = 2, 10, 64, 32
    reset_at = 6
    toks = np.random.default_rng(4).integers(0, tcfg.vocab_size, (steps, B)).astype(np.int32)
    n_pages = max_len // page
    table = np.arange(B * n_pages, dtype=np.int32).reshape(B, n_pages)
    jc = j_tf.lm_cache_init(jcfg, B, max_len, jnp.float32)
    tc = api.cache_init(B, max_len, torch.float32, device="cpu")
    jpc = j_tf.lm_paged_cache_init(jcfg, B, B * n_pages, page, jnp.float32)
    tpc = api.paged_cache_init(B, B * n_pages, page, torch.float32, device="cpu")
    jdense = jax.jit(lambda p, tok, c: j_tf.lm_decode_step(p, tok, c, mcfg=jcfg))
    jpaged = jax.jit(lambda p, tok, c, tb, ln: j_tf.lm_paged_decode_step(
        p, tok, c, tb, ln, mcfg=jcfg, page=page))
    assert api.has_recurrent_state
    with use_backend("kernels"):
        for t in range(steps):
            want, jc = jdense(jp, jnp.asarray(toks[t]), jc)
            got, tc = api.decode_step(model, torch.from_numpy(toks[t]), tc)
            assert_close(got, want, f"dense step {t}")
            if t == reset_at:                       # slot 1 admits a new request
                jpc = j_tf.lm_paged_cache_reset_slot(jcfg, jpc, 1)
                tpc = api.cache_reset_slot(tpc, 1)
            lengths = np.array([t, t - reset_at if t >= reset_at else t], np.int32)
            want, jpc = jpaged(jp, jnp.asarray(toks[t]), jpc, jnp.asarray(table),
                               jnp.asarray(lengths))
            got, tpc = api.paged_decode_step(model, torch.from_numpy(toks[t]), tpc,
                                             torch.from_numpy(table),
                                             torch.from_numpy(lengths).long(), page)
            assert_close(got, want, f"paged step {t}")


def test_mamba2_serving_reuses_slots_like_lockstep():
    """``ServingEngine(paged=True)`` on the smoke mamba2 with 2 slots and 3
    requests (a slot is reused, ``cache_reset_slot`` runs; prefix reuse is
    off for recurrent state): each request's tokens equal a lockstep
    ``generate`` of it alone."""
    tcfg = smoke_config(get_config("mamba2-1.3b"))
    api = model_api(tcfg)
    model = api.init(0, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32) for n in (9, 5, 7)]
    resets = []
    reset = api.cache_reset_slot

    def spy(caches, slot):
        resets.append(slot)
        return reset(caches, slot)

    eng = ServingEngine(api.__class__(**{**api.__dict__, "cache_reset_slot": spy}), model,
                        batch_slots=2, max_len=64, paged=True, page=32)
    assert not eng._prefix_enabled
    served = eng.serve(prompts, max_new_tokens=4)
    assert len(resets) == 3
    for rid, prompt in enumerate(prompts):
        one = ServingEngine(api, model, batch_slots=1, max_len=64)
        want = one.generate(prompt[None], 4)
        np.testing.assert_array_equal(np.asarray(served[rid]), np.asarray(want)[0])
