"""The port's Mixture-of-Experts FFN and the MoE LMs against the JAX package,
on the CPU.

* ``moe_apply`` alone: output, auxiliary loss, expert counts and every
  gradient, with and without the shared expert and the padded expert
  stack, and with drops (capacity factor 0.5): the dropped (token, choice)
  assignments and each kept one's slot equal JAX's dispatch rule, run
  with jnp on JAX's own router decisions;
* qwen2-moe and phi3.5-moe at their smoke size: loss (with 0.01 · the
  auxiliary loss) and every gradient, the forward's logits, and dense and
  paged decode steps against JAX's.

Same weights on both sides (``convert.params_from_jax``), inputs from
numpy; fp32, tolerance 1e-3 of each value and of each tensor's largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as j_moe
from repro.models import transformer as j_tf
from repro_torch.configs import get_config
from repro_torch.configs.reduce import smoke_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core.backend import use_backend
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tf
from repro_torch.models.api import model_api
from torch_family_util import (assert_close, assert_loss_and_grads_match,
                               assert_trees_close, np32, smoke_pair)
from repro.configs import get_config as j_get_config
from repro.configs.reduce import smoke_config as j_smoke_config

MOE_CASES = {
    "shared": dict(),                                      # qwen: 1 shared, 8 experts
    "no_shared": dict(n_shared_experts=0),
    "padded": dict(pad_experts_to=12),
    "drops": dict(capacity_factor=0.5),
    "drops_padded_shared": dict(capacity_factor=0.5, pad_experts_to=16),
}


def _moe_pair(**overrides):
    jcfg = j_smoke_config(j_get_config("qwen2-moe-a2.7b")).scaled(**overrides)
    tcfg = smoke_config(get_config("qwen2-moe-a2.7b")).scaled(**overrides)
    jp = jax.tree.map(np.asarray, j_moe.moe_init(jax.random.PRNGKey(3), jcfg,
                                                 param_dtype=jnp.float32))
    tp = params_from_jax(jp, t_moe.moe_init(tcfg, generator=torch.Generator()))
    return jcfg, jp, tcfg, tp


def _jax_dispatch(jp, x, jcfg):
    """JAX's dispatch rule (``repro/models/moe.py``), run on JAX's router:
    each (b, token, choice)'s slot, ``cap`` where dropped."""
    B, S, _ = x.shape
    k, E = jcfg.experts_per_token, jcfg.n_experts
    probs = jax.nn.softmax((x @ jp["router"]["w"]).astype(jnp.float32), -1)
    _, top_e = jax.lax.top_k(probs, k)
    cap = t_moe.moe_capacity(jcfg, S)
    slots = np.zeros((B, S * k), np.int64)
    for b in range(B):
        e_flat = top_e[b].reshape(-1)
        order = jnp.argsort(e_flat, stable=True)
        counts = jnp.zeros((E,), jnp.int32).at[e_flat].add(1)
        starts = jnp.cumsum(counts) - counts
        rank = jnp.arange(S * k) - starts[e_flat[order]]
        slots[b, np.asarray(order)] = np.asarray(jnp.where(rank < cap, rank, cap))
    return np.asarray(top_e), slots.reshape(B, S, k), cap


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_matches_jax(case):
    jcfg, jp, tcfg, tp = _moe_pair(**MOE_CASES[case])
    assert ("shared" in jp) == bool(tcfg.n_shared_experts)
    assert jp["w_gate"].shape[0] == max(tcfg.pad_experts_to, tcfg.n_experts)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 64, tcfg.d_model)).astype(np.float32)
    gy = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = j_moe.moe_apply(p, xx, jcfg)
        return jnp.sum(y * gy) + aux["aux_loss"], (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    ty, taux = t_moe.moe_apply(tp, xt, tcfg)
    ((ty * torch.from_numpy(gy)).sum() + taux["aux_loss"]).backward()
    assert_close(ty, jy, "y")
    assert_close(taux["aux_loss"], jaux["aux_loss"], "aux_loss")
    np.testing.assert_array_equal(taux["expert_counts"].numpy(),
                                  np.asarray(jaux["expert_counts"]))
    assert_close(xt.grad, jgx, "dx")
    assert_trees_close(params_to_jax(tp, grads=True), jgp)

    # the drop set and the slot order: JAX's rule on JAX's router decisions
    top_e, slots, cap = _jax_dispatch(jp, jnp.asarray(x), jcfg)
    route = t_moe.moe_route(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(route["top_e"].numpy(), top_e)
    assert route["cap"] == cap
    np.testing.assert_array_equal(route["slot"].numpy(), slots)
    dropped = int((slots == cap).sum())
    assert (dropped > 0) == case.startswith("drops"), dropped


def test_moe_capacity_rule():
    cfg = smoke_config(get_config("qwen2-moe-a2.7b"))
    full = get_config("qwen2-moe-a2.7b")
    assert t_moe.moe_capacity(full, 1) == 4              # a decode step: nothing drops
    assert t_moe.moe_capacity(full, 4096) == 384         # 1.25·4096·4/60 = 341 → 384
    assert t_moe.moe_capacity(cfg.scaled(capacity_factor=0.5), 64) == 8


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b"])
def test_moe_lm_loss_and_grads_match_jax(arch):
    jcfg, jp, tcfg, model = assert_loss_and_grads_match(arch, 2, 64)
    assert [f for _, f in t_tf.layer_spec(tcfg)] == ["moe"]
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 64)).astype(np.int32)
    want, jaux = j_tf.lm_apply(jp, jnp.asarray(toks), mcfg=jcfg)
    with use_backend("kernels"):
        got, taux = t_tf.lm_apply(model, torch.from_numpy(toks), mcfg=tcfg)
    assert_close(got, want, "logits")
    assert_close(taux, jaux, "aux_loss")


def test_moe_lm_loss_with_drops_matches_jax():
    assert_loss_and_grads_match("qwen2-moe-a2.7b", 2, 64, seed=2, capacity_factor=0.5)


def test_moe_decode_steps_match_jax():
    """Dense (lockstep) and paged decode of the smoke qwen2-moe, step for
    step, against JAX's: at S = 1 nothing drops."""
    jcfg, jp, tcfg, model = smoke_pair("qwen2-moe-a2.7b")
    B, steps, max_len, page = 2, 8, 64, 32
    toks = np.random.default_rng(4).integers(0, tcfg.vocab_size, (steps, B)).astype(np.int32)
    api = model_api(tcfg)
    jc = j_tf.lm_cache_init(jcfg, B, max_len, jnp.float32)
    tc = api.cache_init(B, max_len, torch.float32, device="cpu")
    n_pages = max_len // page
    table = np.arange(B * n_pages, dtype=np.int32).reshape(B, n_pages)[::-1].copy()
    jpc = j_tf.lm_paged_cache_init(jcfg, B, B * n_pages, page, jnp.float32)
    tpc = api.paged_cache_init(B, B * n_pages, page, torch.float32, device="cpu")
    jdense = jax.jit(lambda p, tok, c: j_tf.lm_decode_step(p, tok, c, mcfg=jcfg))
    jpaged = jax.jit(lambda p, tok, c, tb, ln: j_tf.lm_paged_decode_step(
        p, tok, c, tb, ln, mcfg=jcfg, page=page))
    with use_backend("kernels"):
        for t in range(steps):
            want, jc = jdense(jp, jnp.asarray(toks[t]), jc)
            got, tc = api.decode_step(model, torch.from_numpy(toks[t]), tc)
            assert_close(got, want, f"dense step {t}")
            lengths = np.full((B,), t, np.int32)
            want, jpc = jpaged(jp, jnp.asarray(toks[t]), jpc, jnp.asarray(table),
                               jnp.asarray(lengths))
            got, tpc = api.paged_decode_step(model, torch.from_numpy(toks[t]), tpc,
                                             torch.from_numpy(table),
                                             torch.from_numpy(lengths).long(), page)
            assert_close(got, want, f"paged step {t}")
    assert np32(got).shape == (B, tcfg.vocab_size)
