"""Shared set-up of the port's family tests (``tests/test_torch_{moe,mamba2,
encdec,vlm}.py``): a smoke config on both sides with the same weights
(``convert.params_from_jax``), the same numpy-seeded batch, and the loss
with every gradient on both sides.  Not a test module."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.configs.reduce import smoke_config as j_smoke_config
from repro.models.api import model_api as j_model_api
from repro_torch.configs import get_config
from repro_torch.configs.reduce import smoke_config
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core.backend import use_backend
from repro_torch.models.api import model_api

RTOL = 1e-3           # fp32: of each value, and of each tensor's largest value
# a gradient tree's tensor is held against its own largest value floored at
# this share of the tree's largest: φ_k.pos's gradient is 0 in exact
# arithmetic (a shift shared by every pooled key), rounding noise on both sides
GRAD_FLOOR = 1e-4


def np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update(flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def assert_close(got, want, err_msg="", rtol=RTOL, floor=0.0):
    """|got − want| ≤ rtol·|want| + rtol·max(max|want|, floor)."""
    got, want = np32(got), np32(want)
    assert got.shape == want.shape, (err_msg, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, floor)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(scale, 1e-12),
                               err_msg=err_msg)


def assert_trees_close(got: dict, want: dict, rtol=RTOL):
    """Every tensor of ``got`` against ``want``'s (``assert_close``, floored
    at ``GRAD_FLOOR`` of the tree's largest value)."""
    g, w = flat(got), flat(jax.tree.map(np.asarray, want))
    assert sorted(g) == sorted(w)
    floor = GRAD_FLOOR * max(float(np.abs(a).max()) for a in w.values() if a.size)
    for name in w:
        assert_close(g[name], w[name], err_msg=name, rtol=rtol, floor=floor)


def smoke_pair(arch: str, **overrides):
    """(JAX config, JAX params, port config, port model with those params):
    ``smoke_config(arch)`` on both sides, the JAX side on its jnp backend,
    ``overrides`` applied to both."""
    jcfg = j_smoke_config(j_get_config(arch))
    jcfg = jcfg.scaled(bsa=dataclasses.replace(jcfg.bsa, backend="jnp"), **overrides)
    jp = jax.tree.map(np.asarray, j_model_api(jcfg).init(jax.random.PRNGKey(0)))
    tcfg = smoke_config(get_config(arch)).scaled(**overrides)
    model = params_from_jax(jp, model_api(tcfg).init(1, device="cpu"))
    return jcfg, jp, tcfg, model


def batches(jcfg, tcfg, B: int, N: int, seed: int = 0) -> tuple[dict, dict]:
    """Each package's ``make_batch`` on the same numpy seed; they must agree."""
    jb = j_model_api(jcfg).make_batch(np.random.default_rng(seed), B, N)
    tb = model_api(tcfg).make_batch(np.random.default_rng(seed), B, N, device="cpu")
    assert sorted(jb) == sorted(tb)
    for key in jb:
        np.testing.assert_array_equal(np32(tb[key]), np32(jb[key]), err_msg=key)
    return jb, tb


def loss_and_grads(jcfg, jp, tcfg, model, jb, tb):
    """((JAX loss, metrics, grads), (port loss, metrics, grads)); the port's
    on the ``kernels`` backend (the kernels' plain versions on the CPU)."""
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p: j_model_api(jcfg).loss(p, jb),
                                              has_aux=True))(jp)
    model.zero_grad(set_to_none=True)
    with use_backend("kernels"):
        tl, tm = model_api(tcfg).loss(model, tb)
    tl.backward()
    return (jl, jm, jg), (tl, tm, params_to_jax(model, grads=True))


def assert_loss_and_grads_match(arch: str, B: int, N: int, seed: int = 0, **overrides):
    jcfg, jp, tcfg, model = smoke_pair(arch, **overrides)
    jb, tb = batches(jcfg, tcfg, B, N, seed)
    (jl, jm, jg), (tl, tm, tg) = loss_and_grads(jcfg, jp, tcfg, model, jb, tb)
    assert_close(tl, jl, "loss")
    assert sorted(tm) == sorted(jm)
    for key in jm:
        assert_close(tm[key], jm[key], key)
    assert_trees_close(tg, jg)
    return jcfg, jp, tcfg, model
