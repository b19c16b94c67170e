"""``bsa_attention(return_aux=True)`` of the port, branch by branch, against
the JAX package's ``jnp`` backend on the same weights and inputs.

Small shapes: B = 3 (one sample padded, one slot fully masked), N = 64,
Hq = 4 / Hkv = 2 (rep 2), D = 16, ball 16, ℓ = 4, k* = 2, g = 4.  The
port runs both its ``reference`` backend and its ``kernels`` backend (on
CPU tensors each kernel wrapper runs its plain version through the same
GQA layouts the CUDA kernels get).  Tolerance: fp32 1e-4, bf16 4e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bsa as j_bsa
from repro.core.config import BSAConfig as JBSAConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import bsa as t_bsa
from repro_torch.core.backend import use_backend
from repro_torch.core.config import BSAConfig

B, N, HQ, HKV, D, DM = 3, 64, 4, 2, 16, 32
BASE = dict(ball_size=16, cmp_block=4, slc_block=4, top_k=2, group_size=4)
VARIANTS = {
    "paper": {},
    "group8": dict(group_size=8),
    "no_group": dict(group_size=0, query_cmp_selection=False),
    "token_gates": dict(gate_mode="token"),
    "group_cmp": dict(group_compression=True),
    "keep_own_ball": dict(mask_own_ball=False),
}


def _mask():
    m = np.ones((B, N), bool)
    m[1, 41:] = False
    m[2] = False
    return m


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _setup(kw, seed=0):
    jcfg = JBSAConfig(**{**BASE, **kw}, backend="jnp")
    tcfg = BSAConfig(**{**BASE, **kw})
    jp = j_bsa.bsa_init(jax.random.PRNGKey(seed), jcfg, n_heads=HQ, n_kv_heads=HKV,
                        head_dim=D, d_model=DM)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda a: np.asarray(a) + rng.normal(0, 0.5, a.shape)
                        .astype(np.float32), jp)          # gates away from ½
    tp = t_bsa.bsa_init(tcfg, n_heads=HQ, n_kv_heads=HKV, head_dim=D, d_model=DM,
                        generator=torch.Generator().manual_seed(seed))
    params_from_jax(tree, tp)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in
              ((B, N, HQ, D), (B, N, HKV, D), (B, N, HKV, D), (B, N, DM))]
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), tp, arrays


@pytest.mark.parametrize("backend", ["reference", "kernels"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_bsa_attention_branches_match_jax(variant, backend):
    jcfg, tcfg, jp, tp, (q, k, v, x) = _setup(VARIANTS[variant])
    mask = _mask()
    want, jaux = j_bsa.bsa_attention(jp, *(jnp.asarray(a) for a in (q, k, v)),
                                     cfg=jcfg, mask=jnp.asarray(mask),
                                     x=jnp.asarray(x), return_aux=True)
    with use_backend(backend):
        got, taux = t_bsa.bsa_attention(tp, *(torch.from_numpy(a) for a in (q, k, v)),
                                        cfg=tcfg, mask=torch.from_numpy(mask),
                                        x=torch.from_numpy(x), return_aux=True)
    tol = dict(atol=1e-4, rtol=1e-4)
    for name in ("ball", "cmp", "slc"):
        np.testing.assert_allclose(_np(taux[name]), _np(jaux[name]), err_msg=name, **tol)
    for name in ("ball", "cmp", "slc"):
        np.testing.assert_allclose(_np(taux["gates"][name]), _np(jaux["gates"][name]),
                                   **tol)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    # sample 0 is fully valid: its top-k SETS must agree (never compare raw
    # index order — top_k and torch.topk order ties differently)
    np.testing.assert_array_equal(np.sort(taux["indices"][0].numpy(), -1),
                                  np.sort(np.asarray(jaux["indices"][0]), -1))
    assert (_np(got)[2] == 0).all() and np.isfinite(_np(got)).all()


def test_bsa_attention_bf16_scores():
    jcfg, tcfg, jp, tp, (q, k, v, x) = _setup(dict(score_dtype="bfloat16"), seed=1)
    mask = _mask()
    want = j_bsa.bsa_attention(jp, *(jnp.asarray(a) for a in (q, k, v)), cfg=jcfg,
                               mask=jnp.asarray(mask), x=jnp.asarray(x))
    got = t_bsa.bsa_attention(tp, *(torch.from_numpy(a) for a in (q, k, v)),
                              cfg=tcfg, mask=torch.from_numpy(mask),
                              x=torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=4e-2, rtol=4e-2)


def test_backend_overrides_route_branches():
    calls = []
    from repro_torch.core import backend as bk

    class Spy(bk.ReferenceBackend):
        name = "spy"

        def selection(self, *a, **kw):
            calls.append("selection")
            return super().selection(*a, **kw)

    bk.register_backend("spy", Spy(), overwrite=True)
    jcfg, tcfg, jp, tp, (q, k, v, x) = _setup({})
    cfg = BSAConfig(**BASE, backend="reference", backend_overrides={"slc": "spy"})
    t_bsa.bsa_attention(tp, *(torch.from_numpy(a) for a in (q, k, v)), cfg=cfg)
    assert calls == ["selection"]
    with pytest.raises(KeyError):
        t_bsa.bsa_attention(tp, *(torch.from_numpy(a) for a in (q, k, v)),
                            cfg=BSAConfig(**BASE, backend="no-such-backend"))
