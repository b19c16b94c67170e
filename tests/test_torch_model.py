"""The port's model and serving path against the JAX package.

``pc_apply`` and ``GeometryEngine(layout="padded").predict`` go against
their JAX counterparts (``backend="jnp"``) on the same weights (the JAX
pytree bridged with ``params_from_jax``) and inputs; the numpy copies of
the ball tree, the ragged packing and the synthetic car generator must give
what the JAX package's give.  Small model: 2 layers, d_model 64, Hq = 4 /
Hkv = 2, head_dim 16, ball 16, ℓ = 4, k* = 2, g = 4.  Tolerance 1e-3, the
JAX suite's whole-model tolerance.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.core import balltree as j_bt
from repro.core.config import BSAConfig as JBSAConfig
from repro.data import shapenet as j_data
from repro.models import pointcloud as j_pc
from repro.models.api import model_api as j_model_api
from repro.serving.engine import GeometryEngine as JGeometryEngine
from repro_torch.configs import ModelConfig, get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import balltree as t_bt
from repro_torch.core.backend import use_backend
from repro_torch.core.config import BSAConfig
from repro_torch.data import shapenet as t_data
from repro_torch.models import pointcloud as t_pc
from repro_torch.models.api import model_api
from repro_torch.serving.engine import GeometryEngine

TOL = dict(atol=1e-3, rtol=1e-3)
BSA = dict(ball_size=16, cmp_block=4, slc_block=4, top_k=2, group_size=4)
MODEL = dict(name="tiny-bsa", family="pointcloud", n_layers=2, d_model=64,
             n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, in_dim=7, out_dim=1,
             attention="bsa", param_dtype="float32", compute_dtype="float32")


def _pair(seed=0):
    """(JAX config, JAX params, port config, port model) on the same weights."""
    jcfg = JModelConfig(**MODEL, vocab_size=0, remat=False,
                        bsa=JBSAConfig(**BSA, backend="jnp"))
    tcfg = ModelConfig(**MODEL, bsa=BSAConfig(**BSA))
    jp = j_pc.pc_init(jax.random.PRNGKey(seed), jcfg)
    model = model_api(tcfg).init(seed, device="cpu")
    params_from_jax(jax.tree.map(np.asarray, jp), model)
    return jcfg, jp, tcfg, model


def _batch(seed=0, B=3, N=64):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, N, 7)).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[1, 41:] = False                           # a padded cloud
    mask[2] = False                                # a fully masked dummy slot
    feats[~mask] = 0.0
    return feats, mask


@pytest.mark.parametrize("backend", ["auto", "kernels"])
def test_pc_apply_matches_jax(backend):
    jcfg, jp, tcfg, model = _pair()
    feats, mask = _batch()
    want = np.asarray(j_pc.pc_apply(jp, feats, mcfg=jcfg, mask=mask))
    with use_backend(backend):
        got = t_pc.pc_apply(model, torch.from_numpy(feats), mcfg=tcfg,
                            mask=torch.from_numpy(mask))
    assert got.shape == (3, 64, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def _clouds(n_clouds=5, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_clouds):
        n = int(rng.integers(20, 64))
        out.append((rng.standard_normal((n, 3)).astype(np.float32),
                    rng.standard_normal((n, 7)).astype(np.float32)))
    return out


@pytest.mark.parametrize("pad_to", [64, None])
def test_geometry_engine_padded_matches_jax(pad_to):
    jcfg, jp, tcfg, model = _pair(seed=1)
    clouds = _clouds()                     # 5 clouds, 2 slots: last batch short
    jeng = JGeometryEngine(j_model_api(jcfg), jp, batch_slots=2, pad_to=pad_to,
                           backend="jnp", layout="padded")
    teng = GeometryEngine(model_api(tcfg), model, batch_slots=2, pad_to=pad_to,
                          layout="padded")
    want = jeng.predict(clouds)
    got = teng.predict(clouds)
    assert len(got) == len(clouds) and teng.clouds_served == 5
    assert teng.points_served == sum(p.shape[0] for p, _ in clouds)
    for g, w, (p, _) in zip(got, want, clouds):
        assert g.shape == (p.shape[0], 1) and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, **TOL)


def test_geometry_engine_packed_layout_is_next_slice():
    # the packed slice has landed: "packed" is the default for BSA, as in the
    # JAX package (its parity: tests/test_torch_varlen.py), and a layout of
    # neither kind is refused
    _, _, tcfg, model = _pair()
    assert GeometryEngine(model_api(tcfg), model).layout == "packed"
    assert GeometryEngine(model_api(tcfg), model, layout="packed").layout == "packed"
    with pytest.raises(ValueError, match="layout"):
        GeometryEngine(model_api(tcfg), model, layout="ragged")


@pytest.mark.parametrize("n,ball", [(3586, 256), (50, 16), (64, 16), (1000, 64)])
def test_balltree_permutation_matches_jax(n, ball):
    pts = np.random.default_rng(n).standard_normal((n, 3)).astype(np.float32)
    np.testing.assert_array_equal(t_bt.build_balltree_permutation(pts, ball),
                                  j_bt.build_balltree_permutation(pts, ball))


def test_ragged_packing_matches_jax():
    rng = np.random.default_rng(4)
    arrays = [rng.standard_normal((n, 7)).astype(np.float32) for n in (5, 17, 32)]
    for kw in (dict(pad_to=48), dict(), dict(geometric=True)):
        tb, tm = t_bt.pack_ragged(arrays, 16, **kw)
        jb, jm = j_bt.pack_ragged(arrays, 16, **kw)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tm, jm)
        for a, b in zip(t_bt.unpack_ragged(tb, tm), j_bt.unpack_ragged(jb, jm)):
            np.testing.assert_array_equal(a, b)
    for n in (1, 16, 17, 3586):
        assert t_bt.bucket_length(n, 256) == j_bt.bucket_length(n, 256)
        padded, mask = t_bt.pad_to_multiple(arrays[0][:1].repeat(n, 0), 256)
        jpadded, jmask = j_bt.pad_to_multiple(arrays[0][:1].repeat(n, 0), 256)
        np.testing.assert_array_equal(padded, jpadded)
        np.testing.assert_array_equal(mask, jmask)


def test_synthetic_car_matches_jax():
    for fn_args in ((600,),):
        t_rng, j_rng = np.random.default_rng(7), np.random.default_rng(7)
        tp = t_data._make_car(t_rng, *fn_args)
        jpts = j_data._make_car(j_rng, *fn_args)
        np.testing.assert_array_equal(tp, jpts)
        np.testing.assert_array_equal(t_data._normals(tp), j_data._normals(jpts))
        np.testing.assert_array_equal(t_data._pressure(tp, t_data._normals(tp), t_rng),
                                      j_data._pressure(jpts, j_data._normals(jpts), j_rng))
    clouds = t_data.make_clouds(3, (300, 400), seed=5)
    assert [c["feats"].shape[1] for c in clouds] == [7, 7, 7]
    assert all(300 <= c["points"].shape[0] <= 400 for c in clouds)


def test_params_from_jax_checks_names_and_shapes():
    _, jp, tcfg, model = _pair()
    tree = jax.tree.map(np.asarray, jp)
    w = tree["embed"]["w"]
    np.testing.assert_array_equal(model.embed.w.detach().numpy(), w.T)
    np.testing.assert_array_equal(
        model.layers[1].attn.wq.w.detach().numpy(), tree["layers"]["attn"]["wq"]["w"][1].T)
    bad = dict(tree, head={"w": tree["head"]["w"][:-1], "b": tree["head"]["b"]})
    with pytest.raises(ValueError):
        params_from_jax(bad, model)
    with pytest.raises(KeyError):
        params_from_jax(dict(tree, extra={"w": w}), model)


def test_shapenet_bsa_config_matches_jax():
    from repro.configs import get_config as j_get_config
    j, t = j_get_config("shapenet-bsa"), get_config("shapenet-bsa")
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
              "in_dim", "out_dim", "norm_eps", "param_dtype", "compute_dtype"):
        assert getattr(t, f) == getattr(j, f), f
    for f in ("ball_size", "cmp_block", "top_k", "group_size", "phi",
              "query_cmp_selection", "mask_own_ball"):
        assert getattr(t.bsa, f) == getattr(j.bsa, f), f
    assert t.pdtype() == torch.float32 and t.resolved_head_dim == 32
