"""The port's LM serving path against the JAX package, on the CPU.

The host-side paged-cache classes (a copy of the JAX module) against the
JAX classes on one scripted sequence of admit / fork / append / retire /
evict; the port's ``ServingEngine`` against JAX's on the 1-layer smoke
tinyllama with the same (converted) weights: lockstep ``generate``, paged
``serve`` over three admission waves, EOS retirement, prefix reuse on and
off — the tokens must be equal; and the ``launch/serve.py`` CLI on the
CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.reduce import smoke_config as j_smoke_config
from repro.models.api import model_api as j_model_api
from repro.serving import paged_cache as j_pc
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs import get_config
from repro_torch.configs.reduce import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models.api import model_api
from repro_torch.serving import paged_cache as t_pc
from repro_torch.serving.engine import ServingEngine


def _state(kv):
    return (kv.table.tolist(), kv.lengths.tolist(), kv.allocator.free_count,
            [kv.allocator.refcount(b) for b in range(kv.allocator.num_blocks)],
            len(kv.prefix), kv.blocks_reused, kv.cow_copies, kv.version)


def test_paged_cache_classes_match_jax():
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 100, 12, dtype=np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, 100, n, dtype=np.int32)])
               for n in (5, 9, 0)]
    log = []
    for mod in (j_pc, t_pc):
        kv = mod.PagedKVCache(n_slots=3, num_blocks=12, page=4, n_pages=8,
                              prefix_cache=True)
        states, ops = [], []
        for s, p in enumerate(prompts[:2]):
            reused = kv.admit(s, p)
            for _ in range(len(p) - reused + 2):       # prefill + 2 decode steps
                ops += [(o.src, o.dst) for o in kv.prepare_append(s)]
                kv.committed(s)
                kv.seal_prompt_page(s, p)
            states.append(_state(kv))
        kv.fork(2, 0)
        ops += [(o.src, o.dst) for o in kv.prepare_append(2)]   # copy-on-write
        states.append(_state(kv))
        kv.retire(0)
        kv.retire(2)
        states.append(_state(kv))
        kv.admit(0, prompts[2])                        # fully cached prompt
        ops += [(o.src, o.dst) for o in kv.prepare_window(0, 4)]
        kv.committed(0, 4)
        states.append(_state(kv))
        kv.retire(0)
        kv.retire(1)
        kv.prefix.evict_lru(2)                         # evict from the prefix tree
        states.append(_state(kv))
        kv.prefix.clear()
        states.append(_state(kv))
        kv.check()
        a = mod.BlockAllocator(3)
        blocks = [a.alloc() for _ in range(3)]
        a.incref(blocks[1])
        states.append((blocks, a.alloc(), a.decref(blocks[1]), a.free_count))
        pc = mod.PrefixCache(mod.BlockAllocator(4), page=4)
        states.append([k.hex() if isinstance(k, bytes) else k
                       for k in pc.chain_keys(prompts[0])])
        log.append((states, ops))
    assert log[0] == log[1]


@pytest.fixture(scope="module")
def tiny_lm():
    jcfg = j_smoke_config(j_get_config("tinyllama-1.1b")).scaled(n_layers=1)
    jcfg = jcfg.scaled(bsa=dataclasses.replace(jcfg.bsa, backend="jnp"))
    japi = j_model_api(jcfg)
    jp = japi.init(jax.random.PRNGKey(0))
    tcfg = smoke_config(get_config("tinyllama-1.1b")).scaled(n_layers=1)
    api = model_api(tcfg)
    model = params_from_jax(jax.tree.map(np.asarray, jp), api.init(0, device="cpu"))
    return japi, jp, api, model


def _prompts(seed, lens, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n, dtype=np.int32) for n in lens]


def test_generate_matches_jax(tiny_lm):
    japi, jp, api, model = tiny_lm
    prompts = np.stack(_prompts(4, (24, 24)))
    want = JServingEngine(japi, jp, batch_slots=2, max_len=128).generate(prompts, 8)
    eng = ServingEngine(api, model, batch_slots=2, max_len=128)
    got = eng.generate(prompts, 8)
    np.testing.assert_array_equal(got, want)
    assert eng.tokens_generated == 16 and eng.tokens_per_second > 0
    eos = int(want[0, 2])                          # slot 0 retires after 2 tokens
    want = JServingEngine(japi, jp, batch_slots=2, max_len=128).generate(
        prompts, 8, eos_id=eos, pad_id=-1)
    got = ServingEngine(api, model, batch_slots=2, max_len=128).generate(
        prompts, 8, eos_id=eos, pad_id=-1)
    np.testing.assert_array_equal(got, want)
    assert (got[0, 2:] == -1).all()


@pytest.mark.parametrize("case", ["three_waves", "eos", "prefix", "no_prefix"])
def test_serve_matches_jax(tiny_lm, case):
    japi, jp, api, model = tiny_lm
    kw = dict(batch_slots=2, max_len=128, paged=True)
    serve_kw = dict(max_new_tokens=6)
    if case == "three_waves":                      # ragged; ≥ 3 waves on 2 slots
        prompts = _prompts(0, (40, 70, 20, 90, 33))
    elif case == "eos":
        prompts = _prompts(1, (25, 37, 18))
        first = JServingEngine(japi, jp, batch_slots=1, max_len=128).generate(
            prompts[0][None], 6)[0]
        kw["batch_slots"] = 1
        serve_kw["eos_id"] = int(first[3])         # request 0 retires at its 4th token
    else:
        rng = np.random.default_rng(2)
        shared = rng.integers(0, 512, 64, dtype=np.int32)
        prompts = [np.concatenate([shared, rng.integers(0, 512, n, dtype=np.int32)])
                   for n in (5, 11, 0)]            # the last: a fully cached prompt
        kw.update(batch_slots=1, prefix_cache=case == "prefix")
    jeng = JServingEngine(japi, jp, **kw)
    want = jeng.serve(prompts, **serve_kw)
    eng = ServingEngine(api, model, **kw)
    got = eng.serve(prompts, **serve_kw)
    eng.kv.check()
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    assert (eng.serve_steps, eng.kv.blocks_reused, eng.kv.cow_copies,
            eng.tokens_generated) == (jeng.serve_steps, jeng.kv.blocks_reused,
                                      jeng.kv.cow_copies, jeng.tokens_generated)
    if case == "eos":
        assert len(got[0]) == 3
    if case == "prefix":
        assert eng.kv.blocks_reused >= 4 and eng.kv.cow_copies >= 1
    if case == "no_prefix":
        assert eng.kv.blocks_reused == 0


def test_serve_equals_lockstep_and_reset_keeps_dtype(tiny_lm):
    _, _, api, model = tiny_lm
    prompts = _prompts(3, (45,)) * 2               # one prompt twice, side by side
    eng = ServingEngine(api, model, batch_slots=2, max_len=128, paged=True,
                        cache_dtype=torch.bfloat16)
    assert eng.caches[0]["pos0"]["k"].dtype == torch.bfloat16
    eng.reset(cache_dtype=torch.float32)
    assert eng.caches[0]["pos0"]["k"].dtype == torch.float32
    got = eng.serve(prompts, max_new_tokens=4)
    want = ServingEngine(api, model, batch_slots=1, max_len=128).generate(
        prompts[0][None], 4)[0]
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(got[1], want)


@pytest.mark.parametrize("paged", [False, True])
def test_serve_cli_on_cpu(paged, capsys):
    from repro_torch.launch import serve
    argv = ["--device", "cpu", "--smoke", "--slots", "2", "--tokens", "3",
            "--prompt-len", "20", "--max-len", "128"]
    out = serve.main(argv + (["--paged", "--requests", "3"] if paged else []))
    text = capsys.readouterr().out
    if paged:
        assert len(out) == 3 and all(len(o) == 3 for o in out)
        assert "served 3 requests" in text and "cpu" in text
    else:
        assert out.shape == (2, 3) and "generated" in text
