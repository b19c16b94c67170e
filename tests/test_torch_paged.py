"""The paged decode's pair gather on the CPU: ``paged_gather_pair`` (one
launch gathering the same rows of the K and the V pool, ``csrc/
paged_gather.cu``) through its plain version, against the JAX package's
Pallas ``paged_gather`` in interpret mode on each pool; the backends' pair
op and :func:`core.backend.get_paged_gather`'s rule.

Exact throughout: a gather copies rows.  Rows past the end, from the end
and before 0, in int32 and int64, fp32 and bf16 pools.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro_torch.core.backend import get_backend, get_paged_gather
from repro_torch.kernels import paged
from repro_torch.kernels.common import COUNTERS, reset_counters


def _pools(dtype, seed=0, shape=(40, 2, 16)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]


def _rows(index, shape=(3, 7), R=40):
    rows = np.random.default_rng(1).integers(0, R, shape).astype(np.int64)
    flat = rows.reshape(-1)
    flat[:4] = [R, R + 17, -1, -R - 5]             # past the end, from the end, before 0
    flat[-2:] = [-R, R - 1]                        # the first row from the end, the last
    return torch.from_numpy(rows).to(index)


@pytest.mark.parametrize("index", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_gather_pair_plain_matches_pallas(dtype, index):
    """Each pool of the pair equals JAX's ``paged_gather`` through the
    Pallas kernel (interpret mode) on the same rows, bit for bit."""
    kp, vp = _pools(dtype)
    rows = _rows(index)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = paged.paged_gather_pair_plain(torch.from_numpy(kp).to(tdt),
                                        torch.from_numpy(vp).to(tdt), rows)
    for pool, g in zip((kp, vp), got):
        want = j_ops.paged_gather(jnp.asarray(pool, jdt), jnp.asarray(rows.numpy()),
                                  interpret=True, force_kernel=True)
        assert g.shape == (3, 7, 2, 16) and g.dtype == tdt
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("index", [torch.int32, torch.int64], ids=["int32", "int64"])
def test_paged_gather_pair_wrapper_on_cpu_is_the_plain_pair(index):
    """On CPU tensors the wrapper returns the plain pair, equal to two
    single gathers, and moves no kernel counter."""
    kp, vp = (torch.from_numpy(p) for p in _pools("float32", seed=2, shape=(9, 1, 3)))
    rows = _rows(index, (5,), R=9)
    reset_counters()
    k, v = paged.paged_gather_pair(kp, vp, rows)
    assert torch.equal(k, paged.paged_gather(kp, rows))
    assert torch.equal(v, paged.paged_gather(vp, rows))
    assert all(c.n == 0 for c in COUNTERS.values())


def test_paged_gather_pair_refuses_unlike_pools():
    kp = torch.zeros(8, 2, 4)
    rows = torch.arange(3)
    for vp in (torch.zeros(9, 2, 4), torch.zeros(8, 2, 4, dtype=torch.bfloat16)):
        with pytest.raises(ValueError, match="pools differ"):
            paged.paged_gather_pair(kp, vp, rows)
    with pytest.raises(TypeError):
        paged.paged_gather_pair(kp, kp, rows.float())


class _SingleOnly:
    """A registered backend that gathers one pool and has no pair."""

    def __init__(self):
        self.calls = 0

    def paged_gather(self, pool, rows):
        self.calls += 1
        return pool[rows]


@pytest.mark.parametrize("backend", ["reference", "kernels", "auto"])
def test_get_paged_gather_pair_resolves_each_backend(backend):
    """``get_paged_gather(b)`` answers with the backend's own pair op,
    equal to the plain pair on in-range rows."""
    kp, vp = (torch.from_numpy(p) for p in _pools("float32", seed=3))
    rows = torch.randint(0, 40, (2, 5), generator=torch.Generator().manual_seed(0))
    fn = get_paged_gather(get_backend(backend))
    for got, want in zip(fn(kp, vp, rows), paged.paged_gather_pair_plain(kp, vp, rows)):
        assert torch.equal(got, want)


def test_get_paged_gather_pair_composes_a_single_gather():
    """A backend with only ``paged_gather`` gathers a pair with two calls of
    its own; one with neither takes the reference's pair."""
    kp, vp = (torch.from_numpy(p) for p in _pools("float32", seed=4))
    rows = torch.arange(6).reshape(2, 3)
    own = _SingleOnly()
    k, v = get_paged_gather(own)(kp, vp, rows)
    assert own.calls == 2 and torch.equal(k, kp[rows]) and torch.equal(v, vp[rows])
    k, v = get_paged_gather(object())(kp, vp, rows)
    assert torch.equal(k, kp[rows]) and torch.equal(v, vp[rows])
