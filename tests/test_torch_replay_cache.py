"""The port's program cache against the reference's cached compile
functions, on the CPU.

The reference keeps one ``lru_cache`` per compile function, keyed on the entry
point's statics, with jit's own unbounded per-shape cache under each entry.
The port's :mod:`repro_torch.replay` keeps the same two levels per entry
point, so the same calls count the same traces: many shapes under one key
evict nothing, and a key pushed out past the bound traces again.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)
import jax.numpy as jnp  # noqa: E402
from repro import collective as jc  # noqa: E402
from repro.collective import coded as jcoded  # noqa: E402
from repro.collective import engine as jengine  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.qr import QRConfig as JQRConfig  # noqa: E402
from repro.qr import blocked as jblocked  # noqa: E402
from repro.qr import factorize as jfactorize  # noqa: E402
from repro.qr import tsqr as jtsqr  # noqa: E402

from repro_torch import collective as tc  # noqa: E402
from repro_torch import replay  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.qr import QRConfig, factorize  # noqa: E402

REFERENCE_COMPILERS = {
    "blocked_qr_pipeline": jblocked._compiled_sim_pipeline,
    "tsqr_batched": jtsqr._compiled_tsqr_batched,
    "tsqr_coded": jtsqr._compiled_tsqr_coded,
    "ft_allreduce": jengine._ft_allreduce_compiled,
    "coded_allreduce": jcoded._coded_allreduce_compiled,
    "ft_allreduce_shard": jengine._ft_allreduce_shard_compiled,
    "tsqr_shard_map": jtsqr._compiled_tsqr_shard,
    "tsqr_gram_shard_map": jtsqr._compiled_tsqr_gram_shard,
    "shard_pipeline": jblocked._compiled_shard_pipeline,
    "blocked_qr_shard_map": jblocked._compiled_shard_general,
}


def _traces(name):
    return dispatch.trace_count(name), jdispatch.trace_count(name)


@pytest.mark.parametrize("name", sorted(REFERENCE_COMPILERS))
def test_bound_is_the_reference_lru_size(name):
    assert replay.BOUNDS[name] == REFERENCE_COMPILERS[name].cache_info().maxsize


def test_many_shapes_under_one_key_evict_nothing(rng):
    """65 payload shapes through ``ft_allreduce_jit`` on ``SimComm(4)``
    trace once each on both sides; the first shape again traces nothing."""
    comm, jcomm = tc.SimComm(4, "cpu"), jc.SimComm(4)
    xs = [rng.standard_normal((4, 3, k)).astype(np.float32) for k in range(101, 166)]
    t0 = _traces("ft_allreduce")
    stats0 = replay.stats()
    for x in xs:
        tc.ft_allreduce_jit(torch.from_numpy(x), comm)
        jc.ft_allreduce_jit(jnp.asarray(x), jcomm)
    t1 = _traces("ft_allreduce")
    assert t1[0] - t0[0] == t1[1] - t0[1] == 65
    got, _ = tc.ft_allreduce_jit(torch.from_numpy(xs[0]), comm)
    want, _ = jc.ft_allreduce_jit(jnp.asarray(xs[0]), jcomm)
    assert _traces("ft_allreduce") == t1
    assert replay.stats()["evictions"] == stats0["evictions"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_key_evicted_past_the_bound_traces_again(rng):
    """``tsqr_batched`` (bound 64) under 65 statics keys, one ``reorth`` each:
    the first key is evicted, so calling it again traces once on both sides,
    and the last key is still cached on both."""
    a = rng.standard_normal((1, 2, 5, 3)).astype(np.float32)
    configs = [dict(reorth=k) for k in range(100, 165)]
    t0 = _traces("tsqr_batched")
    ev0 = replay.stats()["evictions"]
    for cfg in configs:
        factorize(a, QRConfig(**cfg), device="cpu")
        jfactorize(jnp.asarray(a), JQRConfig(**cfg))
    t1 = _traces("tsqr_batched")
    assert t1[0] - t0[0] == t1[1] - t0[1] == 65
    assert replay.stats()["evictions"] - ev0 >= 1
    factorize(a, QRConfig(**configs[-1]), device="cpu")
    jfactorize(jnp.asarray(a), JQRConfig(**configs[-1]))
    assert _traces("tsqr_batched") == t1
    got = factorize(a, QRConfig(**configs[0]), device="cpu")
    want = jfactorize(jnp.asarray(a), JQRConfig(**configs[0]))
    t2 = _traces("tsqr_batched")
    assert t2[0] - t1[0] == t2[1] - t1[1] == 1
    np.testing.assert_allclose(got.r.numpy(), np.asarray(want.r), rtol=1e-5, atol=1e-5)
