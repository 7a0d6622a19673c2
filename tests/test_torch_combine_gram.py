"""The port's ``ops.combine_gram`` (G = R₁ᵀR₁ + R₂ᵀR₂) against the JAX
package's on the same inputs.  On the CPU the kernel wrapper takes its plain
version, held here against the Pallas kernel run in interpret mode, as
tests/test_kernels.py runs it; the CUDA kernel itself is held against the
same plain version on the card by chip_smoke.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference  # noqa: E402,F401  (before any repro import)
import jax.numpy as jnp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import traffic as jtraffic  # noqa: E402

from repro_torch.kernels import dispatch, ops, traffic  # noqa: E402
from repro_torch.kernels.combine_gram import combine_gram  # noqa: E402

# tests/test_kernels.py's tolerances, relative to max|G|
TOL = {"float32": 5e-4, "bfloat16": 3e-2}


def _pair(x, dt):
    return jnp.asarray(x, dtype=getattr(jnp, dt)), torch.from_numpy(x).to(getattr(torch, dt))


@pytest.mark.parametrize("lead", [(), (3,), (2, 4)], ids=str)
@pytest.mark.parametrize("n", [1, 7, 24])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_combine_gram_matches_pallas(rng, dt, n, lead):
    x1 = rng.standard_normal(lead + (n, n)).astype(np.float32)
    x2 = rng.standard_normal(lead + (n, n)).astype(np.float32)
    (j1, t1), (j2, t2) = _pair(x1, dt), _pair(x2, dt)
    want = np.asarray(jops.combine_gram(j1, j2, use_pallas=True, interpret=True))
    dispatch.launches.reset()
    for got in (ops.combine_gram(t1, t2, use_pallas=True), ops.combine_gram(t1, t2),
                combine_gram(t1, t2)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        err = np.abs(got.numpy() - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= TOL[dt]
    # a CPU tensor takes the plain version and launches nothing
    assert dispatch.launches.combine_gram == 0


def test_combine_gram_traffic_record_equals_reference(rng):
    x1, x2 = (rng.standard_normal((2, 4, 9, 9)).astype(np.float32) for _ in range(2))
    with jtraffic.track_traffic() as jt:
        jops.combine_gram(jnp.asarray(x1), jnp.asarray(x2), use_pallas=True, interpret=True)
    with traffic.track_traffic() as tt:
        ops.combine_gram(torch.from_numpy(x1), torch.from_numpy(x2), use_pallas=True)
    strip = [{k: v for k, v in r.items() if k != "traces"} for r in jt.records]
    assert [{k: v for k, v in r.items() if k != "traces"} for r in tt.records] == strip
    assert tt.tall_sweeps == 0 and tt.read_bytes == 2 * 8 * 81 * 4


@pytest.mark.parametrize("r1,r2,err,match", [
    (torch.zeros(5, 4), torch.zeros(5, 4), ValueError, r"\(\.\.\., n, n\)"),
    (torch.zeros(4, 4), torch.zeros(3, 4, 4), ValueError, "must match"),
    (torch.zeros(4, 4), torch.zeros(4, 4, dtype=torch.bfloat16), TypeError, "must match"),
    (torch.zeros(4, 4, dtype=torch.float64), torch.zeros(4, 4, dtype=torch.float64), TypeError,
     "not supported"),
    (torch.zeros(513, 513), torch.zeros(513, 513), ValueError, "512"),
    (torch.zeros(4), torch.zeros(4), ValueError, r"\(\.\.\., m, n\)"),
    (torch.zeros(4, 4), torch.zeros(4, 4).mT, ValueError, "contiguous"),
    (torch.zeros(4, 4).mT, torch.zeros(4, 4), ValueError, "contiguous"),
], ids=["not square", "shapes differ", "dtypes differ", "float64", "too wide", "1-D",
        "r2 strided", "r1 strided"])
def test_combine_gram_refuses_bad_operands(r1, r2, err, match):
    with pytest.raises(err, match=match):
        combine_gram(r1, r2)
