"""Shared helpers of the coded-scheme parity tests: fault specs built the
same way for both packages, and the field-by-field plan comparison."""
import numpy as np


def spec(fault_spec, deaths=(), slow=(), corrupt=()):
    """A ``FaultSpec`` of either package: ``deaths`` die at step 0."""
    return fault_spec.of({r: 0 for r in deaths}, slow=slow, corrupt=corrupt)


def assert_plans_equal(got, want):
    for field in ("n_data", "n_parity", "erased", "corrupt", "slow", "survivors",
                  "parity_used", "root", "gather_rounds", "bcast_rounds", "recoverable",
                  "n_ranks", "n_erased", "is_fault_free"):
        assert getattr(got, field) == getattr(want, field), field
    for field in ("death", "final_valid", "weights", "decode"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.shape == w.shape and np.array_equal(g, w), field
    assert got.message_count() == want.message_count()
    assert got.round_count() == want.round_count()
    assert got.payload_units() == want.payload_units()
    for n in (3, 16):
        assert got.bytes_on_wire(n) == want.bytes_on_wire(n)
        assert got.bytes_on_wire(n, symmetric=True) == want.bytes_on_wire(n, symmetric=True)
    leaves = [(4, 4, 4, True), (4, 6, 2, False)]
    assert got.bytes_on_wire_stacked(leaves) == want.bytes_on_wire_stacked(leaves)
