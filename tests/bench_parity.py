"""Shared helpers of the bench-case parity tests: hold a port case's metric
dict against the reference case's on the same kwargs.

Metric names, gates, directions, units and tolerances must be equal; hard
ints and bools equal; hard floats equal to the last rounding (byte and sweep
ratios, computed from equal integer counts) unless the caller checks a key
itself.  Timing metrics (host-clock times, rates and speedups) are left
out: they measure the machine, not the port.
"""
import numpy as np
import pytest

TIMING_UNITS = ("us", "req/s", "x", "steps/s")


def is_timing(name: str, metric) -> bool:
    return name.startswith("time_") or metric.unit in TIMING_UNITS


def untimed(metrics: dict) -> dict:
    return {k: m for k, m in metrics.items() if not is_timing(k, m)}


def assert_metrics_match(got: dict, want: dict, *, custom=()) -> dict:
    """``got`` (the port's case metrics) against ``want`` (the reference's);
    the keys in ``custom`` and the warn-gated values are left to the caller.
    Returns the untimed (got, want) pairs of those keys."""
    got, want = untimed(got), untimed(want)
    assert set(got) == set(want), (set(got) ^ set(want))
    left = {}
    for key, w in want.items():
        g = got[key]
        assert (g.gate, g.direction, g.unit, g.tolerance) == (
            w.gate, w.direction, w.unit, w.tolerance), key
        assert isinstance(g.value, bool) == isinstance(w.value, bool), key
        if key in custom or w.gate != "hard":
            left[key] = (g.value, w.value)
        elif isinstance(w.value, (bool, int, np.integer)):
            assert g.value == w.value, (key, g.value, w.value)
        else:
            assert g.value == pytest.approx(w.value, rel=1e-12), key
    return left
