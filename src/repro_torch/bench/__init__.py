"""Fault scenarios on the port: :mod:`.scenarios`, the collective and
blocked-QR parts of :mod:`repro.bench.scenarios`."""
