"""Import helper for tests that hold the PyTorch port against the JAX package.

``repro.compat`` asks ``optimization_barrier_p in batching.primitive_batchers``
at import time.  On jax releases whose ``PrimitiveBatchersProxy`` defines no
``__contains__`` (0.9.0 among them) that raises ``TypeError``, so nothing
that imports ``repro.compat`` loads.  Importing this module first gives the
proxy the membership test it lacks, answered from the table the proxy
fronts.  On releases where membership already works it changes nothing.

The patch is process-wide: test modules collected after this one in the
same process import ``repro`` as well.
"""
from __future__ import annotations

from jax._src.interpreters import batching as _batching

_proxy = getattr(_batching, "PrimitiveBatchersProxy", None)
if _proxy is not None:
    try:
        object() in _batching.primitive_batchers
    except TypeError:
        _proxy.__contains__ = lambda self, p: p in _batching.fancy_primitive_batchers
