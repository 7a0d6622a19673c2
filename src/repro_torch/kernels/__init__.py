"""Hand-written Hopper kernels and their wrappers.

  * :mod:`.gram`, :mod:`.fused_apply_gram`, :mod:`.apply_right` (the
    CholeskyQR2 local QR), :mod:`.trailing_update` (the blocked QR's
    sweeps) and :mod:`.combine_gram` (the Gram-combine of two R factors) —
    one wrapper per CUDA kernel in ``csrc/`` (plain version for CPU
    tensors);
  * :mod:`.ops` — the batched ``use_pallas`` switch and the CQR2 pipeline;
  * :mod:`.ref` — the plain PyTorch versions;
  * :mod:`.dispatch` — launch, trace and dispatch counters; :mod:`.traffic` —
    traffic records;
  * :mod:`._build` — nvcc build and ctypes loading.

Nothing is compiled at import.
"""
