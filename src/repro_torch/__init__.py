"""PyTorch/CUDA port of the fault-tolerant communication-avoiding TSQR.

Mirrors the JAX package :mod:`repro` module for module and imports nothing
of it, nor of JAX:

  * :mod:`repro_torch.collective` — fault model, plans, combiners, the
    simulated-ranks backend and the plan executor;
  * :mod:`repro_torch.kernels` — the hand-written Hopper kernels of the
    CholeskyQR2 local QR (``csrc/``), their wrappers and plain versions;
  * :mod:`repro_torch.qr` — ``QRConfig`` and ``factorize`` (TSQR);
  * :mod:`repro_torch.replay` — the cached programs behind the reference's
    jitted entry points (CUDA graphs on the card);
  * :mod:`repro_torch.core` — numpy oracles.

Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""
